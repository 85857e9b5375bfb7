#!/bin/bash
# A/B of chip_smoke.py between two trees on one card, in the order
# parent, change, change, parent:
#
#     bash scripts/chip_smoke_ab.sh <parent tree> <change tree> <out dir>
#
# Each tree is a checkout (e.g. `git archive <commit> | tar -x -C <dir>`
# into a git-ignored directory); the first run of each builds its kernels
# fresh. Each run's output goes to <out dir>/ab_<i>_<tree name>.log with
# every line stamped by the host clock, and one line a run is printed: its
# exit code and wall seconds.
set -u
parent=$(realpath "$1"); change=$(realpath "$2")
out=$(realpath "$3")
mkdir -p "$out"
i=0
for t in "$parent" "$change" "$change" "$parent"; do
  i=$((i + 1))
  s=$(date +%s.%N)
  (cd "$t" && python3 -u chip_smoke.py 2>&1) | python3 -u -c "
import sys, time
for line in sys.stdin:
    print(f'{time.time():.3f} {line}', end='')" > "$out/ab_${i}_$(basename "$t").log"
  rc=${PIPESTATUS[0]}
  e=$(date +%s.%N)
  echo "run $i $(basename "$t") rc=$rc wall_s=$(python3 -c "print(round($e - $s, 2))")"
done

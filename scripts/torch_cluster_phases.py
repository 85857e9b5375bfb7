#!/usr/bin/env python3
"""Copies of tinaural_torch whose cluster-mode `assemble_partitions` stops
after one phase, for a breakdown of its time on a card.

    python3 scripts/torch_cluster_phases.py OUT_DIR
    for n in 1 2 3 4; do
      PYTHONPATH=OUT_DIR/stop$n:. python3 scripts/torch_cluster_sweep.py
    done

Copy stop<n> returns after phase n: 1 the gather, 2 rfft_L, 3 the mirror
exchange and the ramp, 4 irfft_L and h_eff (the full kernel adds the
partition FFTs). A store that never happens keeps the phase's work alive.
The stopped kernels write no output, so the sweep's checks fail on them:
read only their timings. The differences between consecutive copies are
the phases' times.
"""

from __future__ import annotations

import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _sink(arr: str) -> str:
    return ("{ float acc = 0.f; for (int i_ = 0; i_ < 16; ++i_) acc += "
            f"{arr}[i_].x + {arr}[i_].y; if (acc == 1.2345e-30f) "
            "a.H_re[r] = acc; return; }")


# (line after which the copy returns, the return)
STOPS = {
    1: ("  for (int m = 0; m < 16; ++m) v[m] = conj(v[m]);\n", _sink("v")),
    2: ("  cluster_local_fft(v, smem, tid, a.twM);\n", _sink("v")),
    3: ("  __syncthreads();  // every hi slot is read before the passes reuse "
        "smem\n", _sink("u")),
    4: ("  cluster_wait<C>();  // h_eff is whole; nothing below leaves this "
        "block\n", "{ if (smem[tid].x == 1.2345e-30f) a.H_re[r] = 1.f; "
        "return; }"),
}


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    out = pathlib.Path(sys.argv[1])
    src = (ROOT / "tinaural_torch/csrc/partitioned.cu").read_text()
    for n, (anchor, stop) in STOPS.items():
        if src.count(anchor) != 1:
            raise SystemExit(f"phase {n}: anchor not found once: {anchor!r}")
        d = out / f"stop{n}"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(ROOT / "tinaural_torch", d / "tinaural_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        (d / "tinaural_torch/csrc/partitioned.cu").write_text(
            src.replace(anchor, anchor + "  " + stop + "\n"))
        print(d)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The readings a cell's correctness limit is set from, on the card.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,… \
        --control-seeds 1,2,3 --seconds <s>

For each of ``--seeds``, one whole run of the cell (`harness/runner.run`,
its window ``--seconds`` long) and its compared numbers: the program's
readings. For each of ``--control-seeds``, the control: the reference in
the next precision below the configuration's (float32 arithmetic, every
stored stage rounded to bfloat16; `reference/fast.py` BFLOAT16) put in the
program's place, on the same inputs the run of that seed makes, held to
the float64 reference by the same numbers. One line of JSON a reading;
all in one process, so set-up is paid once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def control(cell, seed: int, device) -> dict:
    """The control's compared numbers on the inputs of ``seed``'s run."""
    from benchmark.harness import spec
    from benchmark.reference import fast

    E = spec.entry(cell.entry).Entry(cell, seed, device)
    E.free_program()
    E.kept = dict.fromkeys(range(len(E.inputs)))
    return E.numbers(dict(E.reference_outputs(fast.BFLOAT16)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import runner, spec

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    for s in [int(x) for x in args.seeds.split(",") if x]:
        t = time.time()
        out = runner.run(cell, s, args.seconds, False, dev, t,
                         log=lambda line: None)
        print(json.dumps({"cell": cell.name, "side": "program", "seed": s,
                          "correct": out["correct"],
                          "check": {k: v["value"] for k, v in out["check"].items()},
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()
                                      if k != "setup_s"},
                          "seconds": time.time() - t}), flush=True)
        torch.cuda.empty_cache()
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t = time.time()
        got = control(cell, s, dev)
        print(json.dumps({"cell": cell.name, "side": "control", "seed": s,
                          "check": got, "seconds": time.time() - t}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[2])
    sys.exit(main())

"""Run one cell of the benchmark of `tinaural_torch` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is a ``workloads`` entry of
`BENCHMARK.json`; its files are found by name under ``benchmark/`` (see
`harness/spec.py`). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``check``, each compared number
beside its limit; the last lines of standard error repeat the check.
Earlier lines give the card, the set-up's parts and the route (launches a
call against the cell's expected ones). Without a CUDA device, or with fewer than the cell asks
for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import runner

    return runner.main(args)


def load_all() -> None:
    """Import every module a run can load: the harness, each entry point
    and metric reader that BENCHMARK.json reaches, and the program."""
    import importlib

    import tinaural_torch  # noqa: F401
    from benchmark.harness import (device, inputs, loops, offline, profile,
                                   runner, spec, system, work)  # noqa: F401
    from benchmark.reference import fast  # noqa: F401

    bench = spec.benchmark()
    for w in bench["workloads"]:
        spec.entry(spec.cell(w["name"], bench).entry)
    for m in bench["end_to_end"] + bench["per_layer"]:
        spec.reader(m["name"])
    importlib.import_module("tinaural_torch.ops._build")


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())

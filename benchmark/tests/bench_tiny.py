"""Cells of BENCHMARK.json cut to sizes a CPU test holds: the same files,
entry points, loop and checks, with fewer samples and sources."""

import dataclasses

import torch

from benchmark.harness import spec

TINY = {
    "kemar128.trajectory": ({"samples": 1 << 14}, {}),
    "kemar128.scene": ({"samples": 1 << 13, "sources": 4}, {}),
}
CPU = torch.device("cpu")


def tiny(name: str) -> spec.Cell:
    c = spec.cell(name)
    traffic, config = TINY[name]
    return dataclasses.replace(c, traffic={**c.traffic, **traffic},
                               config={**c.config, **config})


def run(name: str, seed: int = 2**31 + 7, seconds: float = 0.3) -> dict:
    from benchmark.harness import runner

    return runner.run(tiny(name), seed, seconds, False, CPU, 0.0,
                      log=lambda line: None)

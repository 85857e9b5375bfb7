"""Offline renders through `BinauralRenderer`'s public entry points, in a
closed loop.

The mix names the entry point, the sources a call (``sources``), the
samples a source (``samples``), how many distinct inputs set-up makes
(``inputs``; call i takes input i mod inputs) and the path family
(``path``). Every call takes host numpy arrays, as a user's does, and ends
in `torch.cuda.synchronize()`; its output stays on the card, as the API
returns it.

Correctness: for each input, the output of one call drawn from the seed
among its first four (or its last, in a shorter window) is kept on the
card. After the window and after the program's state is freed, the
reference renders each kept call's input in float64 and the run compares
them (`harness/compare.py`), blocks of ``block_size`` samples.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from ..reference import fast
from . import compare, inputs, system


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Offline:
    method = ""     # the BinauralRenderer method
    squeeze = False  # one source, passed as (N,) and (nb, 2)

    def __init__(self, cell, seed: int, device):
        self.cell, self.device = cell, device
        cfg, p = cell.config, cell.traffic
        self.timings = {}
        t = time.perf_counter()
        self.h = system.raw_hrirs(cfg, seed)
        table = system.program_table(cfg, self.h, device)
        import tinaural_torch as tt

        self.renderer = tt.BinauralRenderer(table,
                                            system.program_config(cfg))
        self.timings["table_s"] = time.perf_counter() - t
        t = time.perf_counter()
        S, N = p["sources"], p["samples"]
        B = cfg["render"]["block_size"]
        nb = -(-N // B)
        self.inputs = []
        for k in range(p["inputs"]):
            xs = inputs.signals(seed, k, (S, N), p["rms"])
            dirs = inputs.sweeps(seed, k, S, nb, p["path"])
            self.inputs.append((xs, dirs))
        self.audio_s = S * N / cfg["sample_rate"]
        g = inputs.rng(seed, "sample")
        n_in = len(self.inputs)
        self.planned = [k + n_in * int(g.integers(0, 4)) for k in range(n_in)]
        self.shapes = self._shapes(S, N, B, nb)
        self.kept = {}
        self.timings["inputs_s"] = time.perf_counter() - t

    def _shapes(self, S, N, B, nb) -> dict:
        cfg = self.cell.config
        taps = cfg["taps"]
        k = cfg["render"]["dir_rate"]
        n_fft = fast.next_pow2(B + taps + 64 - 1)
        used = []
        grid_tab = GridOnly(cfg)
        for _, dirs in self.inputs:
            d = torch.from_numpy(np.ascontiguousarray(dirs[:, ::k])).reshape(-1, 2)
            rows, _ = fast.weights(grid_tab, d)
            used.append(int(torch.unique(rows).numel()))
        return dict(S=S, N=N, B=B, nb=nb, n_fft=n_fft, taps=taps,
                    rows=S * (-(-nb // k)), crossfade=cfg["render"]["crossfade"],
                    table_rows=float(np.mean(used)))

    def _args(self, k: int):
        xs, dirs = self.inputs[k]
        return (xs[0], dirs[0]) if self.squeeze else (xs, dirs)

    def warm_up(self) -> None:
        t = time.perf_counter()
        for _ in range(2):
            getattr(self.renderer, self.method)(*self._args(0))
        sync(self.device)
        self.timings["warm_up_s"] = time.perf_counter() - t

    def start(self, seconds: float) -> None:
        self.kept = {}

    def work(self, i: int) -> float:
        return self.audio_s

    def issue(self, i: int):
        with record_function(self.method):
            return getattr(self.renderer, self.method)(
                *self._args(i % len(self.inputs)))

    def finish(self, i: int, y) -> None:
        with record_function("bench.sync"):
            sync(self.device)
        k = i % len(self.inputs)
        if k not in self.kept or self.kept[k][0] < self.planned[k]:
            self.kept[k] = (i, y)

    def profile_call(self, i: int) -> None:
        y = self.issue(i)
        with record_function("bench.sync"):
            sync(self.device)
        del y

    def free_program(self) -> None:
        self.renderer = None

    def reference_outputs(self, prec=fast.FLOAT64):
        """(input k, the reference's output of input k in ``prec``) for each
        input a call of the window was kept for."""
        cfg = self.cell.config
        tab = fast.device_table(system.reference_table(cfg, self.h),
                                self.device, prec)
        rcfg = system.reference_config(cfg)
        for k in sorted(self.kept):
            xs, dirs = self.inputs[k]
            yield k, fast.render(tab, xs, dirs, rcfg)

    def numbers(self, outputs) -> dict:
        """The compared numbers of ``outputs`` ({input k: output}), each
        at its worst over the inputs."""
        B = self.cell.config["render"]["block_size"]
        return compare.worst(compare.compare(outputs[k], ref, B)
                             for k, ref in self.reference_outputs())

    def check(self, calls: int) -> dict:
        return self.numbers({k: y for k, (_, y) in self.kept.items()})


class GridOnly:
    """The grid fields `fast.weights` reads, for counting the table rows a
    call's directions use."""

    def __init__(self, cfg: dict):
        self.elevs = torch.tensor(cfg["grid"]["elevs"], dtype=torch.float64)
        self.counts = torch.tensor(cfg["grid"]["az_counts"], dtype=torch.int64)
        self.a_max = int(max(cfg["grid"]["az_counts"]))

"""`BinauralRenderer.render_streamed`: one head-tracked source, host numpy
(N,) and (nb, 2) in, the stereo stream (2, N) on the card out (closed
loop, `harness/offline.py`), blocks of ``stream_block``.

The table is a room's: the head model's responses plus the seeded diffuse
tail of `reference/room.py`, kept whole (no ITD/ILD decomposition: the
program's `build_table` and the reference's `room.raw_table`). The
reference renders each kept call's input through `reference/streamed.py`,
the streamed map in float64."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import inputs, system, work_partitioned
from benchmark.harness.offline import GridOnly, Offline
from benchmark.reference import fast, room, streamed


def room_hrirs(config: dict, seed: int) -> np.ndarray:
    """The raw head model's responses with the room's tail, (E, A_max,
    2, taps) float64."""
    h = system.raw_hrirs(config, seed)
    valid = system.grid(config).validity_mask().astype(np.float64)
    return room.with_tail(h, valid, config, seed)


def program_table(config: dict, h: np.ndarray, device):
    """The program's table of h kept whole (its `build_table` with no
    decomposition), on ``device``."""
    from tinaural_torch.data.grids import SphericalGrid as ProgramGrid
    from tinaural_torch.data.table import TorchTable, build_table

    g = config["grid"]
    pg = ProgramGrid(elevs=np.asarray(g["elevs"], dtype=np.float64),
                     az_counts=np.asarray(g["az_counts"], dtype=np.int64))
    arrays = build_table(h, pg, config["sample_rate"], decompose=False)
    return TorchTable.from_hrir_table(arrays, device)


def chunks(s: dict, dir_rate: int) -> int:
    """The program's chunks a call at the shapes s
    (`partitioned_conv.render_chunks` at its ``CHUNK_BYTES``)."""
    from tinaural_torch.ops import partitioned_conv as pc

    per = max(1, pc.CHUNK_BYTES // (s["P"] * 2 * s["F2"] * 8)) * dir_rate
    return len(pc.render_chunks(s["nb"], dir_rate, per))


class Entry(Offline):
    method = "render_streamed"
    squeeze = True

    def __init__(self, cell, seed: int, device):
        self.cell, self.device = cell, device
        cfg, p = cell.config, cell.traffic
        self.timings = {}
        t = time.perf_counter()
        self.h = room_hrirs(cfg, seed)
        import tinaural_torch as tt

        self.renderer = tt.BinauralRenderer(program_table(cfg, self.h, device),
                                            system.program_config(cfg))
        self.timings["table_s"] = time.perf_counter() - t
        t = time.perf_counter()
        S, N = p["sources"], p["samples"]
        B = cfg["render"]["stream_block"]
        if S != 1 or N % B or B != cfg["render"]["block_size"]:
            raise ValueError("render_streamed takes one source of whole "
                             "blocks of stream_block = block_size")
        nb = N // B
        self.inputs = [(inputs.signals(seed, k, (S, N), p["rms"]),
                        inputs.sweeps(seed, k, S, nb, p["path"]))
                       for k in range(p["inputs"])]
        self.audio_s = S * N / cfg["sample_rate"]
        g = inputs.rng(seed, "sample")
        n_in = len(self.inputs)
        self.planned = [k + n_in * int(g.integers(0, 4)) for k in range(n_in)]
        self.shapes = self._shapes(S, N, B, nb)
        self.kept = {}
        self.timings["inputs_s"] = time.perf_counter() - t

    def _shapes(self, S, N, B, nb) -> dict:
        cfg = self.cell.config
        r = cfg["render"]
        k = r["dir_rate"]
        grid_tab = GridOnly(cfg)
        used = []
        for _, dirs in self.inputs:
            d = torch.from_numpy(np.ascontiguousarray(dirs[0, ::k]))
            rows, _ = fast.weights(grid_tab, d)
            used.append(int(torch.unique(rows).numel()))
        s = work_partitioned.shapes(cfg["taps"], B, nb, k, r["crossfade"],
                                    float(np.mean(used)))
        s["chunks"] = chunks(s, k)
        return s

    def reference_outputs(self, prec=fast.FLOAT64):
        cfg = self.cell.config
        tab = fast.device_table(room.raw_table(self.h, system.grid(cfg),
                                               cfg["sample_rate"]),
                                self.device, prec)
        rcfg = system.reference_config(cfg)
        for k in sorted(self.kept):
            xs, dirs = self.inputs[k]
            yield k, streamed.render(tab, xs[0], dirs[0], rcfg)

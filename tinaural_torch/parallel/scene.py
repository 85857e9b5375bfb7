"""Source-sharded scene rendering.

Each rank renders its slice of the sources with the single-device scene
core (`models.renderer._scene_core`, or `_scene_static_core` for static
directions). The cores pick their route from the shapes they are called
with, here the per-shard ones, as the JAX package's shard bodies do. The
stereo mixdown, after the core's inverse FFT and overlap-add, is then one
SUM all-reduce over the ``src`` group: 2·out samples, never spectra.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG, RenderConfig
from ..data.table import DELAY_PAD, TorchTable
from ..models.renderer import (_dedupe_sources, _scene_core,
                               _scene_static_core)
from .mesh import axis, check_table


def _shard(a: np.ndarray, rank: int, n: int,
           width: int | None = None) -> np.ndarray:
    """Rank's ⌈S/n⌉ rows of a's leading axis, zero rows past S (a padded
    source is silent and mixes to nothing) and, with ``width``, the last
    axis zero-padded to it: one copy of the rank's part only."""
    per = -(-a.shape[0] // n)
    part = a[rank * per:(rank + 1) * per]
    out = np.zeros((per, *a.shape[1:-1], width or a.shape[-1]), a.dtype)
    out[:part.shape[0], ..., :a.shape[-1]] = part
    return out


def render_scene_sharded(table: TorchTable, xs, dirs, mesh,
                         config: RenderConfig = DEFAULT_CONFIG,
                         dedupe: bool = True) -> torch.Tensor:
    """Scene render sharded over the mesh's ``src`` axis → (2, out_len)
    on every rank, on the table's device.

    Every rank passes the whole scene: xs (S, N); dirs (S, 2) static or
    (S, n_blocks, 2) trajectories. ``dedupe`` pre-mixes sources with
    identical snapped direction tracks, as `BinauralRenderer.render_scene`
    does, before the shards are cut. S is zero-padded up to a multiple of
    the ``src`` size. Ranks along ``blk`` render the same slice."""
    check_table(table, mesh)
    B = config.block_size
    xs = np.asarray(xs, dtype=np.float32)
    if xs.ndim != 2:
        raise ValueError(f"xs must be (S, N), got {xs.shape}")
    S, N = xs.shape
    nb = -(-N // B)
    dirs = np.asarray(dirs, dtype=np.float32)
    static = dirs.ndim == 2
    want = (S, 2) if static else (S, nb, 2)
    if dirs.shape != want:
        raise ValueError(f"dirs must be {want}, got {dirs.shape}")
    if dedupe:
        xs, dirs = _dedupe_sources(xs, dirs, config)

    rank, n_src = axis(mesh, "src")
    dev = table.device
    xbs = torch.from_numpy(
        _shard(xs, rank, n_src, nb * B).reshape(-1, nb, B)).to(dev)
    dirs_t = torch.from_numpy(_shard(dirs, rank, n_src)).to(dev)
    core = _scene_static_core if static else _scene_core
    y = core(table, xbs, dirs_t, config).contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.get_group("src"))
    out = N + table.taps + DELAY_PAD - 1 if config.out_length == "full" else N
    return y[:, :out]

"""A dry run of the whole parallel layer on ``world_size`` ranks.

    python -c "from tinaural_torch.parallel.dryrun import dryrun_multichip;
               print(dryrun_multichip(4, 'cpu'))"

Runs every sharding once at a small size on a (world/2, 2) (src, blk) mesh
where the world size is even (else (world, 1)): a source-sharded scene
(the all-reduce mixdown), a block-sharded long signal (the overlap-add
halo), one source-sharded fit step (the gradient through the
collectives), and sharded streams, one push and two bursts, the second at
update rate 2. Each result must be finite. On ``"cuda"`` rank r runs on
cuda:r, so the world size is at most the card count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from ..data import TorchTable, load_hrir_set
from ..models.fit import FitParams, init_params
from .fit import fit_step_sharded
from .launch import spawn
from .mesh import axis, make_mesh, rank_device
from .scene import render_scene_sharded
from .sequence import render_long_sharded
from .streams import ShardedBatchedStream


def dryrun_multichip(world_size: int, device_type: str = "cuda") -> dict:
    """Spawn ``world_size`` ranks and run the dry run → rank 0's shapes
    and fit loss. Raises if a rank fails or a result is not finite."""
    return spawn(_dryrun_rank, world_size, device_type, device_type)


def _finite(y: torch.Tensor, what: str) -> tuple:
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"dry run: {what} is not finite")
    return tuple(y.shape)


def _dryrun_rank(device_type: str) -> dict:
    n = torch.distributed.get_world_size()
    n_blk = 2 if n % 2 == 0 else 1
    mesh = make_mesh((n // n_blk, n_blk), device_type)
    dev = rank_device(mesh)
    config = RenderConfig(block_size=128)
    table = TorchTable.from_hrir_table(load_hrir_set("synthetic", taps=64),
                                       dev)
    rng = np.random.default_rng(0)
    out = {}

    # 1. source-sharded scene (all-reduce mixdown)
    S, N = 2 * n, 3 * 128
    xs = rng.standard_normal((S, N)).astype(np.float32)
    sdirs = np.stack([rng.uniform(0, 360, S), rng.uniform(-40, 90, S)],
                     axis=1).astype(np.float32)
    y = render_scene_sharded(table, xs, sdirs, mesh, config)
    out["scene"] = _finite(y, "the scene")

    # 2. block-sharded long signal (overlap-add halo)
    nb = 4 * n
    x = rng.standard_normal(nb * 128).astype(np.float32)
    dirs = np.stack([np.linspace(0, 350, nb), np.linspace(-40, 90, nb)],
                    axis=1)
    out["long"] = _finite(render_long_sharded(table, x, dirs, mesh, config),
                          "the long render")

    # 3. one source-sharded fit step, the gradient through the collectives
    nb_s = -(-N // 128)
    xbs = torch.from_numpy(np.pad(xs, [(0, 0), (0, nb_s * 128 - N)])
                           .reshape(S, nb_s, 128)).to(dev)
    dirs_b = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        sdirs[:, None, :], (S, nb_s, 2)))).to(dev)
    params = FitParams(*(p.requires_grad_() for p in init_params(device=dev)))
    opt = torch.optim.Adam(params, lr=1e-2)
    loss = fit_step_sharded(params, opt, table, xbs, dirs_b, y, config, mesh)
    _finite(loss, "the fit loss")
    out["fit_loss"] = float(loss)

    # 4. sharded streams: one push, a burst, a burst at update rate 2
    S_l = 2 * axis(mesh, "src")[1]
    B = config.stream_block
    azl = np.linspace(0, 340, S_l).astype(np.float32)
    zero = np.zeros(S_l, np.float32)
    svc = ShardedBatchedStream(table, S_l, mesh, config)
    out["push"] = _finite(svc.push(rng.standard_normal((S_l, B)), azl, zero),
                          "a sharded push")
    out["push_many"] = _finite(svc.push_many(
        rng.standard_normal((2, S_l, B)), azl, zero), "a sharded burst")
    svc_k = ShardedBatchedStream(table, S_l, mesh,
                                 config.replace(stream_update_rate=2))
    out["push_many_rate_2"] = _finite(svc_k.push_many(
        rng.standard_normal((4, S_l, B)), azl, zero),
        "a sharded burst at update rate 2")
    return out

"""Rank bodies of tests/test_torch_parallel.py.

`run(cases)` runs on every rank of a gloo group (started by
`tinaural_torch.parallel.launch.spawn`, or the test process's own group of
one) and returns, on rank 0, what each case gives on the whole mesh. It
imports no jax: each rank starts from a fresh interpreter, and jax would
add seconds to each start. Cases are plain dicts of numpy arrays, run in
their order on every rank (meshes and collectives must match across ranks).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import tinaural_torch as tt
from tinaural_torch.models.fit import FitParams
from tinaural_torch.parallel import (ShardedBatchedStream, fit_step_sharded,
                                     make_mesh, render_long_sharded,
                                     render_scene_sharded, scene_loss_sharded)


def _gather(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _everywhere(y: torch.Tensor) -> tuple[np.ndarray, bool]:
    """Rank 0's array, and whether every rank holds the same bits."""
    ys = _gather(y.numpy())
    return ys[0], all(np.array_equal(ys[0], v) for v in ys)


def _rows(svc, y: torch.Tensor, axis: int = 0) -> np.ndarray:
    """Every listener's rows of a sharded stream's output, in order (ranks
    along blk hold the same rows; the first of each is kept)."""
    parts = dict(reversed(_gather((svc.rows.start, y.numpy()))))
    return np.concatenate([parts[k] for k in sorted(parts)], axis=axis)


def _state(svc) -> dict:
    st = svc.state.to_numpy()
    return {f: _rows(svc, torch.from_numpy(getattr(st, f)))
            for f in st._fields}


def _scene(table, mesh, c):
    y = render_scene_sharded(table, c["xs"], c["dirs"], mesh,
                             tt.RenderConfig(**c["cfg"]))
    y, same = _everywhere(y)
    return {"y": y, "same_everywhere": same}


def _long(table, mesh, c):
    y = render_long_sharded(table, c["x"], c["dirs"], mesh,
                            tt.RenderConfig(**c["cfg"]))
    y, same = _everywhere(y)
    return {"y": y, "same_everywhere": same}


def _streams(table, mesh, c):
    """Pushes one at a time, a checkpoint and resume, the same pushes as
    one burst, the JAX package's state carried in, and a burst at the
    case's update rate."""
    cfg = tt.RenderConfig(**c["cfg"])
    S = c["blocks"].shape[1]
    new = lambda: ShardedBatchedStream(table, S, mesh, cfg)
    res = {}
    if "pushes" in c:
        blocks, azs, els = c["blocks"], c["azs"], c["els"]
        svc = new()
        ys = [svc.push(blocks[k], azs[k], els[k]) for k in range(c["pushes"])]
        res["push"] = _rows(svc, torch.stack(ys), axis=1)
        res["state"] = _state(svc)
        saved = svc.state
        k = c["pushes"]
        a = svc.push(blocks[k], azs[k], els[k])
        svc.state = saved
        b = svc.push(blocks[k], azs[k], els[k])
        res["resume_equal"] = all(_gather(bool(torch.equal(a, b))))
        many = new()
        ym = many.push_many(blocks[:k], azs[:k], els[:k])
        res["many_equal"] = all(_gather(bool(torch.equal(ym,
                                                         torch.stack(ys)))))
        carried = new()
        carried.state = tt.StreamState(**c["jax_state"])  # numpy fields
        res["carried"] = _rows(carried, carried.push(blocks[k], azs[k],
                                                     els[k]))
    if "burst" in c:
        svc = new()
        res["burst"] = _rows(svc, svc.push_many(c["blocks"], c["azs"],
                                                c["els"]), axis=1)
    try:
        new_bad = ShardedBatchedStream(table, S + 1, mesh, cfg)
    except ValueError:
        new_bad = None
    res["refuses_indivisible"] = new_bad is None
    return res


def _fit(table, mesh, c):
    """The loss and its gradient, then ``steps`` Adam steps: their losses,
    and whether every rank holds the same parameters after them."""
    cfg = tt.RenderConfig(**c["cfg"])
    xbs, dirs, target = (torch.from_numpy(c[k])
                         for k in ("xbs", "dirs", "target"))
    leaves = lambda: FitParams(*(torch.tensor(c["params"][f]).requires_grad_()
                                 for f in FitParams._fields))
    params = leaves()
    loss = scene_loss_sharded(params, table, xbs, dirs, target, cfg, mesh)
    loss.backward()
    grads = [p.grad.numpy() for p in params]
    same_grads = all(all(np.array_equal(a, b) for a, b in zip(grads, g))
                     for g in _gather(grads))
    params = leaves()
    opt = torch.optim.Adam(params, lr=c["lr"])
    losses = [float(fit_step_sharded(params, opt, table, xbs, dirs, target,
                                     cfg, mesh)) for _ in range(c["steps"])]
    after = [p.detach().numpy() for p in params]
    same_params = all(all(np.array_equal(a, b) for a, b in zip(after, g))
                      for g in _gather(after))
    return {"loss": loss.item(), "grads": grads, "same_grads": same_grads,
            "losses": losses, "same_params": same_params}


def _mesh_errors(table, mesh, c):
    """make_mesh refuses a shape off the world size, and a CUDA mesh
    without a card."""
    n = dist.get_world_size()
    out = {}
    for key, args, exc in (("bad_shape", ((n, 2), "cpu"), ValueError),
                           ("cuda_without_card", (None, "cuda"),
                            RuntimeError)):
        try:
            make_mesh(*args)
        except exc as e:
            out[key] = str(e)
    return out


KINDS = {"scene": _scene, "long": _long, "streams": _streams, "fit": _fit,
         "mesh_errors": _mesh_errors}


def run(cases: dict) -> dict:
    torch.set_num_threads(1)
    table = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"),
                                          "cpu")
    meshes = {}
    out = {}
    for name, c in cases.items():
        shape = tuple(c["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, "cpu")
        out[name] = KINDS[c["kind"]](table, meshes[shape], c)
    return out

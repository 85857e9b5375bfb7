"""Source-sharded personalization: data-parallel fitting.

The scene forward runs source-sharded, as `scene.render_scene_sharded`
does; the loss is taken on the all-reduced mixdown, which every rank
holds whole; the gradients flow back through the collective. The forward
renders through the plain route under autograd, as `models.fit.scene_loss`
does (the kernels have no backward pass).

Two autograd functions keep the gradient the true one on every rank:
`_ReduceMix` all-reduces the mixdown forward and passes the cotangent
through unchanged backward; `_ReplicateParams` passes the parameters
through forward and all-reduces their gradient backward, so that each
rank's partial gradient (from its own sources) sums to the whole. The
autograd collective `torch.distributed.nn.functional.all_reduce` would
not do: its backward all-reduces the cotangent too, which every rank
already holds whole, and the parameter gradients then come out scaled by
the ``src`` size (2 ranks over gloo: 6.0 where the gradient is 3.0).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..data.table import TorchTable
from ..models.fit import FitParams, personalize_table
from ..models.renderer import _scene_core
from ..ops.block_render import block_render_reference
from .mesh import axis, check_table


class _ReduceMix(torch.autograd.Function):
    """SUM all-reduce over ``group`` forward; identity backward."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicateParams(torch.autograd.Function):
    """Identity forward; SUM all-reduce of the gradient over ``group``
    backward."""

    @staticmethod
    def forward(ctx, flat, group):
        ctx.group = group
        return flat.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def _replicated(params: FitParams, group) -> FitParams:
    """The parameters through one `_ReplicateParams` (one collective a
    backward pass), split back into their leaves."""
    flat = _ReplicateParams.apply(
        torch.cat([p.reshape(-1) for p in params]), group)
    leaves, at = [], 0
    for p in params:
        leaves.append(flat[at:at + p.numel()].view_as(p))
        at += p.numel()
    return FitParams(*leaves)


def scene_loss_sharded(params: FitParams, table: TorchTable,
                       xbs: torch.Tensor, dirs: torch.Tensor,
                       target: torch.Tensor, config: RenderConfig,
                       mesh) -> torch.Tensor:
    """Mean-squared error of the personalized scene render against the
    target, the sources sharded over the mesh's ``src`` axis → the same
    scalar on every rank; its backward gives every rank the whole
    gradient. Every rank passes the whole scene: xbs (S, nb, B); dirs
    (S, nb, 2); target (2, M), tensors on the table's device. S is
    zero-padded up to a multiple of the ``src`` size: a silent source
    renders zero for any parameters, so it adds no loss and no gradient."""
    check_table(table, mesh)
    rank, n_src = axis(mesh, "src")
    group = mesh.get_group("src")
    per = -(-xbs.shape[0] // n_src)
    pad = per * n_src - xbs.shape[0]
    if pad:
        xbs = torch.cat([xbs, xbs.new_zeros((pad, *xbs.shape[1:]))])
        dirs = torch.cat([dirs, dirs[-1:].expand(pad, *dirs.shape[1:])])
    lo = rank * per
    ptable = personalize_table(table, _replicated(params, group))
    y = _scene_core(ptable, xbs[lo:lo + per], dirs[lo:lo + per], config,
                    render=block_render_reference)
    y = _ReduceMix.apply(y, group)
    n = min(y.shape[-1], target.shape[-1])
    return torch.mean((y[:, :n] - target[:, :n]) ** 2)


def fit_step_sharded(params: FitParams, optimizer: torch.optim.Optimizer,
                     table: TorchTable, xbs, dirs, target,
                     config: RenderConfig, mesh) -> torch.Tensor:
    """One data-parallel optimizer step on the parameters, in place → the
    loss before the step (a detached scalar on the table's device). Every
    rank takes the same step from the same gradient, so the parameters
    stay equal on every rank."""
    optimizer.zero_grad(set_to_none=True)
    loss = scene_loss_sharded(params, table, xbs, dirs, target, config,
                              mesh)
    loss.backward()
    optimizer.step()
    return loss.detach()


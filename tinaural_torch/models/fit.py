"""Differentiable HRTF personalization: a port of `tinaural.models.fit`.

Gradient-based fitting of listener-specific HRTF parameters from an
observed binaural recording:

  parameters θ = { per-ear log-EQ control points, ITD scale, ILD scale,
                   global log-gain }
  table(θ)    = `personalize_table` — a differentiable transform of the
                table (EQ filters the aligned shapes, the ITD scale
                stretches interaural delays about their per-direction
                mean, the ILD scale exponentiates gain ratios)
  loss(θ)     = mean ‖render_scene(table(θ), xs, dirs) − target‖²
  train_step  = one Adam step (`torch.optim.Adam`, whose defaults are
                `optax.adam`'s)

The loss renders through the plain torch versions on either device, as the
JAX package renders its loss through the jnp path: the hand-written
kernels, like the Pallas ones, have no backward pass (see `scene_loss`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..data.table import TorchTable
from ..ops.block_render import block_render_reference
from .renderer import _scene_core


class FitParams(NamedTuple):
    """Listener-personalization parameters (all differentiable), float32.

    ear_eq_log: (2, n_bands) log-magnitude EQ control points per ear,
        linearly interpolated across rfft bins (anchors log-spaced).
    itd_scale_log: () log of the ITD stretch factor (0 → identity).
    ild_scale_log: () log of the ILD exponent (0 → identity).
    gain_log: () global log gain.
    """

    ear_eq_log: torch.Tensor
    itd_scale_log: torch.Tensor
    ild_scale_log: torch.Tensor
    gain_log: torch.Tensor

    @classmethod
    def from_numpy(cls, fields: Any, device) -> "FitParams":
        """Carry any parameters with these four attributes across (the JAX
        package's `FitParams`, or one from `to_numpy`), reading each
        through `np.asarray` into a float32 leaf tensor on ``device``."""
        return cls(*(torch.tensor(np.asarray(getattr(fields, f)),
                                  dtype=torch.float32, device=device)
                     for f in cls._fields))

    def to_numpy(self) -> "FitParams":
        """The parameters as float32 numpy arrays, field by field."""
        return FitParams(*(t.detach().to("cpu", torch.float32).numpy()
                           for t in self))


def init_params(n_bands: int = 8, device="cuda:0") -> FitParams:
    """Identity parameters (every leaf zero) on ``device``: the card by
    default, the CPU only where the caller passes it. Raises without a
    card for a CUDA device."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"init_params: no CUDA card for {device!r}; pass "
                           "device='cpu' for the CPU")
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return FitParams(ear_eq_log=z(2, n_bands), itd_scale_log=z(),
                     ild_scale_log=z(), gain_log=z())


def _interp_weights(n_bins: int, n_bands: int, device):
    """`jnp.interp`'s segment map of the bins 0…n_bins−1 against
    log-spaced anchors from bin 1 to the last bin: for each bin, the
    control points it reads (lo, hi) and its weight t on hi, with bins
    beyond either end flat at that end's control point."""
    bins = torch.arange(n_bins, dtype=torch.float32, device=device)
    # log(1) = 0 to log(n_bins − 1), the end taken in float32 as jnp's is
    anchors = torch.exp(torch.linspace(
        0.0, float(np.log(np.float32(n_bins - 1))), n_bands,
        dtype=torch.float32, device=device))
    i = torch.clamp(torch.searchsorted(anchors, bins, right=True), 1,
                    n_bands - 1)
    dx = anchors[i] - anchors[i - 1]
    t = (bins - anchors[i - 1]) / dx
    lo, hi = i - 1, i
    # flat beyond the end points
    below, above = bins < anchors[0], bins > anchors[-1]
    zero = torch.zeros_like(t)
    lo = torch.where(below, 0, torch.where(above, n_bands - 1, lo))
    t = torch.where(below | above, zero, t)
    return lo, hi, t


def _eq_curve(ear_eq_log: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(2, n_bands) control points → (2, n_bins) linear-magnitude curve.

    Control points sit at log-spaced bin positions; interpolation is
    linear in log-magnitude over the bin index, flat beyond the end
    points, and differentiable in the control points."""
    lo, hi, t = _interp_weights(n_bins, ear_eq_log.shape[-1],
                                ear_eq_log.device)
    f_lo = ear_eq_log[:, lo]
    logmag = f_lo + t * (ear_eq_log[:, hi] - f_lo)
    return torch.exp(logmag)


def personalize_table(table: TorchTable, params: FitParams) -> TorchTable:
    """Apply θ to the table: a new `TorchTable` whose h, delays and gains
    are differentiable functions of θ."""
    T = table.h.shape[-1]
    eq = _eq_curve(params.ear_eq_log, T // 2 + 1)  # (2, F)
    H = torch.fft.rfft(table.h, dim=-1)  # (E, A, 2, F)
    h = torch.fft.irfft(H * eq, n=T, dim=-1).to(table.h.dtype)

    itd_scale = torch.exp(params.itd_scale_log)
    d_mean = torch.mean(table.delays, dim=-1, keepdim=True)
    delays = d_mean + (table.delays - d_mean) * itd_scale

    ild_scale = torch.exp(params.ild_scale_log)
    g_log = torch.log(torch.clamp(table.gains, min=1e-12))
    g_mean = torch.mean(g_log, dim=-1, keepdim=True)
    gains = torch.exp(g_mean + (g_log - g_mean) * ild_scale + params.gain_log)

    return dataclasses.replace(table, h=h, delays=delays,
                               gains=gains.to(table.gains.dtype))


def scene_loss(params: FitParams, table: TorchTable, xbs: torch.Tensor,
               dirs: torch.Tensor, target: torch.Tensor,
               config: RenderConfig) -> torch.Tensor:
    """Mean-squared error of the personalized scene render against the
    target. xbs (S, nb, B); dirs (S, nb, 2); target (2, M)."""
    # The loss is differentiated, so it renders through the plain version
    # on either device, CUDA tensors included: the kernels have no
    # backward pass, as `tinaural.models.fit.scene_loss` renders through
    # the jnp path (use_pallas=False) because pallas_call has no AD rule.
    # The kernels are held against this plain version, so the optimum is
    # the same.
    y = _scene_core(personalize_table(table, params), xbs, dirs, config,
                    render=block_render_reference)
    n = min(y.shape[-1], target.shape[-1])
    return torch.mean((y[:, :n] - target[:, :n]) ** 2)


def train_step(params: FitParams, optimizer: torch.optim.Optimizer,
               table: TorchTable, xbs, dirs, target,
               config: RenderConfig) -> torch.Tensor:
    """One optimizer step on θ, in place → the loss before the step (a
    detached scalar tensor on the table's device)."""
    optimizer.zero_grad(set_to_none=True)
    loss = scene_loss(params, table, xbs, dirs, target, config)
    loss.backward()
    optimizer.step()
    return loss.detach()


def fit_hrtf(table: TorchTable, xs, dirs, target, steps: int = 200,
             lr: float = 3e-2, config: RenderConfig = DEFAULT_CONFIG,
             n_bands: int = 8) -> tuple[FitParams, list[float]]:
    """Fit personalization parameters to an observed binaural recording,
    on the table's device.

    xs: (S, N) known source signals; dirs: (S, 2) or (S, nb, 2) known
    directions; target: (2, M) the observed stereo. Returns
    (params, losses).
    """
    dev = table.device
    B = config.block_size
    xs = np.asarray(xs, dtype=np.float32)
    S, N = xs.shape
    nb = -(-N // B)
    xbs = torch.from_numpy(
        np.pad(xs, [(0, 0), (0, nb * B - N)]).reshape(S, nb, B)).to(dev)
    dirs = np.asarray(dirs, dtype=np.float32)
    if dirs.ndim == 2:
        dirs = np.broadcast_to(dirs[:, None, :], (S, nb, 2))
    dirs = torch.from_numpy(np.ascontiguousarray(dirs)).to(dev)
    target = torch.tensor(np.asarray(target, dtype=np.float32), device=dev)

    params = FitParams(*(p.requires_grad_() for p in init_params(n_bands, dev)))
    optimizer = torch.optim.Adam(params, lr=lr)
    # the losses stay on the device until the end: reading each would wait
    # for its step
    losses = [train_step(params, optimizer, table, xbs, dirs, target, config)
              for _ in range(steps)]
    return params, torch.stack(losses).tolist() if losses else []

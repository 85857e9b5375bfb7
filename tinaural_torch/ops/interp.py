"""Direction → grid lookup, batched over a leading direction axis.

Numerics follow `golden.grid_weights` (and `tinaural.ops.interp`'s rows):
bracket the elevation rings, interpolate inside each ring at that ring's own
azimuth spacing with 0/360 wraparound, lerp across rings. A pole ring
(``az_counts == 1``) returns its one slot twice. The slot position is taken
in float64, as the golden map's; `tinaural.ops.interp` takes it in float32.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..data.table import ALIGN_GUARD, TorchTable


def direction_weights(elevs: torch.Tensor, az_counts: torch.Tensor,
                      az: torch.Tensor, el: torch.Tensor, mode: str):
    """4 dense (elev_row, az_slot) indices + weights per direction.

    elevs: (E,) f32; az_counts: (E,) int; az, el: (N,) degrees.
    → (eidx (N, 4) int64, aidx (N, 4) int64, w (N, 4) in az's dtype),
    weights sum to 1. ``mode`` is "nearest" or "bilinear".
    """
    dt = az.dtype
    el = torch.clamp(el, elevs[0], elevs[-1])
    # The slot position az·c/360 in float64, as the golden map has it: in
    # float32 the product (to 129,600 on a ring of 360) rounds to 1/128,
    # up to 1.1e-5 of a slot in the weights.
    az = torch.remainder(az.to(torch.float64), 360.0)
    counts = az_counts.long()
    E = elevs.shape[0]

    if E == 1:  # single-ring grid: no elevation interpolation
        e0 = e1 = torch.zeros_like(az, dtype=torch.long)
        we = torch.zeros_like(az, dtype=dt)
    else:
        e1 = torch.clamp(torch.searchsorted(elevs, el, right=True), 1, E - 1)
        e0 = e1 - 1
        we = (el - elevs[e0]) / (elevs[e1] - elevs[e0])

    def ring_floor(e):
        c = counts[e]
        pos = az * c / 360.0
        a0 = torch.floor(pos)
        wa = (pos - a0).to(dt)
        a0 = torch.remainder(a0.long(), c)
        a1 = torch.remainder(a0 + 1, c)
        return a0, a1, wa

    if mode == "nearest":
        e = torch.where(we < 0.5, e0, e1)
        c = counts[e]
        a = torch.remainder(torch.floor(az * c / 360.0 + 0.5).long(), c)
        w = torch.zeros((az.shape[0], 4), dtype=dt, device=az.device)
        w[:, 0] = 1.0
        return e[:, None].expand(-1, 4), a[:, None].expand(-1, 4), w
    if mode != "bilinear":
        raise ValueError(f"unknown interp mode {mode!r}")

    a0_0, a1_0, wa_0 = ring_floor(e0)
    a0_1, a1_1, wa_1 = ring_floor(e1)
    eidx = torch.stack([e0, e0, e1, e1], dim=-1)
    aidx = torch.stack([a0_0, a1_0, a0_1, a1_1], dim=-1)
    w = torch.stack([
        (1.0 - we) * (1.0 - wa_0),
        (1.0 - we) * wa_0,
        we * (1.0 - wa_1),
        we * wa_1,
    ], dim=-1)
    return eidx, aidx, w


def gather_rows(table: TorchTable, rows: torch.Tensor, w: torch.Tensor, *,
                apply_itd: bool, apply_ild: bool):
    """Gather + lerp 4 flat table rows per direction.

    rows: (..., 4) flat indices e·A_max + a; w: (..., 4) weights, whose
    dtype is the working dtype. → (h (..., 2, T), d (..., 2), g (..., 2)).
    Without ITD the delay is ALIGN_GUARD (filter assembly then shifts by 0);
    without ILD the gain is 1.
    """
    dt = w.dtype
    E, A = table.h.shape[0], table.h.shape[1]
    r = rows.long()
    h4 = table.h.reshape(E * A, 2, -1)[r].to(dt)  # (..., 4, 2, T)
    h = torch.einsum("...k,...kef->...ef", w, h4)
    if apply_itd:
        d = torch.einsum("...k,...ke->...e", w,
                         table.delays.reshape(E * A, 2)[r].to(dt))
    else:
        d = torch.full((*w.shape[:-1], 2), ALIGN_GUARD, dtype=dt,
                       device=w.device)
    if apply_ild:
        g = torch.einsum("...k,...ke->...e", w,
                         table.gains.reshape(E * A, 2)[r].to(dt))
    else:
        g = torch.ones((*w.shape[:-1], 2), dtype=dt, device=w.device)
    return h, d, g


def gather_filters(table: TorchTable, eidx: torch.Tensor, aidx: torch.Tensor,
                   w: torch.Tensor, config: RenderConfig):
    """Gather + lerp the 4 neighbour cells → (h (N, 2, T), d (N, 2),
    g (N, 2)). ITD/ILD apply only to decomposed tables."""
    return gather_rows(
        table, eidx * table.a_max + aidx, w,
        apply_itd=bool(table.decomposed and config.apply_itd),
        apply_ild=bool(table.decomposed and config.apply_ild))


def interpolate(table: TorchTable, az: torch.Tensor, el: torch.Tensor,
                config: RenderConfig):
    """Full direction lookup, weights + gather, for (N,) az/el arrays."""
    eidx, aidx, w = direction_weights(table.elevs, table.az_counts, az, el,
                                      config.interp)
    return gather_filters(table, eidx, aidx, w, config)

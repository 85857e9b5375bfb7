"""The golden render maps, vectorised in plain torch.

The float64 arithmetic of the golden reference (tinaural's
`reference/golden.py`: bilinear lookup, ITD/ILD filter assembly, crossfaded
block convolution, overlap-add, mixdown), over tiles of blocks at once, so
that a run can check what its window produced at the window's own sizes on
the card, after the window has closed. The benchmark's tests hold every
function here against the program's golden maps at small sizes on the CPU.

``Precision`` says how a map computes: ``FLOAT64`` is the reference;
``BFLOAT16`` is the control, the same map in float32 arithmetic with every
stored stage (signal, table, filters, spectra, frames, output) rounded to
bfloat16, the next precision below the float32 that the configurations
state. Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .table import (ALIGN_GUARD, DELAY_PAD, MAX_RENDER_SHIFT, TAPER_HI,
                    TAPER_LO, Table)


@dataclasses.dataclass(frozen=True)
class Precision:
    """``dtype``: the real type the arithmetic runs in; ``round_to``: the
    type every stored stage is rounded to, or None."""

    name: str
    dtype: torch.dtype
    round_to: torch.dtype | None = None

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """A stage's values as this precision stores them."""
        if self.round_to is None:
            return t
        if t.is_complex():
            return torch.view_as_complex(
                torch.view_as_real(t).to(self.round_to).to(self.dtype)
                .contiguous())
        return t.to(self.round_to).to(self.dtype)


FLOAT64 = Precision("float64", torch.float64)
BFLOAT16 = Precision("bfloat16", torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Config:
    """The render settings the maps read, under the names and defaults of
    the program's render configuration."""

    interp: str = "bilinear"
    apply_itd: bool = True
    apply_ild: bool = True
    block_size: int = 1024
    crossfade: bool = True
    out_length: str = "full"
    dir_rate: int = 1


def next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(n)))


@dataclasses.dataclass
class DeviceTable:
    """A `Table`'s fields as tensors in one precision on one device, rows
    flattened to e·A_max + a."""

    h: torch.Tensor       # (E·A, 2, T)
    delays: torch.Tensor  # (E·A, 2)
    gains: torch.Tensor   # (E·A, 2)
    elevs: torch.Tensor   # (E,) float64
    counts: torch.Tensor  # (E,) int64
    a_max: int
    decomposed: bool
    prec: Precision

    @property
    def taps(self) -> int:
        return self.h.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.h.device


def device_table(table: Table, device, prec: Precision = FLOAT64) -> DeviceTable:
    E, A = table.h.shape[:2]
    put = lambda a: prec.q(torch.as_tensor(np.ascontiguousarray(a),
                                           dtype=prec.dtype, device=device))
    return DeviceTable(
        h=put(table.h.reshape(E * A, 2, -1)), delays=put(table.delays.reshape(E * A, 2)),
        gains=put(table.gains.reshape(E * A, 2)),
        elevs=torch.as_tensor(table.elevs, dtype=torch.float64, device=device),
        counts=torch.as_tensor(table.az_counts, dtype=torch.int64, device=device),
        a_max=A, decomposed=bool(table.decomposed), prec=prec)


def weights(tab: DeviceTable, dirs: torch.Tensor):
    """Bilinear grid weights (`golden.grid_weights`) of directions dirs (N,
    2) (az, el) in degrees → flat rows (N, 4) int64 and weights (N, 4)
    float64."""
    az = torch.remainder(dirs[:, 0].to(torch.float64), 360.0)
    elevs, counts = tab.elevs, tab.counts
    el = torch.clamp(dirs[:, 1].to(torch.float64), elevs[0], elevs[-1])
    E = elevs.shape[0]
    if E == 1:
        e0 = e1 = torch.zeros_like(az, dtype=torch.int64)
        we = torch.zeros_like(az)
    else:
        e1 = torch.clamp(torch.searchsorted(elevs, el, right=True), 1, E - 1)
        e0 = e1 - 1
        we = (el - elevs[e0]) / (elevs[e1] - elevs[e0])

    def ring(e):
        c = counts[e]
        pos = az * c.to(torch.float64) / 360.0
        a0 = torch.floor(pos)
        wa = pos - a0
        a0 = a0.to(torch.int64)
        return torch.remainder(a0, c), torch.remainder(a0 + 1, c), wa

    a00, a01, wa0 = ring(e0)
    a10, a11, wa1 = ring(e1)
    rows = torch.stack([e0 * tab.a_max + a00, e0 * tab.a_max + a01,
                        e1 * tab.a_max + a10, e1 * tab.a_max + a11], dim=-1)
    w = torch.stack([(1.0 - we) * (1.0 - wa0), (1.0 - we) * wa0,
                     we * (1.0 - wa1), we * wa1], dim=-1)
    return rows, w


def delay_ramp(n_fft: int, d: torch.Tensor) -> torch.Tensor:
    """`table.delay_ramp` in torch: d (...) float64 → (..., n_fft//2 + 1)
    complex128."""
    d = d[..., None]
    di = torch.floor(d)
    frac = d - di
    fnorm = torch.arange(n_fft // 2 + 1, dtype=torch.float64,
                         device=d.device) / n_fft
    t = torch.clamp((fnorm - TAPER_LO) / (TAPER_HI - TAPER_LO), 0.0, 1.0)
    w = 0.5 * (1.0 + torch.cos(math.pi * t))
    theta = -2.0 * math.pi * fnorm
    psi = torch.atan2(frac * torch.sin(theta),
                      (1.0 - frac) + frac * torch.cos(theta))
    phase = theta * di + w * theta * frac + (1.0 - w) * psi
    return torch.polar(torch.ones_like(phase), phase)


def filters(tab: DeviceTable, dirs: torch.Tensor, cfg) -> torch.Tensor:
    """Effective FIRs (`golden.direction_filter`) of directions dirs (N, 2)
    → (N, 2, taps + DELAY_PAD) in the table's precision."""
    prec = tab.prec
    rows, w = weights(tab, dirs)
    w = w.to(prec.dtype)
    h = torch.einsum("nk,nket->net", w, tab.h[rows])
    d = torch.einsum("nk,nke->ne", w.to(torch.float64),
                     tab.delays[rows].to(torch.float64))
    g = torch.einsum("nk,nke->ne", w, tab.gains[rows])
    if not (tab.decomposed and cfg.apply_itd):
        d = torch.full_like(d, ALIGN_GUARD)
    if not (tab.decomposed and cfg.apply_ild):
        g = torch.ones_like(g)
    T_pad = tab.taps + DELAY_PAD
    L = next_pow2(T_pad)
    d = torch.clamp(d - ALIGN_GUARD, -ALIGN_GUARD, MAX_RENDER_SHIFT)
    H = prec.q(torch.fft.rfft(prec.q(h), L))
    H = prec.q(H * delay_ramp(L, d).to(prec.cdtype) * g[..., None])
    return prec.q(torch.fft.irfft(H, L)[..., :T_pad])


def snap_dirs(dirs: torch.Tensor, dir_rate: int) -> torch.Tensor:
    """`golden.snap_dirs` over the block axis of dirs (..., nb, 2)."""
    if dir_rate == 1:
        return dirs
    nb = dirs.shape[-2]
    idx = (torch.arange(nb, device=dirs.device) // dir_rate) * dir_rate
    return dirs[..., idx, :]


def _tile(n_fft: int) -> int:
    """Rows a tile: about 2^24 complex values of each ear's spectra."""
    return max(1, (1 << 24) // n_fft)


def render(tab: DeviceTable, xs, dirs, cfg) -> torch.Tensor:
    """Sources xs (S, N) along per-block directions dirs (S, nb, 2), mixed
    down (`golden.render_scene`; S = 1 is `golden.render_trajectory`) →
    (2, out_len) in the table's precision, on its device."""
    prec, dev = tab.prec, tab.device
    xs = torch.as_tensor(xs, device=dev).to(prec.dtype)
    dirs = snap_dirs(torch.as_tensor(dirs, device=dev).to(torch.float64),
                     cfg.dir_rate)
    S, N = xs.shape
    B = cfg.block_size
    nb = -(-N // B)
    if tuple(dirs.shape) != (S, nb, 2):
        raise ValueError(f"dirs must be ({S}, {nb}, 2), got {tuple(dirs.shape)}")
    xb = prec.q(torch.nn.functional.pad(xs, (0, nb * B - N)).reshape(S, nb, B))
    T_pad = tab.taps + DELAY_PAD
    n_fft = next_pow2(B + T_pad - 1)
    m = n_fft // B
    up = ((torch.arange(B, dtype=torch.float64, device=dev) + 0.5) / B
          if cfg.crossfade else torch.ones(B, dtype=torch.float64, device=dev))
    up = up.to(prec.dtype)
    acc = torch.zeros((2, nb - 1 + m, B), dtype=prec.dtype, device=dev)
    tile = _tile(n_fft)
    for s in range(S):
        for b0 in range(0, nb, tile):
            b1 = min(nb, b0 + tile)
            lo = max(b0 - 1, 0)
            Hs = prec.q(torch.fft.rfft(filters(tab, dirs[s, lo:b1], cfg), n_fft))
            Hc = Hs[b0 - lo:]
            Hp = torch.cat([Hs[:1], Hs[:-1]]) if b0 == 0 else Hs[:-1]
            x = xb[s, b0:b1]
            Xu = prec.q(torch.fft.rfft(up * x, n_fft))[:, None]
            Xd = prec.q(torch.fft.rfft((1.0 - up) * x, n_fft))[:, None]
            Y = prec.q(Xu * Hc + Xd * Hp)
            frames = prec.q(torch.fft.irfft(Y, n_fft)).reshape(b1 - b0, 2, m, B)
            for j in range(m):
                acc[:, b0 + j:b1 + j] += frames[:, :, j].transpose(0, 1)
    out_len = N + T_pad - 1 if cfg.out_length == "full" else N
    return prec.q(acc.reshape(2, -1)[:, :out_len])

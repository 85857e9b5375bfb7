"""The HRIR table: host-side numpy arrays and their torch counterpart.

The numpy half is a copy of `tinaural.data.table` (decomposition, delay
ramp, `.npz` I/O), kept bit-equal to it by `tests/test_torch_data.py`; the
JAX package's own module cannot be imported here because it pulls in flax.

The ragged KEMAR grid is padded to ``A_max`` azimuth slots at load time, so
every render-time lookup is index math plus a gather over one dense table.
A decomposed table stores ``gain × aligned shape × fractional delay`` per
(direction, ear): interpolating raw HRIRs with different onsets
comb-filters, so shapes are time-aligned, interpolated, and the delay is
re-applied as a frequency-domain phase ramp and the level as a per-ear gain.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np
import torch

from .grids import SphericalGrid

_log = logging.getLogger("tinaural_torch.data")


@dataclasses.dataclass
class HrirArrays:
    """Dense padded HRIR dataset + grid metadata, as numpy arrays.

    h:         (E, A_max, 2, T) float32 — time-domain HRIRs; if
               ``decomposed``, time-aligned unit-energy shapes.
    delays:    (E, A_max, 2) float32 — per-ear time of arrival in samples
               (zeros if not decomposed).
    gains:     (E, A_max, 2) float32 — per-ear broadband gain (ones if not
               decomposed).
    elevs:     (E,) float32 — ring elevations, degrees, increasing.
    az_counts: (E,) int32 — azimuths measured per ring.
    valid:     (E, A_max) float32 — 1.0 where the cell holds real data.
    """

    h: np.ndarray
    delays: np.ndarray
    gains: np.ndarray
    elevs: np.ndarray
    az_counts: np.ndarray
    valid: np.ndarray
    sample_rate: int = 44100
    decomposed: bool = False

    @property
    def taps(self) -> int:
        return self.h.shape[-1]

    def grid(self) -> SphericalGrid:
        return SphericalGrid(
            elevs=np.asarray(self.elevs, dtype=np.float64),
            az_counts=np.asarray(self.az_counts, dtype=np.int64),
        )


@dataclasses.dataclass
class TorchTable:
    """`HrirArrays`' six fields as torch tensors on one explicit device:
    h, delays, gains, valid float32; elevs float32; az_counts int32."""

    h: torch.Tensor
    delays: torch.Tensor
    gains: torch.Tensor
    elevs: torch.Tensor
    az_counts: torch.Tensor
    valid: torch.Tensor
    sample_rate: int = 44100
    decomposed: bool = False

    @classmethod
    def from_arrays(cls, h, delays, gains, elevs, az_counts, valid, *,
                    sample_rate: int, decomposed: bool,
                    device) -> "TorchTable":
        """The weights bridge: host arrays → contiguous device tensors."""
        f32 = lambda a: torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.float32), device=device)
        return cls(
            h=f32(h), delays=f32(delays), gains=f32(gains), elevs=f32(elevs),
            az_counts=torch.as_tensor(
                np.ascontiguousarray(az_counts, dtype=np.int32), device=device),
            valid=f32(valid), sample_rate=int(sample_rate),
            decomposed=bool(decomposed))

    @classmethod
    def from_hrir_table(cls, t: Any, device) -> "TorchTable":
        """Carry any table with `HrirArrays`' attributes across (an
        `HrirArrays`, or the JAX package's `HrirTable`), reading each
        field through `np.asarray`."""
        return cls.from_arrays(
            np.asarray(t.h), np.asarray(t.delays), np.asarray(t.gains),
            np.asarray(t.elevs), np.asarray(t.az_counts), np.asarray(t.valid),
            sample_rate=t.sample_rate, decomposed=t.decomposed, device=device)

    def to_arrays(self) -> HrirArrays:
        """The weights bridge back: the six fields as host numpy arrays
        (detached; h, delays, gains, valid and elevs float32, az_counts
        int32)."""
        host = lambda t: t.detach().cpu().numpy()
        return HrirArrays(
            h=host(self.h), delays=host(self.delays), gains=host(self.gains),
            elevs=host(self.elevs), az_counts=host(self.az_counts),
            valid=host(self.valid), sample_rate=self.sample_rate,
            decomposed=self.decomposed)

    @property
    def device(self) -> torch.device:
        return self.h.device

    @property
    def a_max(self) -> int:
        return self.h.shape[1]

    @property
    def taps(self) -> int:
        return self.h.shape[-1]


def estimate_delays(h: np.ndarray, f_lo: float = 300.0, f_hi: float = 6000.0,
                    sample_rate: int = 44100) -> np.ndarray:
    """Fractional time-of-arrival per impulse response, in samples.

    Weighted least-squares affine fit to the unwrapped rfft phase over
    [f_lo, f_hi] (weights = |H|²); the slope is the group delay. The fit
    anchors on the envelope-peak index first and fits the compensated
    residual phase, so delays above T/2 samples do not alias through
    ``np.unwrap``.

    h: (..., T) → returns (...) float64 delays.
    """
    T = h.shape[-1]
    H = np.fft.rfft(h, axis=-1)
    k = np.arange(H.shape[-1])
    freqs = k * (sample_rate / T)
    band = (freqs >= f_lo) & (freqs <= f_hi)

    d0 = np.argmax(np.abs(h), axis=-1).astype(np.float64)  # coarse anchor
    comp = np.exp(2j * np.pi * k * d0[..., None] / T)
    phase = np.unwrap(np.angle(H * comp), axis=-1)[..., band]
    w = (np.abs(H) ** 2)[..., band] + 1e-20
    kk = k[band].astype(np.float64)

    # Weighted affine LS: phase ≈ a + b·k  ⇒  delay = d0 - b·T/(2π).
    sw = w.sum(-1)
    mk = (w * kk).sum(-1) / sw
    mp = (w * phase).sum(-1) / sw
    cov = (w * (kk - mk[..., None]) * (phase - mp[..., None])).sum(-1)
    var = (w * (kk - mk[..., None]) ** 2).sum(-1) + 1e-20
    b = cov / var
    return d0 - b * T / (2.0 * np.pi)


# Band blend for the sub-sample part of a delay, in units of f/fs: the exact
# fractional phase below TAPER_LO·fs, raised-cosine blended toward the phase
# of the first-order-Lagrange ramp above TAPER_HI·fs. The blend keeps the
# ramp Hermitian-consistent at Nyquist at every FFT size and continuous in
# the delay (the full rationale is at the same constants in the JAX
# package's `tinaural.data.table`).
TAPER_LO = 0.40
TAPER_HI = 0.475


def _phase_taper(fnorm: np.ndarray) -> np.ndarray:
    """Smooth 1→0 raised-cosine window over [TAPER_LO, TAPER_HI] of f/fs."""
    t = np.clip((fnorm - TAPER_LO) / (TAPER_HI - TAPER_LO), 0.0, 1.0)
    return 0.5 * (1.0 + np.cos(np.pi * t))


def delay_ramp(n_fft: int, shift_samples: np.ndarray) -> np.ndarray:
    """rfft-bin multiplier implementing a fractional delay of ``d`` samples.

    ``exp(j·[θ·⌊d⌋ + W(f)·θ·frac + (1−W(f))·ψ(θ, frac)])`` at the rfft bins
    of ``n_fft``, with ``θ = −2πf``, ``frac = d − ⌊d⌋``,
    ``ψ(θ,φ) = arg((1−φ) + φ·e^{jθ})`` and ``W`` the raised-cosine band
    weight. Unit magnitude, integer-exact, exactly invertible, and a
    function of absolute frequency only.

    shift_samples: (...) → (..., n_fft//2 + 1) complex, |ramp| = 1.
    """
    d = np.asarray(shift_samples, dtype=np.float64)[..., None]
    di = np.floor(d)
    frac = d - di
    fnorm = np.arange(n_fft // 2 + 1) / n_fft  # f/fs in [0, 0.5]
    theta = -2.0 * np.pi * fnorm
    w = _phase_taper(fnorm)
    psi = np.arctan2(frac * np.sin(theta), (1.0 - frac) + frac * np.cos(theta))
    phase = theta * di + w * theta * frac + (1.0 - w) * psi
    return np.exp(1j * phase)


def fractional_shift(h: np.ndarray, shift_samples: np.ndarray) -> np.ndarray:
    """Circularly shift each response by a (fractional) number of samples
    via a frequency-domain phase ramp. Positive shift delays the signal.

    h: (..., T), shift_samples: (...) → (..., T).
    """
    T = h.shape[-1]
    H = np.fft.rfft(h, axis=-1)
    return np.fft.irfft(H * delay_ramp(T, shift_samples), n=T, axis=-1)


# Samples of pre-onset slack kept when time-aligning HRIRs: shapes are
# aligned by (delay − ALIGN_GUARD), so their rising edge stays clear of the
# frame's circular-wrap boundary, and the render path re-applies the same
# guarded amount.
ALIGN_GUARD = 8.0

# Samples of headroom the effective filter appends past the raw tap count,
# absorbing the ITD shift plus the fractional-delay kernel's tails.
DELAY_PAD = 64

# Headroom the render path gives a (delay − ALIGN_GUARD) shift before
# clipping; shared by the loader's bulk-delay rule and the render clip.
MAX_RENDER_SHIFT = DELAY_PAD - 16.0


def decompose_table(h: np.ndarray, valid: np.ndarray, sample_rate: int):
    """Split raw HRIRs into (aligned unit-energy shapes, delays, gains).

    h: (E, A, 2, T); valid: (E, A) → (aligned, delays, gains) with
    delays/gains of shape (E, A, 2). Invalid cells get zero delay, unit
    gain, zero shape. When a valid delay exceeds the renderable shift range,
    the table's minimum valid delay (bulk propagation delay) is removed from
    the stored delay track; shapes are still aligned by the true delay.
    """
    delays = estimate_delays(h, sample_rate=sample_rate)  # (E, A, 2)
    delays = delays * valid[..., None]
    aligned = fractional_shift(h, -(delays - ALIGN_GUARD))
    gains = np.sqrt(np.sum(aligned**2, axis=-1))  # (E, A, 2)
    gains_safe = np.where(gains > 1e-12, gains, 1.0)
    aligned = aligned / gains_safe[..., None]
    gains = np.where(valid[..., None] > 0, gains_safe, 1.0)

    vmask = valid[..., None] > 0
    if np.any(vmask):
        vdel = delays[np.broadcast_to(vmask, delays.shape)]
        if vdel.max() - ALIGN_GUARD > MAX_RENDER_SHIFT:
            bulk = float(vdel.min())
            _log.info(
                "decompose_table: removing %.2f samples of bulk delay "
                "(max TOA %.2f exceeds the renderable shift range)",
                bulk, float(vdel.max()))
            delays = (delays - bulk) * valid[..., None]
            if vdel.max() - bulk - ALIGN_GUARD > MAX_RENDER_SHIFT:
                _log.warning(
                    "decompose_table: interaural delay spread %.2f samples "
                    "exceeds the renderable range (%.0f); ITDs will clip",
                    float(vdel.max() - bulk), MAX_RENDER_SHIFT)
    return aligned, delays, gains


def save_table(path, table) -> None:
    """Serialise a table to ``.npz`` (decomposition included). Reads the
    JAX package's files and writes files it reads."""
    np.savez_compressed(
        path,
        h=np.asarray(table.h),
        delays=np.asarray(table.delays),
        gains=np.asarray(table.gains),
        elevs=np.asarray(table.elevs),
        az_counts=np.asarray(table.az_counts),
        valid=np.asarray(table.valid),
        sample_rate=np.int64(table.sample_rate),
        decomposed=np.bool_(table.decomposed),
    )


def load_table(path) -> HrirArrays:
    """Load a table saved by `save_table`."""
    z = np.load(path)
    return HrirArrays(
        h=z["h"], delays=z["delays"], gains=z["gains"], elevs=z["elevs"],
        az_counts=z["az_counts"], valid=z["valid"],
        sample_rate=int(z["sample_rate"]), decomposed=bool(z["decomposed"]),
    )


def build_table(h: np.ndarray, grid: SphericalGrid, sample_rate: int,
                decompose: bool = True) -> HrirArrays:
    """Assemble `HrirArrays` from a dense HRIR array + grid metadata."""
    E, A = grid.n_elevs, grid.a_max
    if h.shape[:3] != (E, A, 2):
        raise ValueError(f"h shape {h.shape} does not match grid ({E},{A},2,T)")
    valid = grid.validity_mask().astype(np.float64)
    h = h * valid[..., None, None]
    if decompose:
        h_out, d_out, g_out = decompose_table(h, valid, sample_rate)
    else:
        h_out = h
        d_out = np.zeros((E, A, 2))
        g_out = np.ones((E, A, 2))
    return HrirArrays(
        h=h_out.astype(np.float32),
        delays=d_out.astype(np.float32),
        gains=g_out.astype(np.float32),
        elevs=np.asarray(grid.elevs, dtype=np.float32),
        az_counts=np.asarray(grid.az_counts, dtype=np.int32),
        valid=valid.astype(np.float32),
        sample_rate=int(sample_rate),
        decomposed=bool(decompose),
    )

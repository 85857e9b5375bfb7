"""The HRIR table of the reference: a frozen float64 copy of the program's
decomposition (`tinaural_torch.data.table`: delays, the fractional-delay
ramp, aligned unit-energy shapes and gains).

The reference decomposes the raw HRIRs itself and keeps every field in
float64; the program decomposes the same raw array with its own code and
stores float32. A decomposed table stores ``gain × aligned shape ×
fractional delay`` per (direction, ear): shapes are time-aligned and
interpolated, the delay is re-applied as a frequency-domain phase ramp and
the level as a per-ear gain.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .grids import SphericalGrid


@dataclasses.dataclass
class Table:
    """Dense padded HRIR table in float64.

    h: (E, A_max, 2, T) aligned unit-energy shapes (raw HRIRs if not
    decomposed); delays, gains: (E, A_max, 2); elevs (E,); az_counts (E,);
    valid (E, A_max)."""

    h: np.ndarray
    delays: np.ndarray
    gains: np.ndarray
    elevs: np.ndarray
    az_counts: np.ndarray
    valid: np.ndarray
    sample_rate: int = 44100
    decomposed: bool = True

    @property
    def taps(self) -> int:
        return self.h.shape[-1]


def estimate_delays(h: np.ndarray, f_lo: float = 300.0, f_hi: float = 6000.0,
                    sample_rate: int = 44100) -> np.ndarray:
    """Fractional time of arrival per impulse response, in samples: a
    weighted least-squares affine fit to the unwrapped rfft phase over
    [f_lo, f_hi] (weights |H|²), anchored on the envelope peak.

    h: (..., T) → (...) float64 delays."""
    T = h.shape[-1]
    H = np.fft.rfft(h, axis=-1)
    k = np.arange(H.shape[-1])
    freqs = k * (sample_rate / T)
    band = (freqs >= f_lo) & (freqs <= f_hi)

    d0 = np.argmax(np.abs(h), axis=-1).astype(np.float64)
    comp = np.exp(2j * np.pi * k * d0[..., None] / T)
    phase = np.unwrap(np.angle(H * comp), axis=-1)[..., band]
    w = (np.abs(H) ** 2)[..., band] + 1e-20
    kk = k[band].astype(np.float64)

    sw = w.sum(-1)
    mk = (w * kk).sum(-1) / sw
    mp = (w * phase).sum(-1) / sw
    cov = (w * (kk - mk[..., None]) * (phase - mp[..., None])).sum(-1)
    var = (w * (kk - mk[..., None]) ** 2).sum(-1) + 1e-20
    b = cov / var
    return d0 - b * T / (2.0 * np.pi)


# Band blend for the sub-sample part of a delay, in units of f/fs: the exact
# fractional phase below TAPER_LO·fs, raised-cosine blended toward the
# phase of the first-order-Lagrange ramp above TAPER_HI·fs.
TAPER_LO = 0.40
TAPER_HI = 0.475

# Samples of pre-onset slack kept when time-aligning HRIRs.
ALIGN_GUARD = 8.0

# Samples of headroom the effective filter appends past the raw tap count.
DELAY_PAD = 64

# Headroom a (delay − ALIGN_GUARD) shift has before it is clipped.
MAX_RENDER_SHIFT = DELAY_PAD - 16.0


def _phase_taper(fnorm: np.ndarray) -> np.ndarray:
    t = np.clip((fnorm - TAPER_LO) / (TAPER_HI - TAPER_LO), 0.0, 1.0)
    return 0.5 * (1.0 + np.cos(np.pi * t))


def delay_ramp(n_fft: int, shift_samples: np.ndarray) -> np.ndarray:
    """rfft-bin multiplier of a fractional delay of ``d`` samples:
    ``exp(j·[θ·⌊d⌋ + W(f)·θ·frac + (1−W(f))·ψ(θ, frac)])`` with ``θ =
    −2πf``, ``ψ(θ,φ) = arg((1−φ) + φ·e^{jθ})`` and ``W`` the raised-cosine
    band weight. shift_samples: (...) → (..., n_fft//2 + 1) complex."""
    d = np.asarray(shift_samples, dtype=np.float64)[..., None]
    di = np.floor(d)
    frac = d - di
    fnorm = np.arange(n_fft // 2 + 1) / n_fft
    theta = -2.0 * np.pi * fnorm
    w = _phase_taper(fnorm)
    psi = np.arctan2(frac * np.sin(theta), (1.0 - frac) + frac * np.cos(theta))
    phase = theta * di + w * theta * frac + (1.0 - w) * psi
    return np.exp(1j * phase)


def fractional_shift(h: np.ndarray, shift_samples: np.ndarray) -> np.ndarray:
    """Circular fractional shift of each response by a phase ramp; a
    positive shift delays. h: (..., T), shift_samples: (...) → (..., T)."""
    T = h.shape[-1]
    H = np.fft.rfft(h, axis=-1)
    return np.fft.irfft(H * delay_ramp(T, shift_samples), n=T, axis=-1)


def decompose_table(h: np.ndarray, valid: np.ndarray, sample_rate: int):
    """Raw HRIRs (E, A, 2, T) and the validity mask (E, A) → (aligned
    shapes, delays, gains). When a valid delay exceeds the renderable shift
    range, the table's least valid delay (bulk propagation) is removed from
    the stored delays; shapes stay aligned by the true delay."""
    delays = estimate_delays(h, sample_rate=sample_rate)
    delays = delays * valid[..., None]
    aligned = fractional_shift(h, -(delays - ALIGN_GUARD))
    gains = np.sqrt(np.sum(aligned**2, axis=-1))
    gains_safe = np.where(gains > 1e-12, gains, 1.0)
    aligned = aligned / gains_safe[..., None]
    gains = np.where(valid[..., None] > 0, gains_safe, 1.0)

    vmask = valid[..., None] > 0
    if np.any(vmask):
        vdel = delays[np.broadcast_to(vmask, delays.shape)]
        if vdel.max() - ALIGN_GUARD > MAX_RENDER_SHIFT:
            delays = (delays - float(vdel.min())) * valid[..., None]
    return aligned, delays, gains


def build(h: np.ndarray, grid: SphericalGrid, sample_rate: int) -> Table:
    """The decomposed float64 table of raw HRIRs ``h`` (E, A_max, 2, T) on
    ``grid``."""
    valid = grid.validity_mask().astype(np.float64)
    h = h * valid[..., None, None]
    aligned, delays, gains = decompose_table(h, valid, sample_rate)
    return Table(h=aligned, delays=delays, gains=gains,
                 elevs=np.asarray(grid.elevs, dtype=np.float64),
                 az_counts=np.asarray(grid.az_counts, dtype=np.int64),
                 valid=valid, sample_rate=int(sample_rate), decomposed=True)

"""Effective-filter assembly in torch.

Every render mode convolves the same per-direction FIR: ``gain ·
fractional_delay(aligned shape)`` materialised to ``taps + DELAY_PAD``
samples at the canonical size ``L = next_pow2(taps + DELAY_PAD)``
(`golden.effective_filter`). `filter_spectrum_mm` computes its rfft at the
render's FFT size through fixed matrices (M1: rfft_L; MB: irfft_L +
truncation; MA: rfft_nfft) around the direction-dependent ramp and gain.
The matrix generators are numpy copies of `tinaural.ops.filters`', derived
by pushing basis vectors through the numpy FFT chain; `test_torch_data.py`
keeps them bit-equal to the JAX package's.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..data.table import (ALIGN_GUARD, DELAY_PAD, MAX_RENDER_SHIFT,
                          TAPER_HI, TAPER_LO)


def next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def _ramp_phase(n_fft: int, d: torch.Tensor):
    """The ramp's phase at the rfft bins of ``n_fft`` for delays d (..., 1),
    and the band-weighted slope θ·w of a pure delay (F,)."""
    dt = d.dtype
    di = torch.floor(d)
    frac = d - di
    fnorm = torch.arange(n_fft // 2 + 1, dtype=dt, device=d.device) / n_fft
    t = torch.clamp((fnorm - TAPER_LO) / (TAPER_HI - TAPER_LO), 0.0, 1.0)
    w = 0.5 * (1.0 + torch.cos(math.pi * t))
    theta = -2.0 * math.pi * fnorm
    psi = torch.atan2(frac * torch.sin(theta),
                      (1.0 - frac) + frac * torch.cos(theta))
    phase = theta * di + w * theta * frac + (1.0 - w) * psi
    return phase, theta * w


class _DelayRamp(torch.autograd.Function):
    """The exact ramp as the value, the straight-through slope as the
    gradient (`tinaural.ops.filters.delay_ramp`'s stop-gradient): ∂ψ/∂frac
    steepens without bound toward Nyquist, and those few-bin spikes wreck
    ITD fitting, so ∂phase/∂d is the band-weighted pure-delay slope θ·w,
    the derivative of a fractional delay."""

    @staticmethod
    def forward(ctx, d: torch.Tensor, n_fft: int) -> torch.Tensor:
        phase, slope = _ramp_phase(n_fft, d)
        ramp = torch.polar(torch.ones_like(phase), phase)
        ctx.save_for_backward(ramp, slope)
        return ramp

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        ramp, slope = ctx.saved_tensors
        # d/dφ of e^{jφ} is j·e^{jφ}; against the complex gradient that is
        # Re(conj(grad)·j·ramp) = Im(grad)·Re(ramp) − Re(grad)·Im(ramp)
        g_phase = grad.imag * ramp.real - grad.real * ramp.imag
        return (g_phase * slope).sum(-1, keepdim=True), None


def delay_ramp(n_fft: int, shift_samples: torch.Tensor) -> torch.Tensor:
    """Torch counterpart of `tinaural_torch.data.table.delay_ramp`, in the
    dtype of ``shift_samples`` (float32 → complex64, float64 →
    complex128), with the same operation order as the JAX package's f32
    version. The gradient with respect to the delay is the JAX version's
    straight-through one (`_DelayRamp`); the value is the exact phase.

    shift_samples: (...) → (..., n_fft//2 + 1) complex, |ramp| = 1.
    """
    return _DelayRamp.apply(shift_samples[..., None], n_fft)


def _clip_delay(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(d - ALIGN_GUARD, -ALIGN_GUARD, MAX_RENDER_SHIFT)


@lru_cache(maxsize=8)
def _assembly_basis(taps: int) -> tuple[np.ndarray, np.ndarray]:
    """M1 (taps → [Re G, Im G] rfft_L planes) and the time-domain images
    of the 2·F_L re/im basis vectors after irfft_L + truncate-to-T_pad."""
    T_pad = taps + DELAY_PAD
    L = next_pow2(T_pad)
    FL = L // 2 + 1
    G = np.fft.rfft(np.eye(taps), n=L, axis=-1)  # (taps, FL)
    M1 = np.concatenate([G.real, G.imag], axis=-1)
    basis = np.zeros((2 * FL, FL), dtype=np.complex128)
    basis[:FL] = np.eye(FL)
    basis[FL:] = 1j * np.eye(FL)
    ht = np.fft.irfft(basis, n=L, axis=-1)[:, :T_pad]  # (2FL, T_pad)
    return M1.astype(np.float64), ht


@lru_cache(maxsize=8)
def _rfft_matrix(taps: int, n_fft: int) -> np.ndarray:
    """MA: (T_pad, 2·F_n) — h_eff ↦ [Re, Im] rfft_nfft(h_eff)."""
    Tp = taps + DELAY_PAD
    A = np.fft.rfft(np.eye(Tp), n=n_fft, axis=-1)  # (Tp, Fn)
    return np.concatenate([A.real, A.imag], axis=-1).astype(np.float32)


@lru_cache(maxsize=8)
def _hybrid_matrices(taps: int) -> tuple[np.ndarray, np.ndarray]:
    """M1 (taps → 2F_L re/im spectra) and MB (2F_L → T_pad time domain:
    irfft_L + truncate composed), float32."""
    M1, ht = _assembly_basis(taps)
    return M1.astype(np.float32), ht.astype(np.float32)


def _as(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, device=like.device).to(like.dtype)


def _basis_mats(taps: int, dtype: torch.dtype) -> tuple[np.ndarray, np.ndarray]:
    """(M1, MB) at the working precision: float64 takes the basis as
    derived; everything else its float32 copy. (MA exists as float32
    only, so a float64 product carries its float32 rounding.)"""
    if dtype == torch.float64:
        return _assembly_basis(taps)
    return _hybrid_matrices(taps)


def ramped_spectrum_planes(h: torch.Tensor, d: torch.Tensor, g: torch.Tensor,
                           taps: int) -> torch.Tensor:
    """rfft_L planes of the gathered shapes with the delay ramp and gain
    applied. h: (..., 2, taps); d, g: (..., 2) → (..., 2, 2·F_L)
    [Re | Im]."""
    L = next_pow2(taps + DELAY_PAD)
    FL = L // 2 + 1
    G = h @ _as(_basis_mats(taps, h.dtype)[0], h)
    Gr, Gi = G[..., :FL], G[..., FL:]
    ramp = delay_ramp(L, _clip_delay(d))
    c, s = ramp.real, ramp.imag
    gg = g[..., None]
    return torch.cat([(Gr * c - Gi * s) * gg, (Gr * s + Gi * c) * gg], dim=-1)


def filter_spectrum_mm(h: torch.Tensor, d: torch.Tensor, g: torch.Tensor,
                       taps: int, n_fft: int) -> torch.Tensor:
    """Effective-filter spectrum at ``n_fft`` through the fixed matrices:
    exactly ``rfft(effective_filter(h, d, g), n_fft)`` as a linear map.

    h: (..., 2, taps); d, g: (..., 2) → (..., 2, n_fft//2+1) complex, in
    h's precision.
    """
    Fn = n_fft // 2 + 1
    MB = _as(_basis_mats(taps, h.dtype)[1], h)
    MA = _as(_rfft_matrix(taps, n_fft), h)
    G2 = ramped_spectrum_planes(h, d, g, taps)  # (..., 2, 2FL)
    H = (G2 @ MB) @ MA  # (..., 2, 2Fn)
    return torch.complex(H[..., :Fn], H[..., Fn:])


def effective_filter(h: torch.Tensor, d: torch.Tensor, g: torch.Tensor,
                     taps: int) -> torch.Tensor:
    """Materialise the per-direction FIR through the FFT chain.

    h: (..., 2, T) aligned shapes; d, g: (..., 2) → (..., 2, T+DELAY_PAD).
    """
    T_pad = taps + DELAY_PAD
    L = next_pow2(T_pad)
    H = torch.fft.rfft(h, n=L) * delay_ramp(L, _clip_delay(d)) * g[..., None]
    return torch.fft.irfft(H, n=L)[..., :T_pad]


def n_parts(taps: int, block: int) -> int:
    """Partitions of ``block`` samples that cover the effective filter."""
    return -(-(taps + DELAY_PAD) // block)


def partition_spectra(h_eff: torch.Tensor, block: int) -> torch.Tensor:
    """rfft_2B of the B-sample partitions of effective filters, each
    zero-padded to 2B (`golden.partition_filter`). h_eff: (..., 2, T_eff)
    → (..., P, 2, block+1)."""
    P = -(-h_eff.shape[-1] // block)
    parts = torch.nn.functional.pad(h_eff, (0, P * block - h_eff.shape[-1]))
    parts = parts.reshape(*h_eff.shape[:-1], P, block)
    return torch.fft.rfft(parts, n=2 * block).transpose(-3, -2)


def filter_partitions(h: torch.Tensor, d: torch.Tensor, g: torch.Tensor,
                      taps: int, block: int) -> torch.Tensor:
    """Streaming / partitioned-convolution filter spectra through the FFT
    chain, in h's precision: the map of `tinaural.ops.filters.
    filter_partitions` (whose zoom-matmul branch is the same linear map).

    h: (..., 2, taps); d, g: (..., 2) → (..., P, 2, block+1) complex.
    """
    return partition_spectra(effective_filter(h, d, g, taps), block)

"""Uniformly partitioned overlap-save convolution, offline form, in plain
torch.

Counterpart of `tinaural.ops.partitioned`: the streaming renderer's math
with every block batched. Frame b is ``[block b−1 | block b]`` (block −1
silent), transformed at 2B; the P-partition frequency-domain delay line
becomes P block-shifted products; the output of each block is the last B
samples of the inverse. The JAX package's two-for-one FFT packing is a TPU
device trick and is left out: these are the plain versions the CUDA kernels
are held against.
"""

from __future__ import annotations

import torch


def frame_spectra(xb: torch.Tensor) -> torch.Tensor:
    """Blocks (nb, B) → 50%-overlap-save frame spectra (nb, B+1)."""
    nb, B = xb.shape
    prev = torch.cat([xb.new_zeros((1, B)), xb[:-1]], dim=0)
    return torch.fft.rfft(torch.cat([prev, xb], dim=-1), n=2 * B)


def shifted_stack(X: torch.Tensor, P: int) -> torch.Tensor:
    """(nb, F) → (P, nb, F), slice p = X delayed by p blocks (zero-filled):
    the frequency-domain delay line, materialised."""
    return torch.stack([delayed(X, p) for p in range(P)], dim=0)


def delayed(X: torch.Tensor, p: int) -> torch.Tensor:
    """(nb, F) → X delayed by p blocks along its first axis, zero-filled."""
    nb = X.shape[0]
    if p >= nb:
        return torch.zeros_like(X)
    return torch.cat([X.new_zeros((p, *X.shape[1:])), X[:nb - p]], dim=0)


def partitioned_mac(Xs: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Delay-line MAC. Xs: (P, nb, F); H: (P, 2, F) static filter or
    (nb, P, 2, F) per-block filters → (nb, 2, F)."""
    if H.dim() == 3:
        return torch.einsum("pbf,pef->bef", Xs, H)
    return torch.einsum("pbf,bpef->bef", Xs, H)


def overlap_save_tail(Y: torch.Tensor, B: int) -> torch.Tensor:
    """(..., 2, F) spectra → the valid last B samples of each 2B frame,
    (..., 2, B)."""
    return torch.fft.irfft(Y, n=2 * B)[..., B:]


def tail_pair(Yn: torch.Tensor, Yp: torch.Tensor, B: int):
    """Overlap-save tails of a crossfade pair: (..., 2, F) spectra under the
    current and the previous filters → two (..., 2, B) tails."""
    return overlap_save_tail(Yn, B), overlap_save_tail(Yp, B)


def crossfade_tails(Yn: torch.Tensor, Yp: torch.Tensor | None,
                    B: int) -> torch.Tensor:
    """Tails of (..., 2, F) spectra, blended ``w·yn + (1−w)·yp`` with
    ``w = (i + 0.5)/B`` when Yp is given → (..., 2, B)."""
    if Yp is None:
        return overlap_save_tail(Yn, B)
    yn, yp = tail_pair(Yn, Yp, B)
    w = (torch.arange(B, dtype=yn.dtype, device=yn.device) + 0.5) / B
    return w * yn + (1.0 - w) * yp

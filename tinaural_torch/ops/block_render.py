"""The single-launch block render: raw blocks in, overlap-added stereo out.

Counterpart of `tinaural.ops.pallas_kernels.fused_block_render` in its
in-kernel gather mode. Per source s and block b, with ``F = n_fft/2 + 1``:

1. gather: h, d, g = Σₖ wₖ·row[idxₖ] (delay ALIGN_GUARD without ITD, gain
   1 without ILD);
2. assembly: H[s,b] = rfft_nfft(effective_filter(h, d, g)) — (2, F);
3. crossfaded MAC: Y = rfft(x·u)·H[s,b] + rfft(x·(1−u))·H[s,b−1] with
   u = (i + 0.5)/B and H[s,−1] := H[s,0]; without crossfade Y = rfft(x)·H;
4. sum over sources, irfft per ear, overlap-add at hop B.

`block_render` launches the hand-written CUDA kernels of
``csrc/block_render.cu`` on CUDA tensors and calls the plain version,
`block_render_reference`, on CPU tensors; any other device raises.
``launches`` counts each kernel's launches.
"""

from __future__ import annotations

import torch

from ..data.table import (ALIGN_GUARD, DELAY_PAD, MAX_RENDER_SHIFT,
                          TAPER_HI, TAPER_LO, TorchTable)
from .filters import filter_spectrum_mm
from .interp import gather_rows
from .ola import overlap_add

KERNELS = ("assemble_filters", "block_spectra_mix_inverse", "overlap_add")
launches = dict.fromkeys(KERNELS, 0)

# Largest FFT the kernels take: their dynamic shared memory is about
# 20·n_fft bytes, under the H100's 227 KB per block.
MAX_N_FFT = 8192


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def _check_inputs(xbs, idx, w, table: TorchTable, n_fft: int) -> None:
    if xbs.dim() != 3:
        raise ValueError(f"xbs must be (S, nb, B), got {tuple(xbs.shape)}")
    S, nb, B = xbs.shape
    for name, t in (("idx", idx), ("w", w)):
        if tuple(t.shape) != (S, nb, 4):
            raise ValueError(f"{name} must be ({S}, {nb}, 4), got {tuple(t.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if n_fft & (n_fft - 1) or n_fft % B or n_fft < B + table.taps + DELAY_PAD - 1:
        raise ValueError(
            f"n_fft={n_fft} must be a power of two, a multiple of B={B} and "
            f"at least B + taps + {DELAY_PAD} - 1")
    devs = {t.device for t in (xbs, idx, w, table.h, table.delays, table.gains)}
    if len(devs) != 1:
        raise ValueError(f"inputs and table lie on different devices: {devs}")


def block_render(xbs: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 table: TorchTable, n_fft: int, *, crossfade: bool,
                 apply_itd: bool, apply_ild: bool) -> torch.Tensor:
    """xbs (S, nb, B) f32; idx (S, nb, 4) int32 flat table rows
    (e·A_max + a); w (S, nb, 4) f32 → (2, (nb−1)·B + n_fft) f32, sources
    mixed down."""
    _check_inputs(xbs, idx, w, table, n_fft)
    kw = dict(crossfade=crossfade, apply_itd=apply_itd, apply_ild=apply_ild)
    if xbs.device.type == "cpu":
        return block_render_reference(xbs, idx, w, table, n_fft, **kw)
    if xbs.device.type != "cuda":
        raise ValueError(f"block_render runs on cpu or cuda, not {xbs.device}")
    return _block_render_cuda(xbs, idx, w, table, n_fft, **kw)


def _block_render_cuda(xbs, idx, w, table: TorchTable, n_fft: int, *,
                       crossfade: bool, apply_itd: bool,
                       apply_ild: bool) -> torch.Tensor:
    if xbs.dtype != torch.float32:  # before the first launch
        raise TypeError(f"the CUDA route takes float32 blocks, got {xbs.dtype}")
    H = assemble_filters_cuda(idx, w, table, n_fft, apply_itd=apply_itd,
                              apply_ild=apply_ild)
    frames = block_spectra_mix_inverse_cuda(xbs, H, n_fft,
                                            crossfade=crossfade)
    return overlap_add_cuda(frames, xbs.shape[-1])


def _cuda_inputs(*tensors: torch.Tensor) -> int:
    """Check that kernel inputs are contiguous float32/int32 CUDA tensors
    on one device; → the stream handle to launch on."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel inputs must lie on one CUDA device, got {t.device}")
        if t.dtype not in (torch.float32, torch.int32, torch.complex64):
            raise TypeError(f"kernel inputs are float32/int32/complex64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return torch.cuda.current_stream(dev).cuda_stream


def assemble_filters_cuda(idx: torch.Tensor, w: torch.Tensor,
                          table: TorchTable, n_fft: int, *, apply_itd: bool,
                          apply_ild: bool) -> torch.Tensor:
    """Kernel `assemble_filters`: idx (S, nb, 4) int32, w (S, nb, 4) f32 →
    H (S, nb, 2, F) complex64."""
    from . import _build

    stream = _cuda_inputs(idx, w, table.h, table.delays, table.gains)
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError("idx must be int32 and w float32")
    if n_fft & (n_fft - 1) or not table.taps + DELAY_PAD <= n_fft <= MAX_N_FFT:
        raise ValueError(f"n_fft={n_fft} must be a power of two in "
                         f"[taps + {DELAY_PAD}, {MAX_N_FFT}]")
    rows = table.h.shape[0] * table.h.shape[1]
    if bool(((idx < 0) | (idx >= rows)).any()):
        raise ValueError(f"idx holds rows outside the table's {rows}")
    S, nb, _ = idx.shape
    H = torch.empty((S, nb, 2, n_fft // 2 + 1), dtype=torch.complex64,
                    device=idx.device)
    _build.check(_build.library().tt_assemble_filters(
        idx.data_ptr(), w.data_ptr(), table.h.data_ptr(),
        table.delays.data_ptr(), table.gains.data_ptr(), H.data_ptr(),
        S * nb, table.taps, table.taps + DELAY_PAD, n_fft, int(apply_itd),
        int(apply_ild), ALIGN_GUARD, MAX_RENDER_SHIFT, TAPER_LO, TAPER_HI,
        stream), "assemble_filters")
    launches["assemble_filters"] += 1
    return H


def block_spectra_mix_inverse_cuda(xbs: torch.Tensor, H: torch.Tensor,
                                   n_fft: int, *, crossfade: bool
                                   ) -> torch.Tensor:
    """Kernel `block_spectra_mix_inverse`: xbs (S, nb, B) f32, H (S, nb, 2,
    F) complex64 → frames (nb, 2, n_fft) f32."""
    from . import _build

    stream = _cuda_inputs(xbs, H)
    S, nb, B = xbs.shape
    if xbs.dtype != torch.float32 or H.dtype != torch.complex64:
        raise TypeError("xbs must be float32 and H complex64")
    if tuple(H.shape) != (S, nb, 2, n_fft // 2 + 1):
        raise ValueError(f"H must be ({S}, {nb}, 2, {n_fft // 2 + 1}), "
                         f"got {tuple(H.shape)}")
    if n_fft & (n_fft - 1) or not B <= n_fft <= MAX_N_FFT:
        raise ValueError(f"n_fft={n_fft} must be a power of two in "
                         f"[B, {MAX_N_FFT}]")
    frames = torch.empty((nb, 2, n_fft), dtype=torch.float32,
                         device=xbs.device)
    _build.check(_build.library().tt_block_spectra_mix_inverse(
        xbs.data_ptr(), H.data_ptr(), frames.data_ptr(), S, nb, B, n_fft,
        int(crossfade), stream), "block_spectra_mix_inverse")
    launches["block_spectra_mix_inverse"] += 1
    return frames


def overlap_add_cuda(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Kernel `overlap_add`: frames (nb, 2, n_fft) f32 → (2, (nb−1)·hop +
    n_fft) f32."""
    from . import _build

    stream = _cuda_inputs(frames)
    nb, ears, n_fft = frames.shape
    if frames.dtype != torch.float32 or ears != 2 or n_fft % hop:
        raise ValueError(f"frames must be float32 (nb, 2, n_fft) with n_fft "
                         f"a multiple of {hop}, got {tuple(frames.shape)}")
    out = torch.empty((2, (nb - 1) * hop + n_fft), dtype=torch.float32,
                      device=frames.device)
    _build.check(_build.library().tt_overlap_add(
        frames.data_ptr(), out.data_ptr(), nb, hop, n_fft, stream),
        "overlap_add")
    launches["overlap_add"] += 1
    return out


def assemble_filters_reference(idx, w, table: TorchTable, n_fft: int, *,
                               apply_itd: bool, apply_ild: bool
                               ) -> torch.Tensor:
    """Plain version of `assemble_filters`: (S, nb, 4) rows/weights →
    H (S, nb, 2, F) in w's precision."""
    h, d, g = gather_rows(table, idx, w, apply_itd=apply_itd,
                          apply_ild=apply_ild)
    return filter_spectrum_mm(h, d, g, table.taps, n_fft)


def block_spectra_mix_inverse_reference(xbs, H, n_fft: int, *,
                                        crossfade: bool) -> torch.Tensor:
    """Plain version of `block_spectra_mix_inverse`: xbs (S, nb, B) and
    H (S, nb, 2, F) → frames (nb, 2, n_fft)."""
    B = xbs.shape[-1]
    if crossfade:
        u = (torch.arange(B, dtype=xbs.dtype, device=xbs.device) + 0.5) / B
        Xu = torch.fft.rfft(xbs * u, n=n_fft)[:, :, None]
        Xd = torch.fft.rfft(xbs * (1.0 - u), n=n_fft)[:, :, None]
        Hp = torch.cat([H[:, :1], H[:, :-1]], dim=1)  # block 0: own filter
        Y = Xu * H + Xd * Hp
    else:
        Y = torch.fft.rfft(xbs, n=n_fft)[:, :, None] * H
    return torch.fft.irfft(Y.sum(0), n=n_fft)


def block_render_reference(xbs: torch.Tensor, idx: torch.Tensor,
                           w: torch.Tensor, table: TorchTable, n_fft: int, *,
                           crossfade: bool, apply_itd: bool,
                           apply_ild: bool) -> torch.Tensor:
    """`block_render` in plain torch, in xbs' precision (float32 or
    float64): gather → filter_spectrum_mm → rfft MAC → source sum → irfft
    → overlap_add."""
    H = assemble_filters_reference(idx, w.to(xbs.dtype), table, n_fft,
                                   apply_itd=apply_itd, apply_ild=apply_ild)
    frames = block_spectra_mix_inverse_reference(xbs, H, n_fft,
                                                 crossfade=crossfade)
    return overlap_add(frames.transpose(0, 1), xbs.shape[-1])

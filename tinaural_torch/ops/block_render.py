"""The single-launch block render: raw blocks in, overlap-added stereo out.

Counterpart of `tinaural.ops.pallas_kernels.fused_block_render` in its
in-kernel gather mode. Per source s and block b, with ``F = n_fft/2 + 1``:

1. gather: h, d, g = Σₖ wₖ·row[idxₖ] (delay ALIGN_GUARD without ITD, gain
   1 without ILD);
2. assembly: H[s,b] = rfft_nfft(effective_filter(h, d, g)) — (2, F);
3. crossfaded MAC: Y = rfft(x·u)·H[s,b] + rfft(x·(1−u))·H[s,b−1] with
   u = (i + 0.5)/B and H[s,−1] := H[s,0]; without crossfade Y = rfft(x)·H;
4. sum over sources, irfft per ear, overlap-add at hop B.

`block_render` launches the hand-written CUDA kernels
(``csrc/assemble_filters.cu``, ``csrc/block_mix_inverse.cu``,
``csrc/block_render.cu``) on CUDA tensors and calls the plain version,
`block_render_reference`, on CPU tensors; any other device raises. The
first two kernels have two buffer modes (``ops/_layout.py``): up to n_fft
16384 the shared mode, register-resident FFTs with one exchange buffer in
shared memory (their launch plans are ``ops/render_plan.py``); above, the
split mode, radix-2 FFTs over a device scratch. ``launches`` counts each
kernel's launches.
"""

from __future__ import annotations

import torch

from ..data.table import (ALIGN_GUARD, DELAY_PAD, MAX_RENDER_SHIFT,
                          TAPER_HI, TAPER_LO, TorchTable)
from ._layout import layout, sm_count
from .filters import effective_filter
from .interp import gather_rows
from .mac_plan import ramp_taper
from .ola import overlap_add
from .render_plan import MIN_MIX_N, filters_plan, mix_groups, mix_plan
from .spectra_inverse import twiddles

KERNELS = ("assemble_filters", "block_spectra_mix_inverse", "overlap_add")
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def _check_inputs(xbs, idx, w, table: TorchTable, n_fft: int, *,
                  one_filter_ok: bool = False) -> None:
    """Shapes, types and devices of a block render's inputs; with
    ``one_filter_ok`` idx and w may also hold one row set per source
    (S, 1, 4)."""
    if xbs.dim() != 3:
        raise ValueError(f"xbs must be (S, nb, B), got {tuple(xbs.shape)}")
    S, nb, B = xbs.shape
    shapes = {(S, nb, 4), (S, 1, 4)} if one_filter_ok else {(S, nb, 4)}
    for name, t in (("idx", idx), ("w", w)):
        if tuple(t.shape) not in shapes:
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
    (e·A_max + a), or (S, 1, 4): one direction per source; w of idx's
    shape, f32 → (2, (nb−1)·B + n_fft) f32, sources mixed down."""
    _check_inputs(xbs, idx, w, table, n_fft, one_filter_ok=True)
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
    shape = (*xbs.shape[:2], 4)  # the mix kernel reads a filter per block
    H = assemble_filters_cuda(idx.expand(shape).contiguous(),
                              w.expand(shape).contiguous(), table, n_fft,
                              apply_itd=apply_itd, apply_ild=apply_ild)
    frames = block_spectra_mix_inverse_cuda(xbs, H, n_fft,
                                            crossfade=crossfade)
    return overlap_add_cuda(frames[None], xbs.shape[-1])[0]


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
    if n_fft & (n_fft - 1) or n_fft < table.taps + DELAY_PAD:
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least "
                         f"taps + {DELAY_PAD}")
    rows = table.h.shape[0] * table.h.shape[1]
    if bool(((idx < 0) | (idx >= rows)).any()):
        raise ValueError(f"idx holds rows outside the table's {rows}")
    S, nb, _ = idx.shape
    H = torch.empty((S, nb, 2, n_fft // 2 + 1), dtype=torch.complex64,
                    device=idx.device)
    plan = filters_plan(table.taps, n_fft)
    *split, _keep = layout(idx.device, plan.shared_f2, plan.scratch_f2,
                           S * nb, n_fft)
    tables = (0, 0, 0) if split[1] else (
        twiddles(plan.L, idx.device).data_ptr(),
        twiddles(n_fft, idx.device).data_ptr(),
        ramp_taper(plan.L, idx.device).data_ptr())
    _build.check(_build.library().tt_assemble_filters(
        idx.data_ptr(), w.data_ptr(), table.h.data_ptr(),
        table.delays.data_ptr(), table.gains.data_ptr(), H.data_ptr(),
        *tables, S * nb, table.taps, plan.t_pad, n_fft, int(apply_itd),
        int(apply_ild), plan.threads, plan.rows_per_block,
        plan.blocks_per_sm, ALIGN_GUARD, MAX_RENDER_SHIFT, TAPER_LO,
        TAPER_HI, *split, stream), "assemble_filters")
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
    if n_fft & (n_fft - 1) or n_fft < max(B, MIN_MIX_N):
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least "
                         f"B={B} and {MIN_MIX_N}")
    frames = torch.empty((nb, 2, n_fft), dtype=torch.float32,
                         device=xbs.device)
    plan = mix_plan(n_fft)
    groups = mix_groups(S, nb, plan, sm_count(xbs.device))
    *split, _keep = layout(xbs.device, groups * plan.group_f2,
                           plan.scratch_f2, nb, n_fft)
    tw = 0 if split[1] else twiddles(n_fft, xbs.device).data_ptr()
    _build.check(_build.library().tt_block_spectra_mix_inverse(
        xbs.data_ptr(), H.data_ptr(), frames.data_ptr(), tw, S, nb, B, n_fft,
        int(crossfade), plan.threads, groups, plan.blocks_per_sm, *split,
        stream), "block_spectra_mix_inverse")
    launches["block_spectra_mix_inverse"] += 1
    return frames


def overlap_add_cuda(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Kernel `overlap_add`: frames (S, nb, 2, n_fft) f32 → (S, 2,
    (nb−1)·hop + n_fft) f32, each source's frames added on their own."""
    from . import _build

    stream = _cuda_inputs(frames)
    if (frames.dim() != 4 or frames.dtype != torch.float32
            or frames.shape[2] != 2 or frames.shape[3] % hop):
        raise ValueError(f"frames must be float32 (S, nb, 2, n_fft) with "
                         f"n_fft a multiple of {hop}, got "
                         f"{tuple(frames.shape)}")
    S, nb, _, n_fft = frames.shape
    out = torch.empty((S, 2, (nb - 1) * hop + n_fft), dtype=torch.float32,
                      device=frames.device)
    _build.check(_build.library().tt_overlap_add(
        frames.data_ptr(), out.data_ptr(), S, nb, hop, n_fft, stream),
        "overlap_add")
    launches["overlap_add"] += 1
    return out


def assemble_filters_reference(idx, w, table: TorchTable, n_fft: int, *,
                               apply_itd: bool, apply_ild: bool
                               ) -> torch.Tensor:
    """Plain version of `assemble_filters`: (S, nb, 4) rows/weights →
    H (S, nb, 2, F) in w's precision, through the kernel's FFT chain (the
    map of `filter_spectrum_mm`, whose dense matrices grow as taps·L)."""
    h, d, g = gather_rows(table, idx, w, apply_itd=apply_itd,
                          apply_ild=apply_ild)
    return torch.fft.rfft(effective_filter(h, d, g, table.taps), n=n_fft)


def block_spectra_mix_inverse_reference(xbs, H, n_fft: int, *,
                                        crossfade: bool) -> torch.Tensor:
    """Plain version of `block_spectra_mix_inverse`: xbs (S, nb, B) and
    H (S, nb, 2, F) → frames (nb, 2, n_fft)."""
    from .block_step import block_spectra_reference  # which imports this

    Y = block_spectra_reference(xbs, H, n_fft, crossfade=crossfade)
    return torch.fft.irfft(Y.sum(0), n=n_fft)


def block_render_reference(xbs: torch.Tensor, idx: torch.Tensor,
                           w: torch.Tensor, table: TorchTable, n_fft: int, *,
                           crossfade: bool, apply_itd: bool,
                           apply_ild: bool) -> torch.Tensor:
    """`block_render` in plain torch, in xbs' precision (float32 or
    float64): gather → effective filter → rfft MAC → source sum → irfft
    → overlap_add. One filter per source (idx (S, 1, 4)) serves all its
    blocks."""
    H = assemble_filters_reference(idx, w.to(xbs.dtype), table, n_fft,
                                   apply_itd=apply_itd, apply_ild=apply_ild)
    frames = block_spectra_mix_inverse_reference(xbs, H, n_fft,
                                                 crossfade=crossfade)
    return overlap_add(frames.transpose(0, 1), xbs.shape[-1])

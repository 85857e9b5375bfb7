"""The single-launch block render: raw blocks in, overlap-added stereo out.

Counterpart of `tinaural.ops.pallas_kernels.fused_block_render` in its
in-kernel gather mode, its ``dir_rate`` path included. With ``F = n_fft/2
+ 1`` and k = ``dir_rate``, the filters are one per group of k blocks:
idx and w hold ⌈nb/k⌉ rows per source, and block b takes row g(b) =
⌊b/k⌋ (k = 1: one filter per block; k ≥ nb: one per source). Per source
s and filter row j, then per block b:

1. gather: h, d, g = Σₖ wₖ·row[idxₖ] (delay ALIGN_GUARD without ITD, gain
   1 without ILD);
2. assembly: H[s,j] = rfft_nfft(effective_filter(h, d, g)) — (2, F);
3. crossfaded MAC: Y = rfft(x·u)·H[s,g(b)] + rfft(x·(1−u))·H[s,g(b−1)]
   with u = (i + 0.5)/B and block 0's previous filter its own; without
   crossfade Y = rfft(x)·H[s,g(b)];
4. sum over sources, irfft per ear, overlap-add at hop B.

On the track that `RenderConfig.dir_rate` snaps (block b at the direction
of block ⌊b/k⌋·k), rows [::k] of the per-block rows give the same output
at k as every row at k = 1, with k× fewer assemblies.

`block_render` launches the hand-written CUDA kernels
(``csrc/assemble_filters.cu``, ``csrc/block_mix_inverse.cu``,
``csrc/block_render.cu``) on CUDA tensors and calls the plain version,
`block_render_reference`, on CPU tensors; any other device raises. The
first two kernels have three buffer modes (``ops/_layout.py``; their
launch plans are ``ops/render_plan.py``): up to n_fft 16384 the shared
mode, register-resident FFTs with one exchange buffer in shared memory;
from 32768 to 131072 the cluster mode, each transform spread over a
thread-block cluster of n_fft/16384 blocks (`assemble_filters` only where
its L equals n_fft); at the shapes that remain — n_fft above 131072, and
`assemble_filters` with L < n_fft above 16384 (block 1024 at 15,298 …
16,320 taps) — the split mode, radix-2 FFTs over a device scratch. The
third, `overlap_add`, streams V outputs a thread (its plan is
``ops/ola_plan.py``). ``launches`` counts each kernel's launches.
"""

from __future__ import annotations

import torch

from ..data.table import (ALIGN_GUARD, DELAY_PAD, MAX_RENDER_SHIFT,
                          TAPER_HI, TAPER_LO, TorchTable)
from ..utils import profiling
from ._layout import (CLUSTER, SPLIT, check_inputs, cluster_slots,
                      cuda_inputs, filter_rows, layout, run_length, sm_count)
from .filters import effective_filter
from .interp import gather_rows
from .mac_plan import ramp_taper
from .ola import overlap_add
from .ola_plan import ALIGN_BYTES, check_rows, ola_plan
from .render_plan import MIN_MIX_N, filters_plan, mix_groups, mix_plan
from .spectra_inverse import MAX_REGISTER_N, twiddles

KERNELS = ("assemble_filters", "block_spectra_mix_inverse", "overlap_add")
launches = dict.fromkeys(KERNELS, 0)
profiling.register(launches)


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def block_render(xbs: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 table: TorchTable, n_fft: int, *, crossfade: bool,
                 apply_itd: bool, apply_ild: bool,
                 dir_rate: int = 1) -> torch.Tensor:
    """xbs (S, nb, B) f32; idx (S, ⌈nb/k⌉, 4) int32 flat table rows
    (e·A_max + a), one per group of k = ``dir_rate`` blocks; w of idx's
    shape, f32 → (2, (nb−1)·B + n_fft) f32, sources mixed down."""
    check_inputs(xbs, idx, w, table, n_fft, dir_rate)
    kw = dict(crossfade=crossfade, apply_itd=apply_itd, apply_ild=apply_ild,
              dir_rate=dir_rate)
    if xbs.device.type == "cpu":
        return block_render_reference(xbs, idx, w, table, n_fft, **kw)
    if xbs.device.type != "cuda":
        raise ValueError(f"block_render runs on cpu or cuda, not {xbs.device}")
    return _block_render_cuda(xbs, idx, w, table, n_fft, **kw)


def _block_render_cuda(xbs, idx, w, table: TorchTable, n_fft: int, *,
                       crossfade: bool, apply_itd: bool, apply_ild: bool,
                       dir_rate: int) -> torch.Tensor:
    if xbs.dtype != torch.float32:  # before the first launch
        raise TypeError(f"the CUDA route takes float32 blocks, got {xbs.dtype}")
    H = assemble_filters_cuda(idx, w, table, n_fft, apply_itd=apply_itd,
                              apply_ild=apply_ild)
    frames = block_spectra_mix_inverse_cuda(xbs, H, n_fft,
                                            crossfade=crossfade,
                                            dir_rate=dir_rate)
    return overlap_add_cuda(frames[None], xbs.shape[-1])[0]


def assemble_filters_cuda(idx: torch.Tensor, w: torch.Tensor,
                          table: TorchTable, n_fft: int, *, apply_itd: bool,
                          apply_ild: bool) -> torch.Tensor:
    """Kernel `assemble_filters`: idx (S, rows, 4) int32, w (S, rows, 4)
    f32 → H (S, rows, 2, F) complex64, one filter per row."""
    from . import _build

    stream = cuda_inputs(idx, w, table.h, table.delays, table.gains)
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError("idx must be int32 and w float32")
    if n_fft & (n_fft - 1) or n_fft < table.taps + DELAY_PAD:
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least "
                         f"taps + {DELAY_PAD}")
    rows = table.h.shape[0] * table.h.shape[1]
    profiling.count("host_syncs")  # the range check reads the card's answer
    if bool(((idx < 0) | (idx >= rows)).any()):
        raise ValueError(f"idx holds rows outside the table's {rows}")
    S, nb, _ = idx.shape
    H = torch.empty((S, nb, 2, n_fft // 2 + 1), dtype=torch.complex64,
                    device=idx.device)
    plan = filters_plan(table.taps, n_fft)
    lay = layout(idx.device, plan.body, plan.shared_f2, plan.scratch_f2,
                 S * nb, n_fft)
    run = 1
    if lay.mode == CLUSTER:  # a run per cluster, from the clusters at once
        run = run_length(S * nb, cluster_slots(
            idx.device, "tt_assemble_filters_clusters", n_fft))
    _build.check(_build.library().tt_assemble_filters(
        idx.data_ptr(), w.data_ptr(), table.h.data_ptr(),
        table.delays.data_ptr(), table.gains.data_ptr(), H.data_ptr(),
        *assembly_tables(lay.mode, plan.L, n_fft, idx.device), S * nb, run,
        table.taps, plan.t_pad, n_fft, int(apply_itd),
        int(apply_ild), plan.ranks, plan.threads, plan.rows_per_block,
        plan.blocks_per_sm, ALIGN_GUARD, MAX_RENDER_SHIFT, TAPER_LO,
        TAPER_HI, *lay.split_args, stream), "assemble_filters")
    launches["assemble_filters"] += 1
    return H


def assembly_tables(mode: str, L: int, n_fft: int,
                    device: torch.device) -> tuple[int, int, int, int]:
    """The tables `assemble_filters` and `assembly_mac` read in launch
    mode ``mode``: twiddles at L, at n_fft and (the cluster mode) at
    MAX_REGISTER_N, and the ramp's taper at L; none in the split mode."""
    if mode == SPLIT:
        return 0, 0, 0, 0
    return (twiddles(L, device).data_ptr(), twiddles(n_fft, device).data_ptr(),
            twiddles(MAX_REGISTER_N, device).data_ptr()
            if mode == CLUSTER else 0, ramp_taper(L, device).data_ptr())


def block_spectra_mix_inverse_cuda(xbs: torch.Tensor, H: torch.Tensor,
                                   n_fft: int, *, crossfade: bool,
                                   dir_rate: int = 1) -> torch.Tensor:
    """Kernel `block_spectra_mix_inverse`: xbs (S, nb, B) f32, H (S,
    ⌈nb/k⌉, 2, F) complex64, block b's filter row ⌊b/k⌋ with k =
    ``dir_rate`` → frames (nb, 2, n_fft) f32."""
    from . import _build

    stream = cuda_inputs(xbs, H)
    S, nb, B = xbs.shape
    if xbs.dtype != torch.float32 or H.dtype != torch.complex64:
        raise TypeError("xbs must be float32 and H complex64")
    want = (S, filter_rows(nb, dir_rate), 2, n_fft // 2 + 1)
    if tuple(H.shape) != want:
        raise ValueError(f"H must be {want} at dir_rate={dir_rate}, got "
                         f"{tuple(H.shape)}")
    if n_fft & (n_fft - 1) or n_fft < max(B, MIN_MIX_N):
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least "
                         f"B={B} and {MIN_MIX_N}")
    frames = torch.empty((nb, 2, n_fft), dtype=torch.float32,
                         device=xbs.device)
    plan = mix_plan(n_fft)
    groups = mix_groups(S, nb, plan, sm_count(xbs.device))
    lay = layout(xbs.device, plan.body, groups * plan.group_f2,
                 plan.scratch_f2, nb, n_fft)
    tables = (0, 0) if lay.mode == SPLIT else (
        twiddles(n_fft, xbs.device).data_ptr(),
        twiddles(MAX_REGISTER_N, xbs.device).data_ptr()
        if lay.mode == CLUSTER else 0)
    _build.check(_build.library().tt_block_spectra_mix_inverse(
        xbs.data_ptr(), H.data_ptr(), frames.data_ptr(), *tables, S, nb, B,
        n_fft, int(crossfade), dir_rate, plan.ranks, plan.threads, groups,
        plan.blocks_per_sm, *lay.split_args, stream),
        "block_spectra_mix_inverse")
    launches["block_spectra_mix_inverse"] += 1
    return frames


def overlap_add_cuda(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Kernel `overlap_add`: frames (S, nb, 2, n_fft) f32 → (S, 2,
    (nb−1)·hop + n_fft) f32, each source's frames added on their own, equal
    in bits to the plain `overlap_add`. hop is a power of two dividing
    n_fft; a row of 2^31 samples or more raises (``ops/ola_plan.py``)."""
    from . import _build

    if (frames.dim() != 4 or frames.dtype != torch.float32
            or frames.shape[2] != 2 or frames.shape[3] % hop):
        raise ValueError(f"frames must be float32 (S, nb, 2, n_fft) with "
                         f"n_fft a multiple of {hop}, got "
                         f"{tuple(frames.shape)}")
    S, nb, _, n_fft = frames.shape
    out_len = check_rows(S, nb, hop, n_fft)  # from the shape alone
    stream = cuda_inputs(frames)
    out = torch.empty((S, 2, out_len), dtype=torch.float32,
                      device=frames.device)
    aligned = (frames.data_ptr() % ALIGN_BYTES == 0
               and out.data_ptr() % ALIGN_BYTES == 0)
    plan = ola_plan(S, nb, hop, n_fft, aligned)
    _build.check(_build.library().tt_overlap_add(
        frames.data_ptr(), out.data_ptr(), S, nb, hop, n_fft, plan.vec,
        plan.grid[0], stream), "overlap_add")
    launches["overlap_add"] += 1
    return out


def assemble_filters_reference(idx, w, table: TorchTable, n_fft: int, *,
                               apply_itd: bool, apply_ild: bool
                               ) -> torch.Tensor:
    """Plain version of `assemble_filters`: (S, rows, 4) rows/weights →
    H (S, rows, 2, F) in w's precision, through the kernel's FFT chain (the
    map of `filter_spectrum_mm`, whose dense matrices grow as taps·L)."""
    h, d, g = gather_rows(table, idx, w, apply_itd=apply_itd,
                          apply_ild=apply_ild)
    return torch.fft.rfft(effective_filter(h, d, g, table.taps), n=n_fft)


def block_spectra_reference(xbs: torch.Tensor, H: torch.Tensor, n_fft: int,
                            *, crossfade: bool,
                            dir_rate: int = 1) -> torch.Tensor:
    """Plain version of `block_spectra` (``ops/block_step.py``), in xbs'
    precision: xbs (S, nb, B), H (S, ⌈nb/k⌉, 2, F) → Y (S, nb, 2, F),
    block b under H[:, ⌊b/k⌋] and, crossfading, H[:, ⌊(b−1)/k⌋] (block
    0: its own)."""
    nb, B = xbs.shape[-2:]
    b = torch.arange(nb, device=xbs.device)
    Hc = H[:, b // dir_rate]
    if not crossfade:
        return torch.fft.rfft(xbs, n=n_fft)[:, :, None] * Hc
    u = (torch.arange(B, dtype=xbs.dtype, device=xbs.device) + 0.5) / B
    Xu = torch.fft.rfft(xbs * u, n=n_fft)[:, :, None]
    Xd = torch.fft.rfft(xbs * (1.0 - u), n=n_fft)[:, :, None]
    Hp = H[:, (b - 1).clamp(min=0) // dir_rate]
    return Xu * Hc + Xd * Hp


def block_spectra_mix_inverse_reference(xbs, H, n_fft: int, *,
                                        crossfade: bool,
                                        dir_rate: int = 1) -> torch.Tensor:
    """Plain version of `block_spectra_mix_inverse`: xbs (S, nb, B) and
    H (S, ⌈nb/k⌉, 2, F) → frames (nb, 2, n_fft)."""
    Y = block_spectra_reference(xbs, H, n_fft, crossfade=crossfade,
                                dir_rate=dir_rate)
    return torch.fft.irfft(Y.sum(0), n=n_fft)


def block_render_reference(xbs: torch.Tensor, idx: torch.Tensor,
                           w: torch.Tensor, table: TorchTable, n_fft: int, *,
                           crossfade: bool, apply_itd: bool,
                           apply_ild: bool, dir_rate: int = 1
                           ) -> torch.Tensor:
    """`block_render` in plain torch, in xbs' precision (float32 or
    float64): gather → effective filter per row → rfft MAC, block b under
    row ⌊b/dir_rate⌋ → source sum → irfft → overlap_add."""
    H = assemble_filters_reference(idx, w.to(xbs.dtype), table, n_fft,
                                   apply_itd=apply_itd, apply_ild=apply_ild)
    frames = block_spectra_mix_inverse_reference(xbs, H, n_fft,
                                                 crossfade=crossfade,
                                                 dir_rate=dir_rate)
    return overlap_add(frames.transpose(0, 1), xbs.shape[-1])

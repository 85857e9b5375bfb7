"""The natural-order route: input block spectra from `torch.fft`, then each
row's filter assembled and used in the MAC in one kernel, then the inverse
and an overlap-add per source.

Counterpart of `tinaural.ops.pallas_kernels.fused_assembly_mac` and of the
JAX package's route around it (`_rfft_updown`,
`_trajectory_spectra_batched`, `_epilogue_batched`). Per row r of the
flattened (source, block) axis, with ``F = n_fft/2 + 1``:

1. Xu = rfft(x·u), Xd = rfft(x·(1−u)) with u = (i + 0.5)/B, or X = rfft(x)
   without crossfade — `torch.fft`, outside the kernel, as the JAX route
   runs them in XLA outside its Pallas kernel;
2. kernel `assembly_mac`: H[r] = rfft_nfft(effective_filter(gather(idx,
   w))) and Y[r] = Xu·H[r] + Xd·H_prev[r], H_prev = H[r−1], or H[r] where
   `first` marks row r (each source's block 0; row 0 always); without
   crossfade Y = Xu·H[r]. Up to n_fft 16384 the kernel keeps each row's
   transforms in registers and H never reaches device memory (its launch
   plan is ``ops/mac_plan.py``); at n_fft 32768 … 131072 with L == n_fft a
   thread-block cluster takes each run of rows (the cluster mode); at
   other shapes above 16384 its buffers live in a device scratch;
3. kernel `spectra_inverse` and the per-source `overlap_add`
   (``ops/block_step.py``, ``ops/block_render.py``) → (S, 2, out).

The route takes the block routes' ``dir_rate`` rows (one per group of k
blocks) and hands the kernel one row per block, row ⌊b/k⌋ of its source's:
the kernel assembles each row's filter inside its MAC, so a filter that k
blocks share is assembled for each of them, as the JAX package's route
runs `fused_assembly_mac` on the snapped track.

`assembly_mac_render` launches the hand-written CUDA kernels on CUDA
tensors and runs the plain versions on CPU tensors; any other device
raises. ``launches`` counts this module's kernel. On either device the
render records span ``tt.input_spectra`` around step 1 and span
``tt.epilogue`` around step 3 (children of the caller's ``tt.route``), and
adds the rows step 2 assembles and multiplies, S·nb at every
``dir_rate``, to counter ``mac_rows``.
"""

from __future__ import annotations

import torch

from ..data.table import (ALIGN_GUARD, DELAY_PAD, MAX_RENDER_SHIFT,
                          TAPER_HI, TAPER_LO, TorchTable)
from ..utils import profiling
from . import _layout
from ._layout import layout, run_length, sm_count
from .block_render import (_check_inputs, _cuda_inputs,
                           assemble_filters_reference, overlap_add_cuda)
from .block_step import spectra_inverse_cuda, spectra_inverse_reference
from .mac_plan import mac_plan, ramp_taper
from .ola import overlap_add
from .spectra_inverse import MAX_REGISTER_N, twiddles

KERNELS = ("assembly_mac",)
launches = dict.fromkeys(KERNELS, 0)
profiling.register(launches)


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def assembly_mac_render(xbs: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor, table: TorchTable, n_fft: int, *,
                        crossfade: bool, apply_itd: bool, apply_ild: bool,
                        dir_rate: int = 1) -> torch.Tensor:
    """xbs (S, nb, B) f32; idx (S, ⌈nb/k⌉, 4) int32 flat table rows, one
    per group of k = ``dir_rate`` blocks; w of idx's shape → (S, 2,
    (nb−1)·B + n_fft) f32, one render per source."""
    _check_inputs(xbs, idx, w, table, n_fft, dir_rate)
    kw = dict(crossfade=crossfade, apply_itd=apply_itd, apply_ild=apply_ild)
    if xbs.device.type == "cpu":
        return assembly_mac_render_reference(xbs, idx, w, table, n_fft,
                                             dir_rate=dir_rate, **kw)
    if xbs.device.type != "cuda":
        raise ValueError(f"assembly_mac_render runs on cpu or cuda, not {xbs.device}")
    if xbs.dtype != torch.float32:  # before the first launch
        raise TypeError(f"the CUDA route takes float32 blocks, got {xbs.dtype}")
    S, nb, B = xbs.shape
    with profiling.span("tt.input_spectra"):
        Xu, Xd = _input_spectra(xbs, n_fft, crossfade)
    profiling.count("mac_rows", S * nb)
    Y = assembly_mac_cuda(_block_rows(idx, nb, dir_rate),
                          _block_rows(w, nb, dir_rate), table, Xu, Xd,
                          _first_rows(S, nb, xbs.device), n_fft, **kw)
    with profiling.span("tt.epilogue"):
        frames = spectra_inverse_cuda(Y.reshape(S, nb, 2, -1), n_fft)
        return overlap_add_cuda(frames, B)


def assembly_mac_render_reference(xbs: torch.Tensor, idx: torch.Tensor,
                                  w: torch.Tensor, table: TorchTable,
                                  n_fft: int, *, crossfade: bool,
                                  apply_itd: bool, apply_ild: bool,
                                  dir_rate: int = 1) -> torch.Tensor:
    """`assembly_mac_render` in plain torch, in xbs' precision (float32 or
    float64)."""
    S, nb, B = xbs.shape
    with profiling.span("tt.input_spectra"):
        Xu, Xd = _input_spectra(xbs, n_fft, crossfade)
    profiling.count("mac_rows", S * nb)
    Y = assembly_mac_reference(_block_rows(idx, nb, dir_rate),
                               _block_rows(w, nb, dir_rate).to(xbs.dtype),
                               table, Xu, Xd, _first_rows(S, nb, xbs.device),
                               n_fft, crossfade=crossfade,
                               apply_itd=apply_itd, apply_ild=apply_ild)
    with profiling.span("tt.epilogue"):
        frames = spectra_inverse_reference(Y.reshape(S, nb, 2, -1), n_fft)
        return overlap_add(frames.transpose(1, 2), B)


def _block_rows(t: torch.Tensor, nb: int, dir_rate: int) -> torch.Tensor:
    """(S, ⌈nb/k⌉, 4) rows of groups of k = dir_rate blocks → (S·nb, 4),
    block b's the row ⌊b/k⌋ of its source's."""
    b = torch.arange(nb, device=t.device) // dir_rate
    return t[:, b].reshape(-1, 4)


def _input_spectra(xbs: torch.Tensor, n_fft: int, crossfade: bool):
    """(S·nb, F) spectra of the up- and down-ramped blocks, or of the
    blocks twice without crossfade (the kernel then reads Xu only)."""
    S, nb, B = xbs.shape
    x = xbs.reshape(S * nb, B)
    if not crossfade:
        X = torch.fft.rfft(x, n=n_fft)
        return X, X
    u = (torch.arange(B, dtype=x.dtype, device=x.device) + 0.5) / B
    X = torch.fft.rfft(torch.stack([x * u, x * (1.0 - u)]), n=n_fft)
    return X[0], X[1]


def _first_rows(S: int, nb: int, device: torch.device) -> torch.Tensor:
    """1.0 at each source's block 0 of the flattened rows, else 0.0."""
    first = torch.zeros((S, nb), dtype=torch.float32, device=device)
    first[:, 0] = 1.0
    return first.reshape(S * nb)


def assembly_mac_cuda(idx: torch.Tensor, w: torch.Tensor, table: TorchTable,
                      Xu: torch.Tensor, Xd: torch.Tensor, first: torch.Tensor,
                      n_fft: int, *, crossfade: bool, apply_itd: bool,
                      apply_ild: bool) -> torch.Tensor:
    """Kernel `assembly_mac`: idx (rows, 4) int32 flat table rows
    (unchecked: a range check would synchronise the host), w (rows, 4)
    f32, Xu and Xd (rows, F) complex64 (Xd unread without crossfade),
    first (rows,) f32 (row 0 counts as first whatever it holds) → Y (rows,
    2, F) complex64."""
    from . import _build

    stream = _cuda_inputs(idx, w, table.h, table.delays, table.gains, Xu, Xd,
                          first)
    if (idx.dtype != torch.int32 or w.dtype != torch.float32
            or first.dtype != torch.float32):
        raise TypeError("idx must be int32, w and first float32")
    if Xu.dtype != torch.complex64 or Xd.dtype != torch.complex64:
        raise TypeError("Xu and Xd must be complex64")
    rows, F = Xu.shape[0], n_fft // 2 + 1
    for name, t, want in (("idx", idx, (rows, 4)), ("w", w, (rows, 4)),
                          ("Xu", Xu, (rows, F)), ("Xd", Xd, (rows, F)),
                          ("first", first, (rows,))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    if rows == 0 or n_fft & (n_fft - 1) or n_fft < table.taps + DELAY_PAD:
        raise ValueError(f"assembly_mac needs rows and n_fft={n_fft} a power "
                         f"of two of at least taps + {DELAY_PAD}")
    Y = torch.empty((rows, 2, F), dtype=torch.complex64, device=idx.device)
    plan = mac_plan(table.taps, n_fft)
    run = run_length(rows, sm_count(idx.device) * plan.blocks_per_sm)
    *split, _keep = layout(idx.device, plan.shared_f2, plan.scratch_f2,
                           -(-rows // run), n_fft)
    cluster = plan.cluster and not split[1]
    if cluster:  # a run per cluster, from the clusters that run at once
        run = run_length(rows, _layout.cluster_slots(
            idx.device, "tt_assembly_mac_clusters", n_fft))
    tables = (0, 0, 0, 0) if split[1] else (
        twiddles(plan.L, idx.device).data_ptr(),
        twiddles(n_fft, idx.device).data_ptr(),
        twiddles(MAX_REGISTER_N, idx.device).data_ptr() if cluster else 0,
        ramp_taper(plan.L, idx.device).data_ptr())
    _build.check(_build.library().tt_assembly_mac(
        idx.data_ptr(), w.data_ptr(), table.h.data_ptr(),
        table.delays.data_ptr(), table.gains.data_ptr(), Xu.data_ptr(),
        Xd.data_ptr(), first.data_ptr(), Y.data_ptr(), *tables, rows, run,
        table.taps, plan.t_pad, n_fft, int(crossfade), int(apply_itd),
        int(apply_ild), plan.ranks, plan.threads, plan.blocks_per_sm,
        ALIGN_GUARD, MAX_RENDER_SHIFT, TAPER_LO, TAPER_HI, *split, stream),
        "assembly_mac")
    launches["assembly_mac"] += 1
    return Y


def assembly_mac_reference(idx: torch.Tensor, w: torch.Tensor,
                           table: TorchTable, Xu: torch.Tensor,
                           Xd: torch.Tensor, first: torch.Tensor, n_fft: int,
                           *, crossfade: bool, apply_itd: bool,
                           apply_ild: bool) -> torch.Tensor:
    """Plain version of `assembly_mac`, in w's precision: (rows, 4) rows
    and weights, (rows, F) spectra, (rows,) first → Y (rows, 2, F)."""
    H = assemble_filters_reference(idx, w, table, n_fft, apply_itd=apply_itd,
                                   apply_ild=apply_ild)  # (rows, 2, F)
    Y = Xu[:, None] * H
    if not crossfade:
        return Y
    own = first > 0.5
    own[0] = True  # row 0 has no predecessor
    Hp = torch.where(own[:, None, None], H, torch.cat([H[:1], H[:-1]]))
    return Y + Xd[:, None] * Hp

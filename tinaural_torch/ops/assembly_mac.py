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
   plan is ``ops/mac_plan.py``); above, its buffers live in a device
   scratch;
3. kernel `spectra_inverse` and the per-source `overlap_add`
   (``ops/block_step.py``, ``ops/block_render.py``) → (S, 2, out).

`assembly_mac_render` launches the hand-written CUDA kernels on CUDA
tensors and runs the plain versions on CPU tensors; any other device
raises. ``launches`` counts this module's kernel.
"""

from __future__ import annotations

import torch

from ..data.table import (ALIGN_GUARD, DELAY_PAD, MAX_RENDER_SHIFT,
                          TAPER_HI, TAPER_LO, TorchTable)
from ._layout import layout, sm_count
from .block_render import (_check_inputs, _cuda_inputs,
                           assemble_filters_reference, overlap_add_cuda)
from .block_step import spectra_inverse_cuda, spectra_inverse_reference
from .mac_plan import mac_plan, ramp_taper
from .ola import overlap_add
from .spectra_inverse import twiddles

KERNELS = ("assembly_mac",)
launches = dict.fromkeys(KERNELS, 0)
# A run of c rows assembles c + 1 filters (its predecessor too), and every
# run takes the same time, so the runs are as long as leave RUN_WAVES runs
# for each block the card holds at once.
RUN_WAVES = 1


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def run_length(rows: int, slots: int) -> int:
    """Rows per CUDA block of `assembly_mac` when ``slots`` blocks run at
    once (the SMs times the plan's blocks per SM): the shortest run that
    needs no more than RUN_WAVES · slots runs, so 1 + 1/run assemblies per
    row remain."""
    return -(-rows // (RUN_WAVES * max(slots, 1)))


def assembly_mac_render(xbs: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor, table: TorchTable, n_fft: int, *,
                        crossfade: bool, apply_itd: bool,
                        apply_ild: bool) -> torch.Tensor:
    """xbs (S, nb, B) f32; idx (S, nb, 4) int32 flat table rows; w (S, nb,
    4) → (S, 2, (nb−1)·B + n_fft) f32, one render per source."""
    _check_inputs(xbs, idx, w, table, n_fft)
    kw = dict(crossfade=crossfade, apply_itd=apply_itd, apply_ild=apply_ild)
    if xbs.device.type == "cpu":
        return assembly_mac_render_reference(xbs, idx, w, table, n_fft, **kw)
    if xbs.device.type != "cuda":
        raise ValueError(f"assembly_mac_render runs on cpu or cuda, not {xbs.device}")
    if xbs.dtype != torch.float32:  # before the first launch
        raise TypeError(f"the CUDA route takes float32 blocks, got {xbs.dtype}")
    S, nb, B = xbs.shape
    Xu, Xd = _input_spectra(xbs, n_fft, crossfade)
    Y = assembly_mac_cuda(idx.reshape(S * nb, 4), w.reshape(S * nb, 4), table,
                          Xu, Xd, _first_rows(S, nb, xbs.device), n_fft, **kw)
    frames = spectra_inverse_cuda(Y.reshape(S, nb, 2, -1), n_fft)
    return overlap_add_cuda(frames, B)


def assembly_mac_render_reference(xbs: torch.Tensor, idx: torch.Tensor,
                                  w: torch.Tensor, table: TorchTable,
                                  n_fft: int, *, crossfade: bool,
                                  apply_itd: bool,
                                  apply_ild: bool) -> torch.Tensor:
    """`assembly_mac_render` in plain torch, in xbs' precision (float32 or
    float64)."""
    S, nb, B = xbs.shape
    Xu, Xd = _input_spectra(xbs, n_fft, crossfade)
    Y = assembly_mac_reference(idx.reshape(S * nb, 4),
                               w.reshape(S * nb, 4).to(xbs.dtype), table, Xu,
                               Xd, _first_rows(S, nb, xbs.device), n_fft,
                               crossfade=crossfade, apply_itd=apply_itd,
                               apply_ild=apply_ild)
    frames = spectra_inverse_reference(Y.reshape(S, nb, 2, -1), n_fft)
    return overlap_add(frames.transpose(1, 2), B)


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
    tables = (0, 0, 0) if split[1] else (
        twiddles(plan.L, idx.device).data_ptr(),
        twiddles(n_fft, idx.device).data_ptr(),
        ramp_taper(plan.L, idx.device).data_ptr())
    _build.check(_build.library().tt_assembly_mac(
        idx.data_ptr(), w.data_ptr(), table.h.data_ptr(),
        table.delays.data_ptr(), table.gains.data_ptr(), Xu.data_ptr(),
        Xd.data_ptr(), first.data_ptr(), Y.data_ptr(), *tables, rows, run,
        table.taps, plan.t_pad, n_fft, int(crossfade), int(apply_itd),
        int(apply_ild), plan.threads, plan.blocks_per_sm, ALIGN_GUARD,
        MAX_RENDER_SHIFT, TAPER_LO, TAPER_HI, *split, stream), "assembly_mac")
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

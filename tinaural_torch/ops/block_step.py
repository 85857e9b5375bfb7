"""The two-launch block render: block spectra per (source, block), their
inverse, and an overlap-add per source, with no mixdown; and the scene
render that mixes the block spectra over sources before the inverse.

Counterpart of `tinaural.ops.pallas_kernels`' `fused_block_step` (forward
FFT, filter assembly, crossfaded MAC → block spectra),
`fused_block_step_mix` (the same, accumulated over sources) and
`fused_epilogue` (inverse FFT of both ears, OLA that never crosses a source
boundary). With ``F = n_fft/2 + 1``, k = ``dir_rate`` and g(b) = ⌊b/k⌋
(one filter per group of k blocks, as `ops/block_render.py` says; k ≥ nb
is one filter per source), per source s:

1. kernel `assemble_filters` (``ops/block_render.py``): H[s,j] =
   rfft_nfft(effective_filter(gather(idx, w))) for each of the ⌈nb/k⌉
   rows j;
2. kernel `block_spectra`: Y[s,b] = rfft(x·u)·H[s,g(b)] + rfft(x·(1−u))·
   H[s,g(b−1)] with u = (i + 0.5)/B and block 0's previous filter its
   own; without crossfade Y = rfft(x)·H[s,g(b)];
3. kernel `spectra_inverse`: frames[s,b] = irfft(Y[s,b]) per ear;
4. kernel `overlap_add` (``ops/block_render.py``) at hop B within each
   source → (S, 2, (nb−1)·B + n_fft).

`scene_step_render` mixes instead: step 2 runs as kernel
`block_spectra_mix`, which sums Y[s,b] over chunks of sources into partials
P[c,b], and `spectra_inverse` adds the C partials of each block in order
before its inverse; step 4 then has one source. It is the port of
`_scene_spectra_fused` + `_fused_ola_from_planes` (S = 1).

`block_step_render` and `scene_step_render` launch the hand-written CUDA
kernels of ``csrc/assemble_filters.cu``, ``csrc/block_step.cu``,
``csrc/spectra_inverse.cu`` and ``csrc/block_render.cu`` on CUDA tensors
and run the plain versions on CPU tensors; any other device raises. The
kernels take every FFT size (``ops/_layout.py``): `block_spectra` and
`block_spectra_mix` run register bodies at n_fft 128 … 16384, pruned
bodies above (P transforms of Q = max(next_pow2(B), 128) ≤ 16384 points
of the pre-twiddled block) and radix-2 bodies elsewhere, their launches
planned by ``ops/step_plan.py``.
``launches`` counts the three kernels of this module.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from ._layout import layout, sm_count
from .block_render import (_check_inputs, _cuda_inputs,
                           assemble_filters_cuda, assemble_filters_reference,
                           block_render_reference, filter_rows,
                           overlap_add_cuda)
from .ola import overlap_add
from .spectra_inverse import MAX_REGISTER_N, inverse_plan, twiddles
from .step_plan import (PrunedPlan, mix_groups, mix_launch, pruned_plan,
                        radix2_plan, spectra_rows, step_plan)

KERNELS = ("block_spectra", "spectra_inverse", "block_spectra_mix")
launches = dict.fromkeys(KERNELS, 0)
profiling.register(launches)


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def block_step_render(xbs: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      table, n_fft: int, *, crossfade: bool, apply_itd: bool,
                      apply_ild: bool, dir_rate: int = 1) -> torch.Tensor:
    """xbs (S, nb, B) f32; idx (S, ⌈nb/k⌉, 4) int32 flat table rows
    (e·A_max + a), one per group of k = ``dir_rate`` blocks; w the weights
    of idx's shape → (S, 2, (nb−1)·B + n_fft) f32, one render per
    source."""
    _check_inputs(xbs, idx, w, table, n_fft, dir_rate)
    kw = dict(crossfade=crossfade, apply_itd=apply_itd, apply_ild=apply_ild,
              dir_rate=dir_rate)
    if xbs.device.type == "cpu":
        return block_step_render_reference(xbs, idx, w, table, n_fft, **kw)
    if xbs.device.type != "cuda":
        raise ValueError(f"block_step_render runs on cpu or cuda, not {xbs.device}")
    if xbs.dtype != torch.float32:  # before the first launch
        raise TypeError(f"the CUDA route takes float32 blocks, got {xbs.dtype}")
    H = assemble_filters_cuda(idx, w, table, n_fft, apply_itd=apply_itd,
                              apply_ild=apply_ild)
    Y = block_spectra_cuda(xbs, H, n_fft, crossfade=crossfade,
                           dir_rate=dir_rate)
    return overlap_add_cuda(spectra_inverse_cuda(Y, n_fft), xbs.shape[-1])


def block_step_render_reference(xbs: torch.Tensor, idx: torch.Tensor,
                                w: torch.Tensor, table, n_fft: int, *,
                                crossfade: bool, apply_itd: bool,
                                apply_ild: bool, dir_rate: int = 1
                                ) -> torch.Tensor:
    """`block_step_render` in plain torch, in xbs' precision (float32 or
    float64)."""
    H = assemble_filters_reference(idx, w.to(xbs.dtype), table, n_fft,
                                   apply_itd=apply_itd, apply_ild=apply_ild)
    Y = block_spectra_reference(xbs, H, n_fft, crossfade=crossfade,
                                dir_rate=dir_rate)
    frames = spectra_inverse_reference(Y, n_fft)  # (S, nb, 2, n_fft)
    return overlap_add(frames.transpose(1, 2), xbs.shape[-1])


def scene_step_render(xbs: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      table, n_fft: int, *, crossfade: bool, apply_itd: bool,
                      apply_ild: bool, dir_rate: int = 1) -> torch.Tensor:
    """xbs (S, nb, B) f32; idx (S, ⌈nb/k⌉, 4) int32 flat table rows, one
    per group of k = ``dir_rate`` blocks; w the weights of idx's shape →
    (2, (nb−1)·B + n_fft) f32, the sources mixed down."""
    _check_inputs(xbs, idx, w, table, n_fft, dir_rate)
    kw = dict(crossfade=crossfade, apply_itd=apply_itd, apply_ild=apply_ild,
              dir_rate=dir_rate)
    if xbs.device.type == "cpu":
        return scene_step_render_reference(xbs, idx, w, table, n_fft, **kw)
    if xbs.device.type != "cuda":
        raise ValueError(f"scene_step_render runs on cpu or cuda, not {xbs.device}")
    if xbs.dtype != torch.float32:  # before the first launch
        raise TypeError(f"the CUDA route takes float32 blocks, got {xbs.dtype}")
    S, nb, B = xbs.shape
    H = assemble_filters_cuda(idx, w, table, n_fft, apply_itd=apply_itd,
                              apply_ild=apply_ild)
    P = block_spectra_mix_cuda(
        xbs, H, n_fft, crossfade=crossfade,
        chunk=mix_chunk(S, nb, n_fft, sm_count(xbs.device), B, crossfade),
        dir_rate=dir_rate)
    frames = spectra_inverse_cuda(P, n_fft, summed=True)
    return overlap_add_cuda(frames[None], B)[0]


# `scene_step_render` in plain torch is B1's plain version: the same map
# (block spectra summed over sources, irfft, overlap-add), in xbs'
# precision, at any dir_rate.
scene_step_render_reference = block_render_reference


def mix_chunk(S: int, nb: int, n_fft: int, sms: int, B: int,
              crossfade: bool) -> int:
    """Sources per chunk of `block_spectra_mix` (C = ⌈S/chunk⌉ partials)
    over blocks of B samples, with or without ``crossfade``: the chunk of
    ``ops/step_plan.py`` `mix_launch`, which
    picks it with the groups per CUDA block from the kernel's occupancy on
    a card of ``sms`` SMs (one chunk with no card)."""
    return mix_launch(S, nb, n_fft, sms, B, crossfade)[0]


def _check_spectra_inputs(xbs: torch.Tensor, H: torch.Tensor, n_fft: int,
                          dir_rate: int) -> tuple[int, int, int, int]:
    """Types and shapes of a block-spectra kernel's inputs → (S, nb, B, F)."""
    if xbs.dtype != torch.float32 or H.dtype != torch.complex64:
        raise TypeError("xbs must be float32 and H complex64")
    if xbs.dim() != 3:
        raise ValueError(f"xbs must be (S, nb, B), got {tuple(xbs.shape)}")
    S, nb, B = xbs.shape
    F = n_fft // 2 + 1
    want = (S, filter_rows(nb, dir_rate), 2, F)
    if tuple(H.shape) != want:
        raise ValueError(f"H must be {want} at dir_rate={dir_rate}, got "
                         f"{tuple(H.shape)}")
    if n_fft & (n_fft - 1) or n_fft < B:
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least "
                         f"B={B}")
    return S, nb, B, F


def block_spectra_cuda(xbs: torch.Tensor, H: torch.Tensor, n_fft: int, *,
                       crossfade: bool, dir_rate: int = 1) -> torch.Tensor:
    """Kernel `block_spectra`: xbs (S, nb, B) f32, H (S, ⌈nb/k⌉, 2, F)
    complex64, block b's filter row ⌊b/k⌋ with k = ``dir_rate`` → Y (S,
    nb, 2, F) complex64. Its launch: ``ops/step_plan.py``."""
    from . import _build

    stream = _cuda_inputs(xbs, H)
    S, nb, B, F = _check_spectra_inputs(xbs, H, n_fft, dir_rate)
    Y = torch.empty((S, nb, 2, F), dtype=torch.complex64, device=xbs.device)
    plan = pruned_plan(n_fft, False, B)
    if plan is not None:
        G, shared = plan.residues, plan.shared_f2
    else:
        plan = step_plan(n_fft, False)
        G = spectra_rows(plan, S * nb, sm_count(xbs.device))
        shared = plan.shared_f2(G)
    *split, _keep = layout(xbs.device, shared, plan.scratch_f2, S * nb, n_fft)
    if split[1]:
        plan, G = radix2_plan(n_fft, False), 1
    tw, twq = _tables(plan, n_fft, xbs.device)
    _build.check(_build.library().tt_block_spectra(
        xbs.data_ptr(), H.data_ptr(), Y.data_ptr(), tw, twq, S, nb, B, n_fft,
        dir_rate, int(crossfade), plan.threads, G, plan.blocks_per_sm,
        *split, stream), "block_spectra")
    launches["block_spectra"] += 1
    return Y


def block_spectra_mix_cuda(xbs: torch.Tensor, H: torch.Tensor, n_fft: int,
                           *, crossfade: bool, chunk: int,
                           dir_rate: int = 1) -> torch.Tensor:
    """Kernel `block_spectra_mix`: xbs (S, nb, B) f32, H (S, ⌈nb/k⌉, 2,
    F) complex64 as in `block_spectra_cuda` → partials P (⌈S/chunk⌉, nb, 2,
    F) complex64, P[c] the block spectra of sources c·chunk … (c+1)·chunk
    − 1 summed. Its launch (groups per block): ``ops/step_plan.py``."""
    from . import _build

    stream = _cuda_inputs(xbs, H)
    S, nb, B, F = _check_spectra_inputs(xbs, H, n_fft, dir_rate)
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be positive")
    C = -(-S // chunk)
    P = torch.empty((C, nb, 2, F), dtype=torch.complex64, device=xbs.device)
    plan = pruned_plan(n_fft, True, B)
    if plan is not None:
        groups, shared = plan.residues, plan.shared_f2
    else:
        plan = step_plan(n_fft, True)
        groups = mix_groups(plan, chunk, C * nb, sm_count(xbs.device))
        shared = plan.shared_f2(groups)
    *split, _keep = layout(xbs.device, shared, plan.scratch_f2, C * nb, n_fft)
    if split[1]:
        plan, groups = radix2_plan(n_fft, True), 1
    tw, twq = _tables(plan, n_fft, xbs.device)
    _build.check(_build.library().tt_block_spectra_mix(
        xbs.data_ptr(), H.data_ptr(), P.data_ptr(), tw, twq, S, nb, B,
        n_fft, dir_rate, chunk, int(crossfade), plan.threads, groups,
        plan.blocks_per_sm, *split, stream), "block_spectra_mix")
    launches["block_spectra_mix"] += 1
    return P


def _tables(plan, n_fft: int, device: torch.device) -> tuple[int, int]:
    """The twiddle tables a block-step launch reads: the n_fft-point one
    (register and pruned bodies) and the Q-point one (pruned), else 0."""
    if isinstance(plan, PrunedPlan):
        return (twiddles(n_fft, device).data_ptr(),
                twiddles(plan.Q, device).data_ptr())
    return twiddles(n_fft, device).data_ptr() if plan.register else 0, 0


def spectra_inverse_cuda(Y: torch.Tensor, n_fft: int, *,
                         summed: bool = False) -> torch.Tensor:
    """Kernel `spectra_inverse` (``csrc/spectra_inverse.cu``, its plan in
    ``ops/spectra_inverse.py``): Y (..., 2, F) complex64 → frames (..., 2,
    n_fft) f32, the irfft of each ear. ``summed``: Y is (terms, ..., 2, F)
    and the frames are the irfft of Σ_t Y[t], added in order of t."""
    from . import _build

    stream = _cuda_inputs(Y)
    F = n_fft // 2 + 1
    if Y.dtype != torch.complex64:
        raise TypeError(f"Y must be complex64, got {Y.dtype}")
    lead = int(summed)
    if (Y.dim() < 2 + lead or Y.shape[-2:] != (2, F) or n_fft & (n_fft - 1)
            or n_fft < 2 or Y.numel() == 0):
        raise ValueError(f"Y must be ({'terms, ' * lead}..., 2, {F}) with "
                         f"n_fft a power of two, got {tuple(Y.shape)} and "
                         f"n_fft={n_fft}")
    terms = Y.shape[0] if summed else 1
    rows = Y.numel() // (2 * F * terms)
    frames = torch.empty((*Y.shape[lead:-1], n_fft), dtype=torch.float32,
                         device=Y.device)
    plan = inverse_plan(n_fft)
    *split, _keep = layout(Y.device, plan.shared_f2, n_fft, rows, n_fft)
    tw = 0 if split[1] else twiddles(n_fft, Y.device).data_ptr()
    # the cluster mode's local transforms take the 16384-point table
    twM = (twiddles(MAX_REGISTER_N, Y.device).data_ptr()
           if plan.ranks > 1 and not split[1] else 0)
    _build.check(_build.library().tt_spectra_inverse(
        Y.data_ptr(), frames.data_ptr(), tw, twM, rows, n_fft, terms,
        plan.rows_per_block, plan.points, plan.ranks, *split, stream),
        "spectra_inverse")
    launches["spectra_inverse"] += 1
    return frames


def block_spectra_reference(xbs: torch.Tensor, H: torch.Tensor, n_fft: int,
                            *, crossfade: bool,
                            dir_rate: int = 1) -> torch.Tensor:
    """Plain version of `block_spectra`, in xbs' precision: xbs (S, nb, B),
    H (S, ⌈nb/k⌉, 2, F) → Y (S, nb, 2, F), block b under H[:, ⌊b/k⌋] and,
    crossfading, H[:, ⌊(b−1)/k⌋] (block 0: its own)."""
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


def block_spectra_mix_reference(xbs: torch.Tensor, H: torch.Tensor,
                                n_fft: int, *, crossfade: bool, chunk: int,
                                dir_rate: int = 1) -> torch.Tensor:
    """Plain version of `block_spectra_mix`, in xbs' precision: xbs
    (S, nb, B), H (S, ⌈nb/k⌉, 2, F) → P (⌈S/chunk⌉, nb, 2, F)."""
    Y = block_spectra_reference(xbs, H, n_fft, crossfade=crossfade,
                                dir_rate=dir_rate)
    return torch.stack([Y[s:s + chunk].sum(0)
                        for s in range(0, xbs.shape[0], chunk)])


def spectra_inverse_reference(Y: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Plain version of `spectra_inverse`: (..., 2, F) → (..., 2, n_fft)."""
    return torch.fft.irfft(Y, n=n_fft)

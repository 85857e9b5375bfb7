"""The two-launch block render: block spectra per (source, block), their
inverse, and an overlap-add per source, with no mixdown; and the scene
render that mixes the block spectra over sources before the inverse.

Counterpart of `tinaural.ops.pallas_kernels`' `fused_block_step` (forward
FFT, filter assembly, crossfaded MAC → block spectra),
`fused_block_step_mix` (the same, accumulated over sources) and
`fused_epilogue` (inverse FFT of both ears, OLA that never crosses a source
boundary). Per source s and block b, with ``F = n_fft/2 + 1``:

1. kernel `assemble_filters` (``ops/block_render.py``): H[s,b] =
   rfft_nfft(effective_filter(gather(idx, w))), or one H[s] per source
   when idx holds one row set per source;
2. kernel `block_spectra`: Y[s,b] = rfft(x·u)·H[s,b] + rfft(x·(1−u))·
   H[s,b−1] with u = (i + 0.5)/B and H[s,−1] := H[s,0]; without crossfade
   Y = rfft(x)·H[s,b];
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
kernels take every FFT size (``ops/_layout.py``). ``launches`` counts the
three kernels of this module.
"""

from __future__ import annotations

import torch

from ._layout import layout, sm_count
from .block_render import (_check_inputs, _cuda_inputs,
                           assemble_filters_cuda, assemble_filters_reference,
                           block_render_reference, overlap_add_cuda)
from .ola import overlap_add
from .spectra_inverse import MAX_REGISTER_N, inverse_plan, twiddles

KERNELS = ("block_spectra", "spectra_inverse", "block_spectra_mix")
# `block_spectra_mix` takes as many source chunks as give its grid this
# many CUDA blocks per SM (the mix kernel holds ~41 KB of shared memory at
# n_fft 2048, so five fit an SM at once), at most one per source.
MIX_BLOCKS_PER_SM = 8
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def block_step_render(xbs: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      table, n_fft: int, *, crossfade: bool, apply_itd: bool,
                      apply_ild: bool) -> torch.Tensor:
    """xbs (S, nb, B) f32; idx (S, nb, 4) int32 flat table rows (e·A_max +
    a) or (S, 1, 4), one filter per source; w the weights of idx's shape
    → (S, 2, (nb−1)·B + n_fft) f32, one render per source."""
    _check_inputs(xbs, idx, w, table, n_fft, one_filter_ok=True)
    kw = dict(crossfade=crossfade, apply_itd=apply_itd, apply_ild=apply_ild)
    if xbs.device.type == "cpu":
        return block_step_render_reference(xbs, idx, w, table, n_fft, **kw)
    if xbs.device.type != "cuda":
        raise ValueError(f"block_step_render runs on cpu or cuda, not {xbs.device}")
    if xbs.dtype != torch.float32:  # before the first launch
        raise TypeError(f"the CUDA route takes float32 blocks, got {xbs.dtype}")
    H = assemble_filters_cuda(idx, w, table, n_fft, apply_itd=apply_itd,
                              apply_ild=apply_ild)
    Y = block_spectra_cuda(xbs, H, n_fft, crossfade=crossfade)
    return overlap_add_cuda(spectra_inverse_cuda(Y, n_fft), xbs.shape[-1])


def block_step_render_reference(xbs: torch.Tensor, idx: torch.Tensor,
                                w: torch.Tensor, table, n_fft: int, *,
                                crossfade: bool, apply_itd: bool,
                                apply_ild: bool) -> torch.Tensor:
    """`block_step_render` in plain torch, in xbs' precision (float32 or
    float64)."""
    H = assemble_filters_reference(idx, w.to(xbs.dtype), table, n_fft,
                                   apply_itd=apply_itd, apply_ild=apply_ild)
    Y = block_spectra_reference(xbs, H, n_fft, crossfade=crossfade)
    frames = spectra_inverse_reference(Y, n_fft)  # (S, nb, 2, n_fft)
    return overlap_add(frames.transpose(1, 2), xbs.shape[-1])


def scene_step_render(xbs: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      table, n_fft: int, *, crossfade: bool, apply_itd: bool,
                      apply_ild: bool) -> torch.Tensor:
    """xbs (S, nb, B) f32; idx (S, nb, 4) int32 flat table rows or
    (S, 1, 4), one filter per source; w the weights of idx's shape →
    (2, (nb−1)·B + n_fft) f32, the sources mixed down."""
    _check_inputs(xbs, idx, w, table, n_fft, one_filter_ok=True)
    kw = dict(crossfade=crossfade, apply_itd=apply_itd, apply_ild=apply_ild)
    if xbs.device.type == "cpu":
        return scene_step_render_reference(xbs, idx, w, table, n_fft, **kw)
    if xbs.device.type != "cuda":
        raise ValueError(f"scene_step_render runs on cpu or cuda, not {xbs.device}")
    if xbs.dtype != torch.float32:  # before the first launch
        raise TypeError(f"the CUDA route takes float32 blocks, got {xbs.dtype}")
    S, nb, B = xbs.shape
    H = assemble_filters_cuda(idx, w, table, n_fft, apply_itd=apply_itd,
                              apply_ild=apply_ild)
    P = block_spectra_mix_cuda(xbs, H, n_fft, crossfade=crossfade,
                               chunk=mix_chunk(S, nb, sm_count(xbs.device)))
    frames = spectra_inverse_cuda(P, n_fft, summed=True)
    return overlap_add_cuda(frames[None], B)[0]


# `scene_step_render` in plain torch is B1's plain version: the same map
# (block spectra summed over sources, irfft, overlap-add), in xbs'
# precision, one filter per source allowed.
scene_step_render_reference = block_render_reference


def mix_chunk(S: int, nb: int, sms: int) -> int:
    """Sources per CUDA block of `block_spectra_mix`: the fewest chunks C
    whose grid of C·nb blocks gives every SM ``MIX_BLOCKS_PER_SM``, at
    most S, then the sources spread evenly over them (C = ⌈S/chunk⌉)."""
    chunks = min(S, max(1, -(-MIX_BLOCKS_PER_SM * sms // nb)))
    return -(-S // chunks)


def _check_spectra_inputs(xbs: torch.Tensor, H: torch.Tensor,
                          n_fft: int) -> tuple[int, int, int, int]:
    """Types and shapes of a block-spectra kernel's inputs → (S, nb, B, F)."""
    if xbs.dtype != torch.float32 or H.dtype != torch.complex64:
        raise TypeError("xbs must be float32 and H complex64")
    if xbs.dim() != 3:
        raise ValueError(f"xbs must be (S, nb, B), got {tuple(xbs.shape)}")
    S, nb, B = xbs.shape
    F = n_fft // 2 + 1
    if H.dim() != 4 or H.shape[0] != S or H.shape[1] not in (1, nb) \
            or H.shape[2:] != (2, F):
        raise ValueError(f"H must be ({S}, {nb} or 1, 2, {F}), got "
                         f"{tuple(H.shape)}")
    if n_fft & (n_fft - 1) or n_fft < B:
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least "
                         f"B={B}")
    return S, nb, B, F


def block_spectra_cuda(xbs: torch.Tensor, H: torch.Tensor, n_fft: int, *,
                       crossfade: bool) -> torch.Tensor:
    """Kernel `block_spectra`: xbs (S, nb, B) f32, H (S, nb, 2, F) or
    (S, 1, 2, F) complex64 → Y (S, nb, 2, F) complex64."""
    from . import _build

    stream = _cuda_inputs(xbs, H)
    S, nb, B, F = _check_spectra_inputs(xbs, H, n_fft)
    Y = torch.empty((S, nb, 2, F), dtype=torch.complex64, device=xbs.device)
    *split, _keep = layout(xbs.device, n_fft // 2 + n_fft, n_fft, S * nb,
                           n_fft)
    _build.check(_build.library().tt_block_spectra(
        xbs.data_ptr(), H.data_ptr(), Y.data_ptr(), S, nb, B, n_fft,
        H.shape[1], int(crossfade), *split, stream), "block_spectra")
    launches["block_spectra"] += 1
    return Y


def block_spectra_mix_cuda(xbs: torch.Tensor, H: torch.Tensor, n_fft: int,
                           *, crossfade: bool, chunk: int) -> torch.Tensor:
    """Kernel `block_spectra_mix`: xbs (S, nb, B) f32, H (S, nb, 2, F) or
    (S, 1, 2, F) complex64 → partials P (⌈S/chunk⌉, nb, 2, F) complex64,
    P[c] the block spectra of sources c·chunk … (c+1)·chunk − 1 summed."""
    from . import _build

    stream = _cuda_inputs(xbs, H)
    S, nb, B, F = _check_spectra_inputs(xbs, H, n_fft)
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be positive")
    P = torch.empty((-(-S // chunk), nb, 2, F), dtype=torch.complex64,
                    device=xbs.device)
    *split, _keep = layout(xbs.device, n_fft // 2 + n_fft + 2 * F,
                           n_fft + 2 * F, P.shape[0] * nb, n_fft)
    _build.check(_build.library().tt_block_spectra_mix(
        xbs.data_ptr(), H.data_ptr(), P.data_ptr(), S, nb, B, n_fft,
        H.shape[1], chunk, int(crossfade), *split, stream),
        "block_spectra_mix")
    launches["block_spectra_mix"] += 1
    return P


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
                            *, crossfade: bool) -> torch.Tensor:
    """Plain version of `block_spectra`, in xbs' precision: xbs (S, nb, B),
    H (S, nb or 1, 2, F) → Y (S, nb, 2, F)."""
    B = xbs.shape[-1]
    if not crossfade:
        return torch.fft.rfft(xbs, n=n_fft)[:, :, None] * H
    u = (torch.arange(B, dtype=xbs.dtype, device=xbs.device) + 0.5) / B
    Xu = torch.fft.rfft(xbs * u, n=n_fft)[:, :, None]
    Xd = torch.fft.rfft(xbs * (1.0 - u), n=n_fft)[:, :, None]
    Hp = torch.cat([H[:, :1], H[:, :-1]], dim=1)  # block 0: own filter
    return Xu * H + Xd * Hp


def block_spectra_mix_reference(xbs: torch.Tensor, H: torch.Tensor,
                                n_fft: int, *, crossfade: bool,
                                chunk: int) -> torch.Tensor:
    """Plain version of `block_spectra_mix`, in xbs' precision: xbs
    (S, nb, B), H (S, nb or 1, 2, F) → P (⌈S/chunk⌉, nb, 2, F)."""
    Y = block_spectra_reference(xbs, H, n_fft, crossfade=crossfade)
    return torch.stack([Y[s:s + chunk].sum(0)
                        for s in range(0, xbs.shape[0], chunk)])


def spectra_inverse_reference(Y: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Plain version of `spectra_inverse`: (..., 2, F) → (..., 2, n_fft)."""
    return torch.fft.irfft(Y, n=n_fft)

"""Partitioned overlap-save convolution: the streaming step, its hold step
and the offline batched render.

Counterpart of `tinaural.ops.pallas_kernels`' `fused_stream_step`,
`fused_stream_hold`, `fused_partitioned_step` and
`fused_partitioned_assembled`. With P = ⌈(taps + DELAY_PAD)/B⌉ partitions
and ``F2 = B + 1`` bins of the 2B frame:

- `stream_step`: H = rfft_2B of the B-sample partitions of the effective
  filter of (idx, w) (kernel `assemble_partitions`), then kernel
  `stream_conv`: the delay line gains the frame spectrum of
  ``[prev_in | xb]`` at slot 0, ``Y = Σ_p FDL[p]·H[p]``, the output is the
  last B samples of irfft_2B(Y), crossfaded ``w·y(H) + (1−w)·y(H_prev)``
  with ``w = (i + 0.5)/B``, where a stream that has not started takes H as
  H_prev;
- `stream_hold`: `stream_conv` under the carried partitions, no blend;
- `partitioned_render`: the same map with every block of one signal
  batched: H for each block, then kernel `partitioned_conv`, with
  ``H[b−1]`` as the previous filter and ``H[−1] := H[0]``.

Partition spectra travel as float32 re/im planes (..., P, 2, F2), the
layout of `StreamState.prev_h`, and the delay line as (..., P, F2) planes.
Every output is a fresh tensor: no input is written.

The device of the tensors picks the route: CUDA tensors launch the
hand-written kernels of ``csrc/partitioned.cu`` (and raise on failure), CPU
tensors run the plain versions ``*_reference`` in the tensors' precision.
The kernels take every filter length and block: above shared memory they
run with their buffers in a device scratch (``ops/_layout.py``), except
`assemble_partitions` at L = 16384 … 131072, which spreads each row over a
thread-block cluster (``ops/partitions_plan.py``).
``launches`` counts each kernel's launches.
"""

from __future__ import annotations

import torch

from ..data.table import (ALIGN_GUARD, MAX_RENDER_SHIFT, TAPER_HI,
                          TAPER_LO, TorchTable)
from ._layout import layout
from .block_render import _cuda_inputs
from .filters import (effective_filter, filter_partitions, n_parts,
                      partition_spectra)
from .interp import gather_rows
from .mac_plan import ramp_taper
from .partitioned import (crossfade_tails, delayed, frame_spectra,
                          partitioned_mac, shifted_stack)
from .partitions_plan import RANK_SAMPLES, partitions_plan
from .spectra_inverse import twiddles

KERNELS = ("assemble_partitions", "stream_conv", "partitioned_conv")
launches = dict.fromkeys(KERNELS, 0)

# The CUDA route of `partitioned_render` assembles the partition planes of
# at most this many bytes at a time (rows·P·2·F2·8): blocks go through
# `partitioned_conv` in chunks, each with its own rows and the row before.
# 2048 blocks of 512 at 2048 taps (P = 5) are 84 MB, one chunk.
CHUNK_BYTES = 1 << 28


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type == "cuda"
    raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")


# ------------------------------------------------------------ public routes


def stream_step(table: TorchTable, idx, w, xb, prev_in, fdl_re, fdl_im,
                ph_re, ph_im, started, *, crossfade: bool, apply_itd: bool,
                apply_ild: bool):
    """One filter-updating push of S streams. idx (S, 4) int32 flat table
    rows, w (S, 4); xb, prev_in (S, B); fdl_* (S, P, F2); ph_* (S, P, 2, F2)
    the previous partitions; started (S,) → (y (S, 2, B), prev_in',
    fdl_re', fdl_im', h_re, h_im), the last two the new partitions."""
    if _on_cuda(xb, "stream_step"):
        return _stream_step(assemble_partitions_cuda, stream_conv_cuda,
                            table, idx, w, xb, prev_in, fdl_re, fdl_im,
                            ph_re, ph_im, started, crossfade=crossfade,
                            apply_itd=apply_itd, apply_ild=apply_ild)
    return stream_step_reference(table, idx, w, xb, prev_in, fdl_re, fdl_im,
                                 ph_re, ph_im, started, crossfade=crossfade,
                                 apply_itd=apply_itd, apply_ild=apply_ild)


def stream_step_reference(table: TorchTable, idx, w, xb, prev_in, fdl_re,
                          fdl_im, ph_re, ph_im, started, *, crossfade: bool,
                          apply_itd: bool, apply_ild: bool):
    """`stream_step` in plain torch, in xb's precision."""
    return _stream_step(assemble_partitions_reference, stream_conv_reference,
                        table, idx, w, xb, prev_in, fdl_re, fdl_im, ph_re,
                        ph_im, started, crossfade=crossfade,
                        apply_itd=apply_itd, apply_ild=apply_ild)


def _stream_step(assemble, conv, table, idx, w, xb, prev_in, fdl_re, fdl_im,
                 ph_re, ph_im, started, *, crossfade, apply_itd, apply_ild):
    h_re, h_im = assemble(idx, w.to(xb.dtype), table, xb.shape[-1],
                          apply_itd=apply_itd, apply_ild=apply_ild)
    y, pin, fr, fi = conv(xb, prev_in, fdl_re, fdl_im, h_re, h_im, ph_re,
                          ph_im, started, crossfade=crossfade)
    return y, pin, fr, fi, h_re, h_im


def stream_hold(xb, prev_in, fdl_re, fdl_im, ph_re, ph_im, started):
    """One held push: the delay line advances and the block renders under
    the carried partitions ph_*, with no assembly and no blend →
    (y (S, 2, B), prev_in', fdl_re', fdl_im')."""
    conv = (stream_conv_cuda if _on_cuda(xb, "stream_hold")
            else stream_conv_reference)
    return conv(xb, prev_in, fdl_re, fdl_im, ph_re, ph_im, ph_re, ph_im,
                started, crossfade=False)


def stream_hold_reference(xb, prev_in, fdl_re, fdl_im, ph_re, ph_im,
                          started):
    """`stream_hold` in plain torch, in xb's precision."""
    return stream_conv_reference(xb, prev_in, fdl_re, fdl_im, ph_re, ph_im,
                                 ph_re, ph_im, started, crossfade=False)


def partitioned_render(xb: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                       table: TorchTable, *, crossfade: bool, apply_itd: bool,
                       apply_ild: bool) -> torch.Tensor:
    """Batched partitioned convolution of one signal. xb (nb, B); idx
    (nb, 4) int32 flat table rows, w (nb, 4) per block → (2, nb·B)."""
    kw = dict(crossfade=crossfade, apply_itd=apply_itd, apply_ild=apply_ild)
    if not _on_cuda(xb, "partitioned_render"):
        return partitioned_render_reference(xb, idx, w, table, **kw)
    if xb.dtype != torch.float32:  # before the first launch
        raise TypeError(f"the CUDA route takes float32 blocks, got {xb.dtype}")
    nb, B = xb.shape
    P = n_parts(table.taps, B)
    chunk = max(1, CHUNK_BYTES // (P * 2 * (B + 1) * 8))
    out = torch.empty((2, nb * B), dtype=torch.float32, device=xb.device)
    for b0 in range(0, nb, chunk):
        b1 = min(nb, b0 + chunk)
        r0 = b0 - (b0 > 0)
        h_re, h_im = assemble_partitions_cuda(idx[r0:b1], w[r0:b1], table, B,
                                              apply_itd=apply_itd,
                                              apply_ild=apply_ild)
        partitioned_conv_cuda(xb, h_re, h_im, crossfade=crossfade, start=b0,
                              out=out)
    return out


def partitioned_render_reference(xb: torch.Tensor, idx: torch.Tensor,
                                 w: torch.Tensor, table: TorchTable, *,
                                 crossfade: bool, apply_itd: bool,
                                 apply_ild: bool) -> torch.Tensor:
    """`partitioned_render` in plain torch, in xb's precision. It loops
    over the partitions, generating partition p of every block's filter
    from the effective filters, so memory stays O(nb·(taps + B)) however
    long the filter (the JAX package's `_partitioned_scan`)."""
    nb, B = xb.shape
    h, d, g = gather_rows(table, idx, w.to(xb.dtype), apply_itd=apply_itd,
                          apply_ild=apply_ild)
    h_eff = effective_filter(h, d, g, table.taps)  # (nb, 2, T_pad)
    parts = (partition_spectra(h_eff[..., p * B:(p + 1) * B], B)[:, 0]
             for p in range(n_parts(table.taps, B)))
    X = frame_spectra(xb)
    Yn = Yp = 0
    for p, Hp in enumerate(parts):  # Hp: (nb, 2, F2)
        Xp = delayed(X, p)[:, None]
        Yn = Yn + Xp * Hp
        if crossfade:
            Yp = Yp + Xp * torch.cat([Hp[:1], Hp[:-1]], dim=0)
    y = crossfade_tails(Yn, Yp if crossfade else None, B)  # (nb, 2, B)
    return y.transpose(0, 1).reshape(2, nb * B)


# ------------------------------------------------------- kernel `*_cuda`s


def _check_block(block: int) -> None:
    if block & (block - 1) or block < 2:
        raise ValueError(f"block={block} must be a power of two of at least 2")


def assemble_partitions_cuda(idx: torch.Tensor, w: torch.Tensor,
                             table: TorchTable, block: int, *,
                             apply_itd: bool, apply_ild: bool):
    """Kernel `assemble_partitions`: idx (..., 4) int32 flat table rows
    (unchecked: a range check would synchronise the host), w (..., 4) f32
    → (h_re, h_im), each (..., P, 2, block+1) f32."""
    from . import _build

    stream = _cuda_inputs(idx, w, table.h, table.delays, table.gains)
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError("idx must be int32 and w float32")
    if idx.shape[-1:] != (4,) or w.shape != idx.shape or idx.numel() == 0:
        raise ValueError(f"idx and w must be (..., 4) with rows, got "
                         f"{tuple(idx.shape)} and {tuple(w.shape)}")
    _check_block(block)
    plan = partitions_plan(table.taps, block)
    L, P = plan.L, plan.parts
    shape = (*idx.shape[:-1], P, 2, block + 1)
    h_re = torch.empty(shape, dtype=torch.float32, device=idx.device)
    h_im = torch.empty_like(h_re)
    rows = idx.numel() // 4
    *split, _keep = layout(idx.device, plan.shared_f2, plan.scratch_f2, rows,
                           max(L, 2 * block))
    tables = (0, 0, 0, 0)
    cluster = plan.cluster and not split[1]
    if cluster:
        tables = tuple(t.data_ptr() for t in (
            twiddles(L, idx.device), twiddles(RANK_SAMPLES, idx.device),
            twiddles(2 * block, idx.device), ramp_taper(L, idx.device)))
    _build.check(_build.library().tt_assemble_partitions(
        idx.data_ptr(), w.data_ptr(), table.h.data_ptr(),
        table.delays.data_ptr(), table.gains.data_ptr(), h_re.data_ptr(),
        h_im.data_ptr(), *tables, rows, table.taps, plan.t_pad, block, P,
        int(apply_itd), int(apply_ild), plan.ranks if cluster else 0,
        ALIGN_GUARD, MAX_RENDER_SHIFT, TAPER_LO, TAPER_HI, *split, stream),
        "assemble_partitions")
    launches["assemble_partitions"] += 1
    return h_re, h_im


def stream_conv_cuda(xb, prev_in, fdl_re, fdl_im, h_re, h_im, hp_re, hp_im,
                     started, *, crossfade: bool):
    """Kernel `stream_conv`: xb, prev_in (S, B); fdl_* (S, P, F2); h_*,
    hp_* (S, P, 2, F2); started (S,), all f32 → (y (S, 2, B), prev_in' (a
    copy of xb), fdl_re', fdl_im')."""
    from . import _build

    ins = (xb, prev_in, fdl_re, fdl_im, h_re, h_im, hp_re, hp_im, started)
    stream = _cuda_inputs(*ins)
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("stream_conv takes float32 tensors")
    S, B = xb.shape
    _check_block(B)
    P = h_re.shape[1] if h_re.dim() == 4 else 0
    if S == 0 or P == 0:
        raise ValueError("stream_conv needs streams and partitions")
    for name, t, want in (
            ("prev_in", prev_in, (S, B)), ("fdl_re", fdl_re, (S, P, B + 1)),
            ("fdl_im", fdl_im, (S, P, B + 1)), ("h_re", h_re, (S, P, 2, B + 1)),
            ("h_im", h_im, (S, P, 2, B + 1)), ("hp_re", hp_re, (S, P, 2, B + 1)),
            ("hp_im", hp_im, (S, P, 2, B + 1)), ("started", started, (S,))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    y = torch.empty((S, 2, B), dtype=torch.float32, device=xb.device)
    pin = torch.empty_like(xb)
    fr = torch.empty_like(fdl_re)
    fi = torch.empty_like(fdl_im)
    *split, _keep = layout(xb.device, 7 * B, 6 * B, S, 2 * B)
    _build.check(_build.library().tt_stream_conv(
        *(t.data_ptr() for t in ins), y.data_ptr(), pin.data_ptr(),
        fr.data_ptr(), fi.data_ptr(), S, B, P, int(crossfade), *split,
        stream), "stream_conv")
    launches["stream_conv"] += 1
    return y, pin, fr, fi


def partitioned_conv_cuda(xb: torch.Tensor, h_re: torch.Tensor,
                          h_im: torch.Tensor, *, crossfade: bool,
                          start: int = 0, out: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Kernel `partitioned_conv`: xb (nb, B) f32; h_* (rows, P, 2, F2) f32
    the partitions of blocks start − (start > 0) … start + n − 1 → out
    (2, nb·B), of which blocks start … start + n − 1 are written."""
    from . import _build

    stream = _cuda_inputs(xb, h_re, h_im)
    if any(t.dtype != torch.float32 for t in (xb, h_re, h_im)):
        raise TypeError("partitioned_conv takes float32 tensors")
    nb, B = xb.shape
    _check_block(B)
    has_prev = int(start > 0)
    n = h_re.shape[0] - has_prev
    if (h_re.dim() != 4 or h_re.shape[2:] != (2, B + 1)
            or h_im.shape != h_re.shape or n <= 0 or start + n > nb):
        raise ValueError(f"h_re/h_im must be (rows, P, 2, {B + 1}) for "
                         f"blocks {start}… of {nb}, got {tuple(h_re.shape)}")
    if out is None:
        out = torch.empty((2, nb * B), dtype=torch.float32, device=xb.device)
    _cuda_inputs(out)
    if tuple(out.shape) != (2, nb * B) or out.dtype != torch.float32:
        raise ValueError(f"out must be float32 (2, {nb * B})")
    *split, _keep = layout(xb.device, 5 * B + 4 * (B + 1),
                           4 * B + 4 * (B + 1), n, 2 * B)
    _build.check(_build.library().tt_partitioned_conv(
        xb.data_ptr(), h_re.data_ptr(), h_im.data_ptr(), out.data_ptr(), nb,
        start, n, has_prev, B, h_re.shape[1], int(crossfade), *split,
        stream), "partitioned_conv")
    launches["partitioned_conv"] += 1
    return out


# -------------------------------------------------- plain kernel versions


def assemble_partitions_reference(idx, w, table: TorchTable, block: int, *,
                                  apply_itd: bool, apply_ild: bool):
    """Plain version of `assemble_partitions`, in w's precision."""
    h, d, g = gather_rows(table, idx, w, apply_itd=apply_itd,
                          apply_ild=apply_ild)
    H = filter_partitions(h, d, g, table.taps, block)
    return H.real.contiguous(), H.imag.contiguous()


def stream_conv_reference(xb, prev_in, fdl_re, fdl_im, h_re, h_im, hp_re,
                          hp_im, started, *, crossfade: bool):
    """Plain version of `stream_conv`, in xb's precision."""
    B = xb.shape[-1]
    X = torch.fft.rfft(torch.cat([prev_in, xb], dim=-1), n=2 * B)  # (S, F2)
    fdl = torch.cat([X[:, None], torch.complex(fdl_re, fdl_im)[:, :-1]],
                    dim=1)  # (S, P, F2)
    H = torch.complex(h_re, h_im)
    Yn = partitioned_mac(fdl.transpose(0, 1), H)
    Yp = None
    if crossfade:
        Hp = torch.where(started[:, None, None, None] > 0.5,
                         torch.complex(hp_re, hp_im), H)
        Yp = partitioned_mac(fdl.transpose(0, 1), Hp)
    return (crossfade_tails(Yn, Yp, B), xb.clone(),
            fdl.real.contiguous(), fdl.imag.contiguous())


def partitioned_conv_reference(xb, h_re, h_im, *, crossfade: bool
                               ) -> torch.Tensor:
    """Plain version of `partitioned_conv` over all blocks: xb (nb, B),
    h_* (nb, P, 2, F2) → (2, nb·B)."""
    nb, B = xb.shape
    H = torch.complex(h_re, h_im)
    Xs = shifted_stack(frame_spectra(xb), H.shape[1])  # (P, nb, F2)
    Yn = partitioned_mac(Xs, H)
    Yp = None
    if crossfade:
        Yp = partitioned_mac(Xs, torch.cat([H[:1], H[:-1]], dim=0))
    y = crossfade_tails(Yn, Yp, B)
    return y.transpose(0, 1).reshape(2, nb * B)

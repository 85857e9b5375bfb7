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
  batched: H for each group of k = ``dir_rate`` blocks (⌈nb/k⌉ rows, the
  JAX kernel's unique-filter path), kernel `frame_spectra` (each frame
  spectrum once for the render), then per chunk kernel
  `partitioned_conv`, block b under row ⌊b/k⌋ with row ⌊(b−1)/k⌋ as the
  previous filter (block 0: its own). On the track `RenderConfig.dir_rate` snaps, that is
  the map of k = 1 with every block's filter, at k× fewer assemblies.

Partition spectra travel as float32 re/im planes (..., P, 2, F2), the
layout of `StreamState.prev_h`, and the delay line as (..., P, F2) planes.
Every output is a fresh tensor: no input is written.

The device of the tensors picks the route: CUDA tensors launch the
hand-written kernels of ``csrc/partitioned.cu`` (and raise on failure), CPU
tensors run the plain versions ``*_reference`` in the tensors' precision.
The kernels take every filter length and block: above shared memory they
run with their buffers in a device scratch (``ops/_layout.py``), except
`assemble_partitions` at L = 16384 … 131072, which spreads each row over a
thread-block cluster; below, at blocks 64 … 2048, it runs G rows per CUDA
block as register FFTs (``ops/partitions_plan.py``); where neither ITD nor
ILD applies, at blocks 64 … 2048 it takes the direct body at every filter
length, one register transform a partition straight from the table rows,
with no L-point chain; and `stream_conv`,
`frame_spectra` and `partitioned_conv` run as register FFTs too
(``ops/conv_plan.py``; at other blocks, and in the split mode, the
radix-2 `partitioned_conv` computes its frame spectra itself and
`frame_spectra` is not launched). ``launches`` counts each kernel's
launches.

`partitioned_render` records span ``tt.frames`` around the frame spectra
and, for each chunk, ``tt.partitions`` around the assembly and ``tt.conv``
around the convolution (children of the caller's ``tt.route``; the plain
version makes its partition transforms one at a time inside its
``tt.conv``), and counts ``partition_rows``, the filter rows × P it
assembles (a chunk past the first assembles its predecessor row again),
and, on the CUDA route, ``conv_chunks``, its chunks.
`assemble_partitions_cuda` counts ``direct_partition_rows``, the rows × P
of its direct-body launches (on the card only: the plain versions run the
chain).
"""

from __future__ import annotations

import torch

from ..data.table import (ALIGN_GUARD, MAX_RENDER_SHIFT, TAPER_HI,
                          TAPER_LO, TorchTable)
from ..utils import profiling
from ._layout import (CLUSTER, DIRECT, REGISTER, cuda_inputs, filter_rows,
                      launch_mode, layout, shared_limit, sm_count)
from .filters import (effective_filter, filter_partitions, n_parts,
                      partition_spectra)
from .conv_plan import (chunk_frames, conv_launch, conv_plan, frames_launch,
                        pair_start, stream_launch)
from .interp import gather_rows
from .mac_plan import ramp_taper
from .partitioned import (crossfade_tails, delayed, frame_spectra,
                          partitioned_mac, shifted_stack)
from .partitions_plan import RANK_SAMPLES, launch, partitions_plan
from .spectra_inverse import twiddles

KERNELS = ("assemble_partitions", "stream_conv", "frame_spectra",
           "partitioned_conv")
launches = dict.fromkeys(KERNELS, 0)
profiling.register(launches)

# The CUDA route of `partitioned_render` assembles the partition planes of
# at most this many bytes at a time (rows·P·2·F2·8): blocks go through
# `partitioned_conv` in chunks of whole groups of dir_rate blocks, each
# with its own rows and the row before (`render_chunks`). 2048 blocks of
# 512 at 2048 taps (P = 5) are 84 MB at dir_rate 1, one chunk.
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
                       apply_ild: bool, dir_rate: int = 1) -> torch.Tensor:
    """Batched partitioned convolution of one signal. xb (nb, B); idx
    (⌈nb/k⌉, 4) int32 flat table rows and w (⌈nb/k⌉, 4), one per group of
    k = ``dir_rate`` blocks → (2, nb·B)."""
    kw = dict(crossfade=crossfade, apply_itd=apply_itd, apply_ild=apply_ild,
              dir_rate=dir_rate)
    nb, B = xb.shape
    want = (filter_rows(nb, dir_rate), 4)
    if tuple(idx.shape) != want or w.shape != idx.shape:
        raise ValueError(f"idx and w must be {want} at dir_rate={dir_rate}, "
                         f"got {tuple(idx.shape)} and {tuple(w.shape)}")
    if not _on_cuda(xb, "partitioned_render"):
        return partitioned_render_reference(xb, idx, w, table, **kw)
    if xb.dtype != torch.float32:  # before the first launch
        raise TypeError(f"the CUDA route takes float32 blocks, got {xb.dtype}")
    return chunked_render(assemble_partitions_cuda, partitioned_conv_cuda,
                          xb, idx, w, table, frames=_render_spectra, **kw)


def chunked_render(assemble, conv, xb, idx, w, table: TorchTable, *,
                   crossfade: bool, apply_itd: bool, apply_ild: bool,
                   dir_rate: int, frames=None) -> torch.Tensor:
    """`partitioned_render`'s CUDA route over `render_chunks`, with
    ``assemble`` and ``conv`` the two kernels' wrappers or their plain
    versions. ``frames(xb, P)``, where given, returns the frame spectra of
    all nb blocks (kernel `frame_spectra`, each frame once for the whole
    render) or None, and every chunk's ``conv`` reads them."""
    nb, B = xb.shape
    P = n_parts(table.taps, B)
    row_bytes = P * 2 * (B + 1) * 8
    chunk = max(1, CHUNK_BYTES // row_bytes) * dir_rate
    out = xb.new_empty((2, nb * B))
    spectra = None
    if frames is not None:
        with profiling.span("tt.frames"):
            spectra = frames(xb, P)
    chunks = render_chunks(nb, dir_rate, chunk)
    profiling.count("conv_chunks", len(chunks))
    for b0, b1, r0, r1 in chunks:
        profiling.count("partition_rows", (r1 - r0) * P)
        with profiling.span("tt.partitions"):
            h_re, h_im = assemble(idx[r0:r1], w[r0:r1].to(xb.dtype), table,
                                  B, apply_itd=apply_itd,
                                  apply_ild=apply_ild)
        with profiling.span("tt.conv"):
            conv(xb, h_re, h_im, crossfade=crossfade, start=b0, stop=b1,
                 dir_rate=dir_rate, out=out, spectra=spectra)
    return out


def _render_spectra(xb: torch.Tensor, parts: int) -> torch.Tensor | None:
    """The frame spectra of every block of a CUDA render whose
    `partitioned_conv` launches take the register body; else None."""
    nb, B = xb.shape
    if conv_plan(B, parts).body != REGISTER:
        return None
    _, shared_f2 = conv_launch(B, parts, nb, sm_count(xb.device))
    mode, _ = launch_mode(REGISTER, shared_f2, 2 * B, shared_limit(xb.device))
    return frame_spectra_cuda(xb, 0, nb) if mode == REGISTER else None


def render_chunks(nb: int, dir_rate: int, chunk: int
                  ) -> list[tuple[int, int, int, int]]:
    """The chunks of `partitioned_render`'s CUDA route: (b0, b1, r0, r1),
    blocks b0 … b1 − 1 through one `partitioned_conv` launch with the
    filter rows r0 … r1 − 1 of the ⌈nb/k⌉ (k = ``dir_rate``) assembled
    for it. A chunk is ``chunk`` blocks rounded down to whole groups (at
    least one), so each starts a group: past block 0 its rows begin with
    the one group before it, the previous filter of its first block."""
    k = dir_rate
    step = max(k, chunk - chunk % k)
    return [(b0, min(nb, b0 + step), b0 // k - (b0 > 0),
             filter_rows(min(nb, b0 + step), k))
            for b0 in range(0, nb, step)]


def conv_rows(start: int, stop: int, dir_rate: int, device=None):
    """The row map of `partitioned_conv` (``csrc/partitioned.cu``) for
    blocks start … stop − 1, start a multiple of k = ``dir_rate``: (row,
    prow) int64 tensors, block b's filter row ⌊b/k⌋ and its predecessor's
    ⌊(b−1)/k⌋ (block 0: its own), each counted from the chunk's first
    row, the group ⌊start/k⌋ − (start > 0)."""
    b = torch.arange(start, stop, device=device)
    g0 = start // dir_rate - (start > 0)
    return b // dir_rate - g0, (b - 1).clamp(min=0) // dir_rate - g0


def _conv_span(nb: int, rows: int, start: int, stop: int | None,
               dir_rate: int) -> int:
    """`partitioned_conv`'s blocks start … stop − 1 for ``rows`` filter
    rows → stop (by default as many blocks as the rows cover); raises
    where the rows are not exactly those the blocks read."""
    k = dir_rate
    if k < 1 or start < 0 or start % k:
        raise ValueError(f"start={start} must be a multiple of "
                         f"dir_rate={dir_rate} ≥ 1")
    g0 = start // k - (start > 0)
    if stop is None:
        stop = min(nb, (g0 + rows) * k)
    if not start < stop <= nb or rows != filter_rows(stop, k) - g0:
        raise ValueError(f"{rows} filter rows do not cover blocks "
                         f"{start}…{stop - 1} of {nb} at dir_rate={k}")
    return stop


def partitioned_render_reference(xb: torch.Tensor, idx: torch.Tensor,
                                 w: torch.Tensor, table: TorchTable, *,
                                 crossfade: bool, apply_itd: bool,
                                 apply_ild: bool,
                                 dir_rate: int = 1) -> torch.Tensor:
    """`partitioned_render` in plain torch, in xb's precision. It loops
    over the partitions, generating partition p of every group's filter
    from the effective filters, so memory stays O(nb·(taps + B)) however
    long the filter (the JAX package's `_partitioned_scan`)."""
    nb, B = xb.shape
    P = n_parts(table.taps, B)
    with profiling.span("tt.partitions"):
        h, d, g = gather_rows(table, idx, w.to(xb.dtype),
                              apply_itd=apply_itd, apply_ild=apply_ild)
        h_eff = effective_filter(h, d, g, table.taps)  # (⌈nb/k⌉, 2, T_pad)
    profiling.count("partition_rows", h_eff.shape[0] * P)
    row, prow = conv_rows(0, nb, dir_rate, xb.device)
    parts = (partition_spectra(h_eff[..., p * B:(p + 1) * B], B)[:, 0]
             for p in range(P))
    with profiling.span("tt.frames"):
        X = frame_spectra(xb)
    Yn = Yp = 0
    with profiling.span("tt.conv"):
        for p, Hp in enumerate(parts):  # Hp: (⌈nb/k⌉, 2, F2)
            Xp = delayed(X, p)[:, None]
            Yn = Yn + Xp * Hp[row]
            if crossfade:
                Yp = Yp + Xp * Hp[prow]
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
    → (h_re, h_im), each (..., P, 2, block+1) f32. With neither flag the
    rows need no chain (``ops/partitions_plan.py``): the direct body,
    counted in ``direct_partition_rows`` (rows × P)."""
    from . import _build

    stream = cuda_inputs(idx, w, table.h, table.delays, table.gains)
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError("idx must be int32 and w float32")
    if idx.shape[-1:] != (4,) or w.shape != idx.shape or idx.numel() == 0:
        raise ValueError(f"idx and w must be (..., 4) with rows, got "
                         f"{tuple(idx.shape)} and {tuple(w.shape)}")
    _check_block(block)
    chain = bool(apply_itd or apply_ild)
    plan = partitions_plan(table.taps, block, chain)
    L, P = plan.L, plan.parts
    shape = (*idx.shape[:-1], P, 2, block + 1)
    h_re = torch.empty(shape, dtype=torch.float32, device=idx.device)
    h_im = torch.empty_like(h_re)
    rows = idx.numel() // 4
    G, block_threads, shared_f2 = launch(table.taps, block, rows,
                                         sm_count(idx.device), chain)
    lay = layout(idx.device, plan.body, shared_f2, plan.scratch_f2, rows,
                 max(L, 2 * block))
    # the split mode and the radix-2 body take neither tables nor plan
    tables, ranks, threads, per_block = (0, 0, 0, 0), 0, 0, 0
    if lay.mode == CLUSTER:
        ranks = plan.ranks
        tables = tuple(t.data_ptr() for t in (
            twiddles(L, idx.device), twiddles(RANK_SAMPLES, idx.device),
            twiddles(2 * block, idx.device), ramp_taper(L, idx.device)))
    elif lay.mode == REGISTER:
        threads, per_block = block_threads, G
        tables = (twiddles(L, idx.device).data_ptr(), 0,
                  twiddles(2 * block, idx.device).data_ptr(),
                  ramp_taper(L, idx.device).data_ptr())
    elif lay.mode == DIRECT:
        threads, per_block = block_threads, G
        tables = (0, 0, twiddles(2 * block, idx.device).data_ptr(), 0)
    _build.check(_build.library().tt_assemble_partitions(
        idx.data_ptr(), w.data_ptr(), table.h.data_ptr(),
        table.delays.data_ptr(), table.gains.data_ptr(), h_re.data_ptr(),
        h_im.data_ptr(), *tables, rows, table.taps, plan.t_pad, block, P,
        int(apply_itd), int(apply_ild), int(lay.mode == DIRECT), ranks,
        threads, per_block,
        ALIGN_GUARD, MAX_RENDER_SHIFT, TAPER_LO, TAPER_HI, *lay.split_args,
        stream), "assemble_partitions")
    launches["assemble_partitions"] += 1
    if lay.mode == DIRECT:
        profiling.count("direct_partition_rows", rows * P)
    return h_re, h_im


def stream_conv_cuda(xb, prev_in, fdl_re, fdl_im, h_re, h_im, hp_re, hp_im,
                     started, *, crossfade: bool):
    """Kernel `stream_conv`: xb, prev_in (S, B); fdl_* (S, P, F2); h_*,
    hp_* (S, P, 2, F2); started (S,), all f32 → (y (S, 2, B), prev_in' (a
    copy of xb), fdl_re', fdl_im')."""
    from . import _build

    ins = (xb, prev_in, fdl_re, fdl_im, h_re, h_im, hp_re, hp_im, started)
    stream = cuda_inputs(*ins)
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
    plan = conv_plan(B, P)
    G, threads, shared_f2 = stream_launch(B, P, S, sm_count(xb.device))
    lay = layout(xb.device, plan.body, shared_f2, plan.stream_scratch_f2, S,
                 2 * B)
    # the split mode and the radix-2 body take no table and no plan
    tw, reg = 0, (0, 0, 0)
    if lay.mode == REGISTER:
        tw = twiddles(2 * B, xb.device).data_ptr()
        reg = (G, threads, shared_f2)
    _build.check(_build.library().tt_stream_conv(
        *(t.data_ptr() for t in ins), y.data_ptr(), pin.data_ptr(),
        fr.data_ptr(), fi.data_ptr(), tw, S, B, P, int(crossfade), *reg,
        *lay.split_args, stream), "stream_conv")
    launches["stream_conv"] += 1
    return y, pin, fr, fi


def frame_spectra_cuda(xb: torch.Tensor, start: int,
                       stop: int) -> torch.Tensor:
    """Kernel `frame_spectra`: xb (nb, B) f32 → the overlap-save frame
    spectra of frames start … stop − 1 as (stop − start, B+1) complex64,
    frame c = [xb[c−1] | xb[c]] (xb[−1] = 0). Its transforms pair frames
    2m and 2m + 1, so ``start`` is even. Blocks 64 … 2048 only (the
    register range)."""
    from . import _build

    stream = cuda_inputs(xb)
    if xb.dtype != torch.float32:
        raise TypeError("frame_spectra takes float32 blocks")
    nb, B = xb.shape
    _check_block(B)
    if not 0 <= start < stop <= nb or start % 2:
        raise ValueError(f"frames {start}…{stop - 1} must lie in 0…{nb - 1} "
                         "and start on an even frame")
    frames = stop - start
    G, threads, shared_f2 = frames_launch(B, -(-frames // 2),
                                          sm_count(xb.device))
    X = torch.empty((frames, B + 1), dtype=torch.complex64, device=xb.device)
    _build.check(_build.library().tt_frame_spectra(
        xb.data_ptr(), X.data_ptr(), twiddles(2 * B, xb.device).data_ptr(),
        start, frames, nb, B, G, threads, shared_f2, stream),
        "frame_spectra")
    launches["frame_spectra"] += 1
    return X


def partitioned_conv_cuda(xb: torch.Tensor, h_re: torch.Tensor,
                          h_im: torch.Tensor, *, crossfade: bool,
                          start: int = 0, stop: int | None = None,
                          dir_rate: int = 1,
                          out: torch.Tensor | None = None,
                          spectra: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Kernel `partitioned_conv`: xb (nb, B) f32; h_* (rows, P, 2, F2) f32
    the partitions of the filter rows ⌊start/k⌋ − (start > 0) …
    ⌊(stop − 1)/k⌋ (`conv_rows`), k = ``dir_rate`` and start a multiple of
    k → out (2, nb·B), of which blocks start … stop − 1 are written. At
    blocks 64 … 2048 it reads the frame spectra ``spectra`` (nb, F2)
    complex64 of every block (`frame_spectra_cuda`), or, where None,
    computes those of its own frames first."""
    from . import _build

    stream = cuda_inputs(xb, h_re, h_im)
    if any(t.dtype != torch.float32 for t in (xb, h_re, h_im)):
        raise TypeError("partitioned_conv takes float32 tensors")
    nb, B = xb.shape
    _check_block(B)
    if (h_re.dim() != 4 or h_re.shape[2:] != (2, B + 1)
            or h_im.shape != h_re.shape):
        raise ValueError(f"h_re/h_im must be (rows, P, 2, {B + 1}), got "
                         f"{tuple(h_re.shape)}")
    stop = _conv_span(nb, h_re.shape[0], start, stop, dir_rate)
    if out is None:
        out = torch.empty((2, nb * B), dtype=torch.float32, device=xb.device)
    cuda_inputs(out)
    if tuple(out.shape) != (2, nb * B) or out.dtype != torch.float32:
        raise ValueError(f"out must be float32 (2, {nb * B})")
    P = h_re.shape[1]
    plan = conv_plan(B, P)
    threads, shared_f2 = conv_launch(B, P, stop - start, sm_count(xb.device))
    lay = layout(xb.device, plan.body, shared_f2, plan.conv_scratch_f2,
                 stop - start, 2 * B)
    # the split mode and the radix-2 body take no spectra, table or plan
    f0, tw, reg = 0, 0, (0, 0)
    if lay.mode == REGISTER:
        if spectra is None:
            f0 = pair_start(chunk_frames(start, stop, P)[0])
            spectra = frame_spectra_cuda(xb, f0, stop)
        else:
            cuda_inputs(spectra)
            if (tuple(spectra.shape) != (nb, B + 1)
                    or spectra.dtype != torch.complex64):
                raise ValueError(f"spectra must be complex64 ({nb}, {B + 1})")
        tw = twiddles(2 * B, xb.device).data_ptr()
        reg = (threads, shared_f2)
    else:
        spectra = None
    _build.check(_build.library().tt_partitioned_conv(
        xb.data_ptr(), 0 if spectra is None else spectra.data_ptr(),
        h_re.data_ptr(), h_im.data_ptr(), out.data_ptr(), tw, nb, start,
        stop - start, int(start > 0), dir_rate, f0, B, P, int(crossfade),
        *reg, *lay.split_args, stream), "partitioned_conv")
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


def frame_spectra_reference(xb: torch.Tensor, start: int,
                            stop: int) -> torch.Tensor:
    """Plain version of `frame_spectra`, in xb's precision."""
    return frame_spectra(xb)[start:stop]


def partitioned_conv_reference(xb, h_re, h_im, *, crossfade: bool,
                               start: int = 0, stop: int | None = None,
                               dir_rate: int = 1,
                               out: torch.Tensor | None = None,
                               spectra: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Plain version of `partitioned_conv`, in xb's precision, with its
    arguments (``spectra``, where given, the frame spectra of every block);
    blocks outside start … stop − 1 of a new ``out`` are zero."""
    nb, B = xb.shape
    stop = _conv_span(nb, h_re.shape[0], start, stop, dir_rate)
    row, prow = conv_rows(start, stop, dir_rate, xb.device)
    H = torch.complex(h_re, h_im)
    X = frame_spectra(xb) if spectra is None else spectra
    # (P, n, F2): the delay line of blocks start … stop − 1
    Xs = shifted_stack(X, H.shape[1])[:, start:stop]
    Yn = partitioned_mac(Xs, H[row])
    Yp = partitioned_mac(Xs, H[prow]) if crossfade else None
    y = crossfade_tails(Yn, Yp, B)  # (n, 2, B)
    if out is None:
        out = xb.new_zeros((2, nb * B))
    out[:, start * B:stop * B] = y.transpose(0, 1).reshape(2, -1)
    return out

#!/usr/bin/env python3
"""Drive tinaural_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run on any error (nothing is caught):
  1. device: require CUDA, print the card, its power limit and the toolchain;
  2. build the kernels of tinaural_torch/csrc/ (timed), printing every
     instance's ptxas registers and spills (the cluster instances marked
     "cluster");
  3. each block-render kernel against its plain torch version at the main
     path's shapes (128-tap synthetic table, B = 1024, n_fft = 2048: one
     8192-block trajectory, 64 sources × 128 blocks with and without
     crossfade, render (m)'s 16 sources × 1024 blocks), then
     `assemble_filters` and `block_spectra_mix_inverse` in their cluster
     mode at n_fft 32768 ((j)'s 128 rows × 16,384 taps, clusters of 2)
     and 65536 (64 rows × 44,100 taps, clusters of 4) and in the split
     mode forced at (j)'s shape, each timed call after an L2 flush and
     each ≥ 100 dB against plain fp64, then at dir_rate 4 (one filter per
     group of 4 blocks: 2048 filters for the 8192-block trajectory, 8 for
     30 blocks in the cluster mode and in the split mode forced): SNR ≥
     100 dB, `overlap_add` equal in
     bits and naming the body it ran, each FFT kernel equal in bits over
     two calls, naming its buffer mode, its SNR against plain fp64
     printed;
  3b. each partitioned-convolution kernel against its plain version, SNR
     ≥ 100 dB, each line naming the body it ran: the streaming step at
     128 taps (S = 1024, B = 256, P = 1) and 2048 taps (S = 64, B = 256,
     P = 9), the offline render's `frame_spectra` and `partitioned_conv`
     at 2048 taps (nb = 2048, B = 512, P = 5; again at dir_rate 4, 512
     filters) and at 44,100 taps (nb = 256, P = 87), `stream_conv` and
     `partitioned_conv` also against plain fp64 and at the register
     body's edges (B 64 and 2048) and on the radix-2 body (B 32, and B
     4096 in the split mode), `assemble_partitions` alone at
     render (j)'s 256 rows × 44,100 taps × B 512 (L = 65536, P = 87: the
     cluster mode, 4 blocks per row), its direct body (neither ITD nor
     ILD) at one room44k.streamed chunk (375 rows of the 44,100-tap
     table kept whole, B 512, its bound counted without the chain), and
     at (d)'s, (e)'s, (f)'s and (g)'s
     shapes (the shared mode's register body, checked too at the other
     rows per block), then at the register body's edges (B 64 and 2048, L
     8192, 7 rows, t_pad a multiple of B) and on the radix-2 body (B 32
     and 4096), each also ≥ 100 dB against plain fp64; the wrapper's host
     time a call at (d)'s, (e)'s and (f)'s shapes; and a chain of pushes
     that carries the delay line and the previous filter;
  3c. the block-step kernels (`block_spectra`, `spectra_inverse`, the
     per-source `overlap_add`) against their plain versions at S = 64,
     nb = 128 and at S = 32, nb = 1 (B = 1024, 128 taps), SNR ≥ 100 dB
     (≥ 130 dB for `spectra_inverse`, `overlap_add` equal in bits and
     timed after an L2 flush);
     `block_spectra` and `block_spectra_mix` at dir_rate 4 (S = 64, nb = 128, 32 filters a
     source), `block_spectra` at render (h)'s shape (4096 rows of one
     source, one filter, no crossfade) and both at the register bodies'
     edges (n_fft 128: 64 × 128 blocks of 64; n_fft 16384: 8 × 16 blocks
     of 8192), each block-step check also ≥ 100 dB against plain fp64 and
     naming the body it ran; the pruned mode (n_fft above 16384: P
     transforms of Q = max(next_pow2(B), 128) points a block) of both at
     n_fft 32768 and 65536 (16 × 64 and 8 × 64 blocks of 1024, filters of
     the 16,384- and 44,100-tap tables, crossfade) and on random spectra
     at n_fft 262144 (Q 1024, P 256) and at Q 16384 (n_fft 65536, a block
     a residue), each with the split mode forced beside it, every call
     timed after an L2 flush, ≥ 100 dB against plain fp32 and fp64 and
     equal in bits over two calls; then `spectra_inverse` alone, timed
     beside `torch.fft.irfft`, at 8192 rows × n_fft 4096, 2048 × 16384
     (the largest shared-mode FFT), 128 × 32768 and 64 × 65536 (cluster
     mode, 2 and 4 blocks per row);
  3d. the scene mixdown's `block_spectra_mix` (crossfade on and off, and one
     filter per source; each also against plain fp64, naming its body)
     with the summing `spectra_inverse` at S = 64,
     nb = 128, and the natural-order `assembly_mac` at 8192 rows (64 sources
     × 128 blocks, `first` at each source's block 0; 2048 taps, B = 1024,
     n_fft = 4096) and at render (l)'s 4096 rows (one source, 128 taps,
     B = 2048, n_fft = 4096) on its register kernel, then in its cluster
     mode at (j)'s trajectory shape (128 rows × 16,384 taps, n_fft 32768,
     clusters of 2) and at 128 rows × 44,100 taps (n_fft 65536, clusters
     of 4), and at (j)'s shape with the split mode forced (the radix-2
     body), these three timed after an L2 flush, each naming its mode,
     against their plain versions, SNR ≥ 100 dB (≥ 110 dB against plain
     fp64 for `assembly_mac`, equal in bits over two calls); then `overlap_add`
     alone, equal in bits to its plain version and timed beside its
     bound and `fold`, naming its body, at (k)'s 64 × 128 frames of n_fft
     4096 (k = 4), (l)'s 4096 × 4096 at B 2048, (j) trajectory's 128 ×
     32768 (k = 32) and (a)'s frames one float past 16-byte alignment
     (the scalar body), each timed call after an L2 flush, as in 3c;
  4. the renders through the public entry points — (a) a 2^23-sample
     trajectory and (a4) the same at dir_rate 4, (b) a 64-source moving
     scene, (b4) the same at dir_rate 4, and (c) a 64-source static
     scene of 2^17 samples each on the mixdown route, their cores timed on
     B1's route too, (m) a 16-source moving scene of 2^20 samples
     (1024 blocks, B1's route) and (n) a 64-source moving scene of 2^18
     samples at 16,384 taps (256 blocks: B1's route at n_fft 32768, both
     FFT kernels in the cluster mode; its float64 plain path run 8
     sources at a time and summed), and on that table at block 1024
     (n_fft 32768, the block step's pruned mode, Q 1024, P 32) (o) (h)'s
     static `render` at 2^20 samples (B3), (p) (c)'s 64 static and (q)
     (b)'s 64 moving sources × 2^17 (B4; B1 timed and profiled beside
     (q); float64 plain paths 8 sources at a time), and (r) (h)'s static
     `render` at 2^20 samples in blocks of 16384 (the CLI's ``--block``)
     on the 44,100-tap table (n_fft 65536, the pruned mode's Q 16384,
     P 4) — with every kernel's
     launch count read
     around them, each output held against the port's own plain path in
     float64 on the card (SNR ≥ 60 dB for (a), ≥ 100 dB for the others;
     the mixdown route's output equal in bits over two calls; a dir_rate
     4 render against the float64 plain path at dir_rate 1 on the
     snapped track, its assembly launch held to ⌈nb/4⌉ rows a source),
     and the kernel and plain float32 routes timed with CUDA events;
  4b. the same for the streaming and partitioned renders — (d) serving,
     `BatchedStream.push_many` of 1024 streams × 32 blocks; (e) BRIR
     serving, 64 streams × 8 blocks at 2048 taps, update rate 1 and 4;
     (f) 64 single `Stream.push` calls; (g) `render_streamed` of 2^20
     samples at 2048 taps, and (g4) at dir_rate 4 — (d) and (e) under
     ``torch.cuda.set_sync_debug_mode("error")``, so a host sync fails;
  4c. (h) static `render` of 2^22 samples at (123.4°, 5.6°) and one short
     call on the direct route; (i) `render_batch` of 64 requests × 2^17
     samples on moving tracks; (k) the same at 2048 taps (n_fft 4096, the
     natural-order route); (l) a 2^23-sample trajectory at block 2048
     (n_fft 4096, natural order); (j) the sizes above shared memory:
     `render_streamed` at 44,100 taps (L = 65536, P = 87) and a trajectory
     at 16,384 taps (n_fft = 32768, natural order: `assembly_mac`'s
     cluster mode; B1's split mode timed and profiled beside it), and
     (j4) the stream at dir_rate 4, and (jd) the stream on the 44,100-tap
     table kept whole (`assemble_partitions`' direct body, with its
     ``direct_partition_rows`` equal to its ``partition_rows``) — each
     against the float64 plain path (SNR ≥ 100 dB) with its exact launch
     counts;
  4d. the CLI (`tinaural_torch.cli.main`, in process, after every timing
     and before the profiles; `check_cli`), at the default table (the
     synthetic set, 128 taps), block 1024 and stream block 256, on a
     seeded int16 WAV of 2^19 samples: `render`, `sweep`, `trajectory`
     (three waypoints), `scene` (16 WAVs of 2^17 samples at 16
     directions), `stream` at update rates 1 and 4, and `render --hrir` a
     compact-KEMAR directory of the whole grid written from the synthetic
     set, each WAV within 1 int16 LSB of the port's API on the same
     inputs, ≥ 60 dB from the same subcommand with --cpu-golden, and with
     its exact launch counts; `export` then `info`; `fit` of 100 steps over
     2^15 samples against √2 × the port's own render, its parameters and
     losses on the card, its ms a step by CUDA events (one more step's
     device busy time from a profile in phase 5), and its fitted render's
     error < 0.2 × the stock table's; `python -m tinaural_torch info` in a
     subprocess;
  4e. the parallel layer (`check_parallel`) on a world-size-1 NCCL group
     initialised in process (a ``file://`` rendezvous) and a (1, 1) mesh:
     `render_scene_sharded` at (b)'s and (c)'s inputs (B4 at the
     per-shard shapes) and `ShardedBatchedStream.push_many` at (d)'s,
     update rates 1 and 4 (B7; B8 at 4), each equal in bits to the
     unsharded entry point (the streams also after a resume);
     `render_long_sharded` at (a)'s inputs (B1) and (l)'s (B9 + B2), one
     span behind a silent block, ≥ 100 dB from the float64 plain path;
     each with exactly the unsharded call's launches and its wall ms
     beside the unsharded call's; three `fit_step_sharded` steps at 4d's
     fit shape equal to `train_step`'s losses and parameters (rtol 1e-5);
     then (a)'s public call by `utils.profiling.marginal_cost` beside
     phase 4's CUDA-event core time and the card; the group destroyed;
  5. one torch.profiler window per block render, per burst of (d) and of
     (e) at update rate 1 and for (g), after every timing: device busy
     time, idle share and the largest kernels ((f)'s pushes are profiled
     in 4b, after their walls); each dir_rate 4 render's assembly kernel
     at most half its device time at dir_rate 1 ((a4) against (a), (g4)
     against (g), (j4) against (j)'s stream); then one per
     `assemble_partitions` check of 3b, per `stream_conv` check (with
     blend and as the hold step), per `frame_spectra` and
     `partitioned_conv` check, per block-step check of 3c and 3d, per
     `assembly_mac` check of 3d and per `overlap_add` shape of 3d: its
     device time a call, from a trace of 10 calls between spin kernels
     that holds all 10 (else "not measured" after three); (j)'s trajectory is profiled on B1's route too;
     last, one chrome trace of (a)'s core through `utils.profiling.trace`
     (`check_trace`), which must name B1's three kernels.
Every render reads every kernel's launch count, all set to 0 just before
it. The line before the last is the kernels' JSON record (each k-path
kernel with its dir_rate 4 check and launches under ``dir_rate_4``; each
kernel's bound: the larger of its bytes over 3.35 TB/s and its FLOPs,
FFTs counted as 5·n·log2 n, over 67 TFLOP/s fp32; the partitioned
convolution's kernels with their device ms, body and forward
transforms, `assemble_partitions` with its direct body's check beside
its bound and device ms (``direct_shape``) and its launches, device ms
and counters in (jd) (``direct_render``); the block step's two with
their device ms and body, and
`block_spectra` at (h)'s shape with its bound, each with its pruned
checks and their forced split mode (bounds by `step_work`'s least
count, the full-transform count beside) and its device ms, launches
and bound in (o) and (r), or (p) and (q); `overlap_add` with its
body, and at 3d's shapes with their bounds and device ms; B1's two FFT
kernels with their cluster mode at n_fft 32768 and 65536, their forced
split mode and the dir_rate 4 checks in both modes (each with its mode,
bound and device ms), and their device ms in (j)'s B1 route and in (n);
`assembly_mac` with its
mode and device ms, and at (l)'s and the cluster and forced split shapes
with their bounds); the last line
is ``{"ok": true, "device": {...}}``; before the kernels line, one
``{"cli": {...}}`` line holds phase 4d's walls, launches, LSB and SNR
results and the card, and one ``{"parallel": {...}}`` line phase 4e's
runs (launches, wall ms, bit equality or SNR), (a)'s marginal cost, the
card and phase 5's trace.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

SR = 44100
B = 1024
KERNEL_SNR_DB = 100.0
INVERSE_SNR_DB = 130.0  # spectra_inverse against plain fp32
MAC_FP64_SNR_DB = 110.0  # assembly_mac against plain fp64
RENDER_SNR_DB = 60.0
NEW_RENDER_SNR_DB = 100.0  # renders (b), (c), (h)–(n)
SOURCE = "tinaural_torch/csrc/block_render.cu"
# the block render's kernels → their sources
B1_SOURCES = {"assemble_filters": "tinaural_torch/csrc/assemble_filters.cu",
              "block_spectra_mix_inverse":
                  "tinaural_torch/csrc/block_mix_inverse.cu",
              "overlap_add": SOURCE}
PART_SOURCE = "tinaural_torch/csrc/partitioned.cu"
ASM_SOURCE = "tinaural_torch/csrc/assemble_partitions.cu"
STEP_SOURCE = "tinaural_torch/csrc/block_step.cu"
INVERSE_SOURCE = "tinaural_torch/csrc/spectra_inverse.cu"
MAC_SOURCE = "tinaural_torch/csrc/assembly_mac.cu"
PALLAS = "tinaural/ops/pallas_kernels.py"
# each partitioned kernel → the TPU kernels it replaces (def lines)
PART_REPLACES = {"assemble_partitions": (2215, 1710),
                 "stream_conv": (2215, 2338),
                 "frame_spectra": (1413, 1710),
                 "partitioned_conv": (1413, 1710)}
# each render of the partitioned route: its kernels' launches
PART_COUNTS = {"assemble_partitions": 1, "frame_spectra": 1,
               "partitioned_conv": 1}
FUSED_BLOCK_RENDER, FUSED_BLOCK_STEP, FUSED_EPILOGUE = 1089, 814, 2587
FUSED_BLOCK_STEP_MIX, FUSED_ASSEMBLY_MAC = 910, 354
# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def fft_flops(n: int) -> float:
    """Operations of one complex n-point FFT, by the usual 5·n·log2 n."""
    return 5.0 * n * math.log2(n)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the operations over the fp32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(tb, tf), "bound_by": "bytes" if tb >= tf
            else "operations"}


def table_bytes(table, idx) -> int:
    """Bytes of the table rows that idx names, each read once: both
    ears' taps, delays and gains."""
    rows = table.h.shape[0] * table.h.shape[1]
    per_row = table.h.numel() + table.delays.numel() + table.gains.numel()
    return 4 * per_row // rows * int(idx.unique().numel())


def assembly_work(table, idx, n_fft: int) -> dict:
    """assemble_filters: gather and lerp of 4 rows, rfft_L, ramp·gain,
    irfft_L, rfft_nfft per row."""
    F = n_fft // 2 + 1
    rows = idx.numel() // 4
    return bound(rows * 32 + table_bytes(table, idx) + rows * 2 * F * 8,
                 rows * assembly_flops(table, n_fft))


def mix_work(S: int, nb: int, B: int, n_fft: int, h_numel: int,
             crossfade: bool) -> dict:
    """block_spectra_mix_inverse: each source's block read, H read, both
    ears' frames written; a forward of each source's block, its products
    with both ears' filters (two of them under crossfade), one inverse an
    output block."""
    F = n_fft // 2 + 1
    mac = 16 if crossfade else 8
    return bound(S * nb * B * 4 + h_numel * 8 + nb * 2 * n_fft * 4,
                 S * nb * (fft_flops(n_fft) + 2 * F * mac)
                 + nb * fft_flops(n_fft))


def assembly_flops(table, n_fft: int) -> float:
    """Operations of one row's assembly: gather and lerp, rfft_L,
    ramp·gain, irfft_L, rfft_nfft."""
    L = 1 << math.ceil(math.log2(table.taps + 64))
    return (16 * table.taps + 2 * fft_flops(L) + 16 * (L // 2 + 1)
            + fft_flops(n_fft))


def ola_work(S: int, nb: int, B: int, n_fft: int) -> dict:
    out = (nb - 1) * B + n_fft
    return bound(S * nb * 2 * n_fft * 4 + S * 2 * out * 4, S * nb * 2 * n_fft)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def snr_db(ref, test) -> float:
    import torch

    ref = ref.to(torch.complex128 if ref.is_complex() else torch.float64)
    err = (ref - test.to(ref.dtype)).abs().pow(2).sum()
    return float(10.0 * torch.log10(ref.abs().pow(2).sum() / err))


def max_abs(ref, test) -> float:
    return float((ref - test.to(ref.dtype)).abs().max())


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of one call, by CUDA events, after one warm-up;
    with ``flush``, each call timed on its own after flush() (`l2_flush`)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if flush is None:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    total = 0.0
    for _ in range(reps):
        flush()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def l2_flush(dev):
    """A call that writes L2_FLUSH_BYTES on ``dev``, evicting from L2 what
    the call timed after it reads, so its inputs come from device memory
    as its byte bound assumes (a kernel whose inputs fit in L2 would
    otherwise read them from there on every repeat after the first)."""
    import torch

    if dev not in _L2_SCRATCH:
        _L2_SCRATCH[dev] = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    return _L2_SCRATCH[dev].zero_


_L2_SCRATCH = {}  # device → l2_flush's buffer, one a card


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def trajectory_dirs(nb: int):
    import numpy as np

    return np.stack([np.linspace(0, 350, nb) % 360,
                     40 * np.sin(np.linspace(0, 20, nb))],
                    axis=1).astype(np.float32)


def launch_mode(body: str, shared_f2: int, largest_fft: int,
                forced: bool) -> str:
    """The launch mode a wrapper takes on cuda:0 (`_layout.launch_mode`);
    ``forced``: the split mode forced."""
    import torch

    from tinaural_torch.ops import _layout

    limit = _layout.shared_limit(torch.device("cuda", 0))
    with forced_split(forced):
        return _layout.launch_mode(body, shared_f2, largest_fft, limit)[0]


def b1_mode(plan, shared_f2: int, forced: bool) -> str:
    """The launch mode of a kernel with a cluster mode (B1's FFT kernels,
    `assembly_mac`) at ``plan`` and ``shared_f2``."""
    return launch_mode(plan.body, shared_f2, plan.n, forced)


@contextlib.contextmanager
def forced_split(on: bool):
    """The split buffer mode forced at any shape while ``on``
    (`_layout.force_work`), the mode chosen from the shapes again after."""
    from tinaural_torch.ops import _layout

    _layout.force_work = _layout.SPLIT_WORK if on else 0
    try:
        yield
    finally:
        _layout.force_work = 0


def check_kernels(table, S: int, nb: int, crossfade: bool, label: str,
                  reps: int, dir_rate: int = 1, flush: bool = False,
                  forced: bool = False, min_fp64: float | None = None
                  ) -> dict:
    """Each kernel against its plain version on the same inputs, with one
    filter per group of ``dir_rate`` blocks: the snapped track's rows
    [::dir_rate]; each FFT kernel equal in bits over two calls and
    naming its buffer mode. ``flush``: each timed call after `l2_flush`,
    and the FFT kernels' device ms a call taken in phase 5; ``forced``:
    the split mode forced at any shape; ``min_fp64``: the SNR each FFT
    kernel must reach against plain fp64."""
    import numpy as np
    import torch

    from tinaural_torch.config import RenderConfig
    from tinaural_torch.models.renderer import (_group_dirs, _n_fft,
                                                _neighbours)
    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops._layout import sm_count
    from tinaural_torch.ops.render_plan import (filters_plan, mix_groups,
                                                mix_plan)

    dev = table.device
    n_fft = _n_fft(table, B)
    rng = np.random.default_rng(S * 7919 + nb)
    if S == 1:
        dirs = trajectory_dirs(nb)[None]
    else:
        dirs = np.stack([rng.uniform(0, 360, (S, nb)),
                         rng.uniform(-40, 90, (S, nb))], -1)
    dirs = _group_dirs(torch.tensor(dirs, dtype=torch.float32, device=dev),
                       dir_rate)
    idx, w = _neighbours(table, dirs, RenderConfig())
    xbs = torch.tensor(rng.standard_normal((S, nb, B)), dtype=torch.float32,
                       device=dev)
    flags = dict(apply_itd=True, apply_ild=True)
    mix = dict(crossfade=crossfade, dir_rate=dir_rate)
    fp, mp = filters_plan(table.taps, n_fft), mix_plan(n_fft)
    groups = mix_groups(S, nb, mp, sm_count(dev))
    modes = {"assemble_filters": b1_mode(fp, fp.shared_f2, forced),
             "block_spectra_mix_inverse": b1_mode(mp, groups * mp.group_f2,
                                                  forced)}
    fl = l2_flush(dev) if flush else None

    def assemble():
        with forced_split(forced):
            return br.assemble_filters_cuda(idx, w, table, n_fft, **flags)

    def mixdown(H):
        with forced_split(forced):
            return br.block_spectra_mix_inverse_cuda(xbs, H, n_fft, **mix)

    H = assemble()
    H_ref = br.assemble_filters_reference(idx, w, table, n_fft, **flags)
    H_64 = br.assemble_filters_reference(idx, w.double(), table, n_fft, **flags)
    frames = mixdown(H)
    frames_ref = br.block_spectra_mix_inverse_reference(xbs, H, n_fft, **mix)
    out = br.overlap_add_cuda(frames[None], B)[0]
    out_ref = br.overlap_add(frames.transpose(0, 1), B)
    torch.cuda.synchronize()
    require(torch.equal(H, assemble()) and torch.equal(frames, mixdown(H)),
            f"[{label}] B1's FFT kernels: two calls differ")

    res = {}
    for name, got, ref, kern, plain, fl_ in (
            ("assemble_filters", H, H_ref, assemble,
             lambda: br.assemble_filters_reference(idx, w, table, n_fft,
                                                   **flags), fl),
            ("block_spectra_mix_inverse", frames, frames_ref,
             lambda: mixdown(H),
             lambda: br.block_spectra_mix_inverse_reference(xbs, H, n_fft,
                                                            **mix), fl),
            ("overlap_add", out, out_ref,
             lambda: br.overlap_add_cuda(frames[None], B),
             lambda: br.overlap_add(frames.transpose(0, 1), B), None)):
        require(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                    else got).all()), f"{name} not finite")
        s = snr_db(ref, got)
        res[name] = {"snr_db": s, "max_abs_err": max_abs(ref, got),
                     "ms": cuda_ms(kern, reps, fl_),
                     "plain_ms": cuda_ms(plain, reps, fl_)}
        if name in modes:
            res[name].update(mode=modes[name], n_fft=n_fft, taps=table.taps,
                             l2_flushed=flush,
                             rows=(S * -(-nb // dir_rate)
                                   if name == "assemble_filters" else nb))
        print(f"[{label} S={S} nb={nb} crossfade={crossfade} "
              f"dir_rate={dir_rate}] {name}"
              + (f" ({modes[name]} mode)" if name in modes else "")
              + f": SNR {s:.2f} dB vs plain fp32, max abs err "
              f"{res[name]['max_abs_err']:.3e}, kernel {res[name]['ms']:.4f} ms,"
              f" plain {res[name]['plain_ms']:.4f} ms"
              + (", L2 flushed" if fl_ else ""), flush=True)
        require(s >= KERNEL_SNR_DB, f"{name} SNR {s:.2f} < {KERNEL_SNR_DB} dB")
        if flush and name in modes:
            res[name]["device_ms"] = "not measured"
            KERNEL_PROFILES.append((f"{label} ({modes[name]} mode)",
                                    res[name], "device_ms",
                                    lambda kern=kern: (fl(), kern()), None,
                                    name))
    frames_64 = br.block_spectra_mix_inverse_reference(
        xbs.double(), H.to(torch.complex128), n_fft, **mix)
    for name, ref64, got, plain in (
            ("assemble_filters", H_64, H, H_ref),
            ("block_spectra_mix_inverse", frames_64, frames, frames_ref)):
        res[name]["snr_fp64_db"] = snr_db(ref64, got)
        print(f"[{label}] {name}: SNR {res[name]['snr_fp64_db']:.2f} dB vs "
              f"plain fp64 (plain fp32: {snr_db(ref64, plain):.2f} dB), "
              "equal in bits over two calls", flush=True)
        if min_fp64 is not None:
            require(res[name]["snr_fp64_db"] >= min_fp64,
                    f"[{label}] {name}: SNR {res[name]['snr_fp64_db']:.2f} < "
                    f"{min_fp64} dB vs plain fp64")
    res["assemble_filters"].update(assembly_work(table, idx, n_fft))
    res["block_spectra_mix_inverse"].update(
        mix_work(S, nb, B, n_fft, H.numel(), crossfade))
    require(torch.equal(out, out_ref), f"[{label}] overlap_add differs "
            "in bits from the plain version")
    res["overlap_add"].update(ola_work(1, nb, B, n_fft),
                              body=ola_body(frames[None], B))
    res["overlap_add"]["library_ms"] = fold_ms(frames[None], B, reps)
    print(f"[{label}] bounds: " + ", ".join(
        f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']})" for k, v in res.items())
        + f"; overlap_add library (fold) {res['overlap_add']['library_ms']:.4f}"
        f" ms, body {res['overlap_add']['body']}, equal in bits", flush=True)
    return res


def fold_ms(frames, hop: int, reps: int, flush=None) -> float:
    """Time of `torch.nn.functional.fold`, one PyTorch call that
    overlap-adds (S, nb, 2, n) frames laid out as (S·2, n, nb), checked
    against the plain version first (``flush`` as in `cuda_ms`)."""
    import torch
    import torch.nn.functional as F

    S, nb, _, n = frames.shape
    out = (nb - 1) * hop + n
    cols = frames.permute(0, 2, 3, 1).reshape(S * 2, n, nb).contiguous()
    call = lambda: F.fold(cols, (1, out), (1, n), stride=(1, hop))
    from tinaural_torch.ops.ola import overlap_add

    ref = overlap_add(frames.transpose(1, 2), hop)
    require(torch.allclose(call().reshape(S, 2, out), ref, atol=1e-5),
            "fold is not the overlap-add")
    return cuda_ms(call, reps, flush)


B1_COUNTS = {"assemble_filters": 1, "block_spectra_mix_inverse": 1,
             "overlap_add": 1}
STEP_COUNTS = {"assemble_filters": 1, "block_spectra": 1,
               "spectra_inverse": 1, "overlap_add": 1}
MIX_COUNTS = {"assemble_filters": 1, "block_spectra_mix": 1,
              "spectra_inverse": 1, "overlap_add": 1}
MAC_COUNTS = {"assembly_mac": 1, "spectra_inverse": 1, "overlap_add": 1}
# a B1 FFT kernel check's fields in the kernels line, at the cluster and
# forced split shapes
B1_FIELDS = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
             "snr_db", "snr_fp64_db", "mode", "device_ms", "rows", "n_fft",
             "taps", "l2_flushed")
# an assembly_mac check's fields in the kernels line
MAC_FIELDS = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
              "snr_db", "snr_fp64_db", "run", "mode", "device_ms", "rows",
              "n_fft", "taps", "ranks", "concurrent", "l2_flushed")


def check_render(name: str, public_call, core_call, audio_sec: float,
                 expect: dict, launches_total: dict, reps: int,
                 min_snr: float = RENDER_SNR_DB, no_sync: bool = False,
                 other_routes: dict | None = None,
                 same_bits: bool = False, ref=None,
                 assembly_rows: tuple | None = None,
                 profile_routes: bool = False) -> dict:
    """One render through the public entry point with every launch count
    at 0 before it and exactly ``expect`` after, then the float64 plain
    check and the kernel / plain fp32 timings, both on the render core
    with the inputs already on the card. core_call(plain, dtype).
    ``other_routes``: name → core call on another route, each held against
    the same float64 output and timed; ``same_bits``: two core calls must
    give equal bits; ``ref``: the float64 output's call, by default
    core_call(True, float64); ``assembly_rows``: the shape of idx less its
    last axis that each assembly launch of the public call must take;
    ``profile_routes``: each other route is profiled in phase 5 too, its
    launches counted on one call."""
    import torch

    y, counts = _counts_after(
        lambda: _assembly_rows(public_call, name, assembly_rows), expect,
        name, launches_total, no_sync)
    require(bool(torch.isfinite(y).all()), f"render {name}: output not finite")

    y_core = core_call(False, torch.float32)
    y64 = ref() if ref else core_call(True, torch.float64)
    require(torch.equal(y, y_core[..., : y.shape[-1]]),
            f"render {name}: public call and core differ")
    if same_bits:
        require(torch.equal(y_core, core_call(False, torch.float32)),
                f"render {name}: two calls differ")
    s = snr_db(y64, y_core)
    require(s >= min_snr, f"render {name}: SNR {s:.2f} < {min_snr}")
    ms = cuda_ms(lambda: core_call(False, torch.float32), reps)
    plain_ms = cuda_ms(lambda: core_call(True, torch.float32), reps)
    res = {"snr_db_vs_plain_fp64": s, "shape": list(y.shape),
           "launches": counts, "kernel_ms": ms, "plain_fp32_ms": plain_ms,
           "kernel_audio_sec_per_sec": audio_sec / (ms / 1e3),
           "plain_fp32_audio_sec_per_sec": audio_sec / (plain_ms / 1e3)}
    if assembly_rows:
        res["assembly_rows"] = list(assembly_rows)
    print(f"[render {name}] out {tuple(y.shape)}, SNR {s:.2f} dB vs plain "
          f"fp64, launches {counts}, kernel {ms:.3f} ms = "
          f"{res['kernel_audio_sec_per_sec']:.1f} audio-s/s, plain fp32 "
          f"{plain_ms:.3f} ms = {res['plain_fp32_audio_sec_per_sec']:.1f} "
          f"audio-s/s" + (", same bits over two calls" if same_bits else ""),
          flush=True)
    for route, call in (other_routes or {}).items():
        s_r = snr_db(y64, call())
        require(s_r >= min_snr, f"render {name} on {route}: SNR {s_r:.2f}")
        ms_r = cuda_ms(call, reps)
        res[f"{route}_route"] = {"snr_db_vs_plain_fp64": s_r, "kernel_ms": ms_r,
                                 "kernel_audio_sec_per_sec":
                                     audio_sec / (ms_r / 1e3)}
        print(f"[render {name}] on {route}'s route: SNR {s_r:.2f} dB vs plain"
              f" fp64, kernel {ms_r:.3f} ms = {audio_sec / (ms_r / 1e3):.1f} "
              f"audio-s/s", flush=True)
        if profile_routes:
            res[f"{route}_route"]["launches"] = _launches_of(call)
            TO_PROFILE.append((f"{name} on {route}", res[f"{route}_route"],
                               call))
    TO_PROFILE.append((name, res, lambda: core_call(False, torch.float32)))
    return res



def scene_reference_chunked(table, xbs, dirs, cfg, chunk: int,
                            static: bool = False):
    """The moving (``static``: static) scene core's float64 plain path
    (B1's) over ``chunk`` sources at a time, the chunks' mixdowns summed in
    order: the map is linear over sources, and a chunk's float64 filters
    take 1/chunk of the whole scene's memory (16,384 rows at n_fft 32768
    would take ~8.6 GB a complex128 array)."""
    from tinaural_torch.models.renderer import _scene_core, _scene_static_core
    from tinaural_torch.ops import block_render as br

    core = _scene_static_core if static else _scene_core
    out = None
    for s0 in range(0, xbs.shape[0], chunk):
        y = core(table, xbs[s0:s0 + chunk].double(), dirs[s0:s0 + chunk],
                 cfg, render=br.block_render_reference)
        out = y if out is None else out + y
    return out


# (name, result, core call) of each block render, profiled once all renders
# are timed, so that no trace runs between two timings
TO_PROFILE = []


def profile_renders() -> None:
    """Each block render's core in a torch.profiler window: device busy
    time, idle share against its CUDA-event time, and the device time of
    its largest kernels, added to its result. A trace can come back
    missing device records, so the first of up to three that holds each of
    the port's kernels as often as the render launched it counts; else the
    last that holds each of them at all, its records of each beside its
    launches under ``traced_launches``; else "not measured". A serving
    burst's CUDA-event time is its time per block × K."""
    for name, res, fn in TO_PROFILE:
        event_ms = res.get("kernel_ms") or res["kernel_ms_per_block"] * res["K"]
        want = {f"{k}_kernel": n for k, n in res["launches"].items()}
        kept = None
        for _ in range(3):
            busy, by_kernel, count = device_breakdown(fn)
            if want.keys() <= by_kernel.keys():
                kept = busy, by_kernel, count
                if all(count[k] == n for k, n in want.items()):
                    break
        if kept is None:
            res["device_busy_ms"] = "not measured"
            print(f"[profile {name}] incomplete traces: not measured",
                  flush=True)
            continue
        busy, by_kernel, count = kept
        short = {k: f"{count[k]} of {n}" for k, n in want.items()
                 if count[k] != n}
        if short:
            res["traced_launches"] = short
            print(f"[profile {name}] records of launches in the trace: "
                  + ", ".join(f"{k} {v}" for k, v in short.items()),
                  flush=True)
        top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])
        top.update({k: by_kernel[k] for k in want})  # the port's, always
        res.update(device_busy_ms=busy, device_ms_by_kernel=top,
                   idle_share=max(0.0, 1.0 - busy / event_ms))
        print(f"[profile {name}] device busy {busy:.3f} ms of "
              f"{event_ms:.3f} (idle {100 * res['idle_share']:.0f}%): "
              + ", ".join(f"{k} {v:.3f}" for k, v in top.items()),
              flush=True)


def device_breakdown(fn) -> tuple[float, dict, dict]:
    """Device time of one call of fn from a torch.profiler trace: the sum
    of all kernel and copy times, the time by name (kernel names cut to
    their function) and the records by name. The call sits between runs of
    `PAD` spin kernels, left out of the sums (see `kernel_device_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD):
            torch.cuda._sleep(PAD_CYCLES)
        fn()
        for _ in range(PAD):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    by, count = {}, {}
    for e in prof.events():
        # a user annotation (the optimizer's step) is a range over kernels
        # on the device's timeline, not work of its own
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            name = name.split("::")[-1].strip()
            if name == "spin_kernel":
                continue
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
            count[name] = count.get(name, 0) + 1
    return sum(by.values()), by, count


# (dir_rate 4 render, its dir_rate 1 counterpart, the assembly kernel):
# phase 5 holds the kernel's device time in the first to at most half
# its time in the second
ASSEMBLY_SAVINGS = (
    (("a4_trajectory_dir_rate_4",), ("a_trajectory",), "assemble_filters"),
    (("g4_streamed_dir_rate_4",), ("g_streamed",), "assemble_partitions"),
    (("j4_streamed_44100_taps_dir_rate_4",),
     ("j_long", "streamed_44100_taps"), "assemble_partitions"))


def check_assembly_savings(renders: dict) -> None:
    """Each ASSEMBLY_SAVINGS pair's assembly device time from the profiles
    of phase 5, added to the dir_rate 4 render's result; fails where the
    dir_rate 4 time exceeds half the dir_rate 1 time. A pair whose
    profiles are incomplete is "not measured"."""
    for keys4, keys1, kernel in ASSEMBLY_SAVINGS:
        r4, r1 = renders, renders
        for k in keys4:
            r4 = r4[k]
        for k in keys1:
            r1 = r1[k]
        ms4, ms1 = (r.get("device_ms_by_kernel", {}).get(f"{kernel}_kernel")
                    for r in (r4, r1))
        if ms4 is None or ms1 is None:
            r4["assembly_device_ms"] = "not measured"
            print(f"[profile {keys4[0]}] {kernel}: not measured", flush=True)
            continue
        r4["assembly_device_ms"] = {"dir_rate_4": ms4, "dir_rate_1": ms1}
        print(f"[profile {keys4[0]}] {kernel}: device {ms4:.4f} ms at "
              f"dir_rate 4 against {ms1:.4f} at dir_rate 1 "
              f"({ms4 / ms1:.3f}×)", flush=True)
        require(ms4 <= 0.5 * ms1, f"{keys4[0]}: {kernel} {ms4:.4f} ms is "
                f"more than half its dir_rate 1 time {ms1:.4f}")


PART_FLAGS = dict(apply_itd=True, apply_ild=True)
# a table kept whole: neither flag, so assemble_partitions' direct body
NO_FLAGS = dict(apply_itd=False, apply_ild=False)


def _report(res: dict, name: str, got, ref, kern, plain, label: str,
            reps: int, work: dict | None = None, library=None,
            min_snr: float = KERNEL_SNR_DB, flush=None) -> None:
    """Hold one kernel output against its plain version (SNR ≥
    ``min_snr``), time both (and the library call, where there is one;
    ``flush`` as in `cuda_ms`); ``work`` is its bound."""
    import torch

    require(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                else got).all()), f"{name} not finite")
    s = snr_db(ref, got)
    r = {"snr_db": s, "max_abs_err": max_abs(ref, got),
         "ms": cuda_ms(kern, reps, flush),
         "plain_ms": cuda_ms(plain, reps, flush),
         "library_ms": cuda_ms(library, reps, flush) if library else None,
         **(work or {})}
    res[name] = r
    print(f"[{label}] {name}: SNR {s:.2f} dB vs plain fp32, max abs err "
          f"{r['max_abs_err']:.3e}, kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms"
          + (f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
             if work else "")
          + (f", library {r['library_ms']:.4f} ms" if library else ""),
          flush=True)
    require(s >= min_snr, f"{label} {name}: SNR {s:.2f} < {min_snr} dB")


def _rows(table, shape, seed: int):
    import numpy as np
    import torch

    from tinaural_torch.config import RenderConfig
    from tinaural_torch.models.renderer import _neighbours

    rng = np.random.default_rng(seed)
    dirs = np.stack([rng.uniform(0, 360, shape), rng.uniform(-40, 90, shape)],
                    -1).astype(np.float32)
    return _neighbours(table, torch.tensor(dirs, device=table.device),
                       RenderConfig())


def conv_mode(B: int, P: int, rows: int, dev, stream: bool) -> str:
    """The body that stream_conv (``stream``) or partitioned_conv runs at
    this shape, as the wrappers pick it."""
    from tinaural_torch.ops import _layout
    from tinaural_torch.ops.conv_plan import (conv_launch, conv_plan,
                                              stream_launch)

    sms = _layout.sm_count(dev)
    if stream:
        G, threads, f2 = stream_launch(B, P, rows, sms)
    else:
        (threads, f2), G = conv_launch(B, P, rows, sms), 1
    plan = conv_plan(B, P)
    mode = launch_mode(plan.body, f2, 2 * B, False)
    if mode != _layout.REGISTER:
        return "radix-2 body" + (", split mode" * (mode == _layout.SPLIT))
    return (f"register body, G {G}, {threads} threads a block, "
            f"{plan.part_groups(G, threads)} partition groups")


def check_stream_kernels(table, S: int, B: int, label: str, reps: int,
                         profile: bool = True) -> dict:
    """assemble_partitions, and stream_conv as update and as hold step,
    against their plain versions on one random carried state (half the
    streams started), stream_conv's output also against plain fp64; with
    ``profile``, each stream_conv's device time a call in phase 5."""
    import numpy as np
    import torch

    from tinaural_torch.ops import partitioned_conv as pc
    from tinaural_torch.ops._layout import sm_count
    from tinaural_torch.ops.conv_plan import stream_forward_transforms

    dev = table.device
    rng = np.random.default_rng(S + B + table.taps)
    idx, w = _rows(table, (S,), seed=1)
    ph_re, ph_im = pc.assemble_partitions_reference(*_rows(table, (S,), 2),
                                                    table, B, **PART_FLAGS)
    P = ph_re.shape[1]
    mode = conv_mode(B, P, S, dev, True)
    print(f"[{label}] stream_conv: P {P}, {mode}", flush=True)
    t32 = lambda *shape: torch.tensor(rng.standard_normal(shape),
                                      dtype=torch.float32, device=dev)
    xb, prev_in = t32(S, B), t32(S, B)
    fdl_re, fdl_im = t32(S, P, B + 1) * 8, t32(S, P, B + 1) * 8
    started = (torch.arange(S, device=dev) % 2).float()

    res = {}
    H = pc.assemble_partitions_cuda(idx, w, table, B, **PART_FLAGS)
    H_ref = pc.assemble_partitions_reference(idx, w, table, B, **PART_FLAGS)
    _report(res, "assemble_partitions", torch.complex(*H),
            torch.complex(*H_ref),
            lambda: pc.assemble_partitions_cuda(idx, w, table, B,
                                                **PART_FLAGS),
            lambda: pc.assemble_partitions_reference(idx, w, table, B,
                                                     **PART_FLAGS),
            label, reps, partitions_work(table, idx, B))
    H64 = pc.assemble_partitions_reference(idx, w.double(), table, B,
                                           **PART_FLAGS)
    print(f"[{label}] assemble_partitions: SNR "
          f"{snr_db(torch.complex(*H64), torch.complex(*H)):.2f} dB vs plain "
          f"fp64 (plain fp32: "
          f"{snr_db(torch.complex(*H64), torch.complex(*H_ref)):.2f} dB)",
          flush=True)

    for name, args, cf in (
            ("stream_conv", (xb, prev_in, fdl_re, fdl_im, *H, ph_re, ph_im,
                             started), True),
            ("stream_conv_hold", (xb, prev_in, fdl_re, fdl_im, ph_re, ph_im,
                                  ph_re, ph_im, started), False)):
        got = pc.stream_conv_cuda(*args, crossfade=cf)
        ref = pc.stream_conv_reference(*args, crossfade=cf)
        require(torch.equal(got[1], xb), f"{name}: prev_in' is not the block")
        for what, g, r in (("fdl_re", got[2], ref[2]), ("fdl_im", got[3], ref[3])):
            s = snr_db(r, g)
            require(s >= KERNEL_SNR_DB, f"{label} {name} {what}: SNR {s:.2f}")
        kern = lambda args=args, cf=cf: pc.stream_conv_cuda(*args,
                                                            crossfade=cf)
        _report(res, name, got[0], ref[0], kern,
                lambda: pc.stream_conv_reference(*args, crossfade=cf),
                label, reps, stream_conv_work(S, B, P, cf))
        s64 = snr_db(pc.stream_conv_reference(
            *(a.double() for a in args), crossfade=cf)[0], got[0])
        print(f"[{label}] {name}: SNR {s64:.2f} dB vs plain fp64", flush=True)
        require(s64 >= KERNEL_SNR_DB, f"{label} {name}: SNR {s64:.2f} vs "
                "plain fp64")
        res[name].update(snr_fp64_db=s64, mode=mode, forward_transforms=(
            stream_forward_transforms(B, P, S, sm_count(dev))))
        if profile:
            KERNEL_PROFILES.append((f"{label} {name}", res[name],
                                    "device_ms", kern, None, "stream_conv"))
    return res


def stream_conv_work(S: int, B: int, P: int, crossfade: bool) -> dict:
    """stream_conv's bound: each stream's block, previous input, started
    flag, delay line in and out, partitions (and the previous filter's
    when blending), output and prev_in' once; 1 + n_h FFTs of 2B and the
    MAC over P."""
    n_h = 2 if crossfade else 1  # H and the previous filter, or H alone
    return bound(S * (B * 4 * 2 + 4 + P * (B + 1) * 8 * 2
                      + n_h * P * 2 * (B + 1) * 8 + 3 * B * 4),
                 S * ((1 + n_h) * fft_flops(2 * B)
                      + n_h * P * (B + 1) * 2 * 8))


def partitions_work(table, idx, B: int, chain: bool = True) -> dict:
    """assemble_partitions: the gather, with ``chain`` the effective-filter
    chain, then P rfft_2B."""
    L = 1 << math.ceil(math.log2(table.taps + 64))
    P = -(-(table.taps + 64) // B)
    rows = idx.numel() // 4
    chain_flops = 2 * fft_flops(L) + 16 * (L // 2 + 1) if chain else 0
    return bound(rows * 32 + table_bytes(table, idx)
                 + rows * P * 2 * (B + 1) * 8,
                 rows * (16 * table.taps + chain_flops
                         + P * fft_flops(2 * B)))


def check_partition_assembly(table, rows: int, B: int, label: str,
                             reps: int, variants: bool = False,
                             flags: dict = PART_FLAGS) -> dict:
    """assemble_partitions alone against its plain fp32 and fp64 versions
    (SNR ≥ KERNEL_SNR_DB against both), timed beside its bound (without
    the chain where ``flags`` has neither ITD nor ILD). Its device time
    per call comes from a torch.profiler trace of 10 calls (the CUDA-event
    time of back-to-back calls is the host's below ~0.05 ms), taken in
    phase 5 (`KERNEL_PROFILES`). With ``variants``, the register body is
    checked and its device time taken again at the rows per block it takes
    with no SM count (the most) and at one row per block, where those
    differ from the plan's."""
    import torch

    from tinaural_torch.ops import partitioned_conv as pc
    from tinaural_torch.ops._layout import sm_count
    from tinaural_torch.ops.partitions_plan import launch, partitions_plan

    chain = flags["apply_itd"] or flags["apply_ild"]
    plan = partitions_plan(table.taps, B, chain)
    G, T, _ = launch(table.taps, B, rows, sm_count(table.device), chain)
    mode = {"cluster": f"cluster mode, {plan.ranks} blocks per row",
            "register": f"register body, {G} rows per block of {T} threads",
            "direct": f"direct body, {G} partitions per block of {T} "
                      "threads",
            }.get(plan.body, "radix-2 body")
    print(f"[{label}] L {plan.L}, P {plan.parts}, {mode}", flush=True)
    idx, w = _rows(table, (rows,), seed=5)
    kern = lambda: pc.assemble_partitions_cuda(idx, w, table, B, **flags)
    plain = lambda: pc.assemble_partitions_reference(idx, w, table, B,
                                                     **flags)
    res = {}
    H = torch.complex(*kern())
    _report(res, "assemble_partitions", H, torch.complex(*plain()), kern,
            plain, label, reps, partitions_work(table, idx, B, chain))
    H64 = torch.complex(*pc.assemble_partitions_reference(
        idx, w.double(), table, B, **flags))
    s64 = snr_db(H64, H)
    print(f"[{label}] assemble_partitions: SNR {s64:.2f} dB vs plain fp64",
          flush=True)
    require(s64 >= KERNEL_SNR_DB, f"{label}: SNR {s64:.2f} vs plain fp64")
    out = res["assemble_partitions"]
    out.update(snr_fp64_db=s64, ranks=plan.ranks, body=plan.body,
               **{"units_per_block" if plan.body == "direct"
                  else "rows_per_block": G})
    KERNEL_PROFILES.append((label, out, "device_ms", kern, None,
                            "assemble_partitions"))
    if variants and plan.body == "register":
        real = pc.sm_count
        for sms in (0, rows):  # the most rows per block, then one
            g, t, _ = launch(table.taps, B, rows, sms, chain)
            if g == G or f"G{g}_device_ms" in out:
                continue
            pc.sm_count = lambda device, sms=sms: sms
            try:
                s = snr_db(H64, torch.complex(*kern()))
            finally:
                pc.sm_count = real
            require(s >= KERNEL_SNR_DB, f"{label} at G = {g}: SNR {s:.2f}")
            out[f"G{g}_device_ms"] = "not measured"
            KERNEL_PROFILES.append((f"{label} at {g} rows per block of {t} "
                                    "threads", out, f"G{g}_device_ms", kern,
                                    sms, "assemble_partitions"))
            print(f"[{label}] at {g} rows per block of {t} threads: SNR "
                  f"{s:.2f} dB vs plain fp64", flush=True)
    return res


# (label, result, key, call, SM count to report or None, kernel) of each
# check whose kernel's device time a torch.profiler trace gives: taken in
# phase 5, after every timing, as no trace may run before a timing
KERNEL_PROFILES = []


def profile_kernels() -> None:
    """Each KERNEL_PROFILES call's kernel device time a call, into its
    result under its key."""
    from tinaural_torch.ops import partitioned_conv as pc

    real = pc.sm_count
    for label, res, key, fn, sms, kernel in KERNEL_PROFILES:
        if sms is not None:
            pc.sm_count = lambda device, sms=sms: sms
        try:
            res[key] = kernel_device_ms(fn, f"{kernel}_kernel")
        finally:
            pc.sm_count = real
        print(f"[profile {label}] {kernel}: device {res[key]} ms a call",
              flush=True)


def kernel_device_ms(fn, kernel: str, calls: int = 10):
    """Device time of ``kernel`` per call of fn (which launches it once):
    the mean over a torch.profiler trace of ``calls`` calls that holds
    every one of them; up to three traces, then "not measured". The calls
    sit between runs of `PAD` spin kernels inside the trace, so that device
    records lost at a trace's edges are the spins' and not the measured
    kernel's; a short trace prints the order of its device records (K the
    kernel, p a spin, . another kernel) and the kernel's raw count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD):
                torch.cuda._sleep(PAD_CYCLES)
            for _ in range(calls):
                fn()
            for _ in range(PAD):
                torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        dev = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        us = [e.time_range.elapsed_us() for e in dev if kernel in e.name]
        if len(us) == calls:
            return sum(us) / calls / 1e3
        raw = sum(kernel in e.name() for e in
                  prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA)
        print(f"[profile] {kernel}: {len(us)} of {calls} launches in the "
              f"trace ({raw} raw): " + "".join(
                  "K" if kernel in e.name else
                  "p" if "spin_kernel" in e.name else "." for e in dev),
              flush=True)
    return "not measured"


# spin kernels of PAD_CYCLES clock cycles (~50 µs each at 1.98 GHz) before
# and after a kernel_device_ms trace's calls: 8 of ~5 µs each lost up to 11
# records at one edge of a trace on an H100 (the kernel's among them)
PAD, PAD_CYCLES = 32, 100_000


# (label, table's taps, rows, B) of assemble_partitions' launches on the
# serving paths: a push of (d), (e) and (f)
SERVING_SHAPES = (("d", 128, 1024, 256), ("e", 2048, 64, 256),
                  ("f", 128, 1, 256))


def partition_host_us(table, rows: int, B: int, calls: int = 200) -> float:
    """The host's time per assemble_partitions_cuda call in µs: the median
    of 5 windows of ``calls`` calls with no sync between them (fewer
    launches than the card queues), so the card's time stays hidden."""
    import numpy as np
    import torch

    from tinaural_torch.ops import partitioned_conv as pc

    idx, w = _rows(table, (rows,), seed=5)
    fn = lambda: pc.assemble_partitions_cuda(idx, w, table, B, **PART_FLAGS)
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per))


def host_costs(tables: dict | None = None) -> dict:
    """partition_host_us at SERVING_SHAPES (``tables`` by taps, else the
    synthetic tables), printed. It calls the wrapper by its signature
    alone, so another checkout's wrapper is timed alike by running, from
    that checkout's root, python3 -c 'import runpy;
    runpy.run_path("<this file>")["host_costs"]()'."""
    import torch

    import tinaural_torch as tt

    if tables is None:
        tables = {n: tt.TorchTable.from_hrir_table(
                      tt.load_hrir_set("synthetic", taps=n),
                      torch.device("cuda"))
                  for n in {taps for _, taps, _, _ in SERVING_SHAPES}}
    res = {key: partition_host_us(tables[taps], rows, Bq)
           for key, taps, rows, Bq in SERVING_SHAPES}
    torch.cuda.synchronize()
    print("[assemble_partitions host µs a call] " + ", ".join(
        f"({k}) {v:.2f}" for k, v in res.items()), flush=True)
    return res


# (label, table's taps, rows, B) of the further assemble_partitions checks
# against plain: the edges of the register body (B = 64 and 2048, L =
# 8192, 7 rows, t_pad a multiple of B) and the radix-2 body outside it
# (B = 32 and 4096, the shared mode)
PARTITION_EDGES = (("B 64", 2048, 64, 64), ("B 2048", 2048, 64, 2048),
                   ("L 8192", 8000, 64, 512), ("7 rows", 2048, 7, 256),
                   ("t_pad 512", 448, 256, 256), ("B 32, radix-2", 2048, 64, 32),
                   ("B 4096, radix-2", 128, 64, 4096))


def check_partition_edges(tables: dict) -> dict:
    """assemble_partitions at PARTITION_EDGES against its plain fp32 and
    fp64 versions, SNR ≥ KERNEL_SNR_DB."""
    return {name: check_partition_assembly(
                tables[taps], rows, Bq, f"assemble_partitions {name}: "
                f"{rows} rows × {taps} taps × B {Bq}", reps=2)[
                    "assemble_partitions"]
            for name, taps, rows, Bq in PARTITION_EDGES}


def check_partitioned_kernels(table, nb: int, B: int, label: str,
                              reps: int, dir_rate: int = 1,
                              profile: bool = True) -> dict:
    """assemble_partitions per group of ``dir_rate`` blocks, frame_spectra
    (the register body's, over all nb frames) and partitioned_conv (on
    those spectra, as the render calls it) against their plain versions at
    the offline render's shape, partitioned_conv also alone (its own
    frames) against plain fp64; with ``profile``, each kernel's device
    time a call in phase 5."""
    import numpy as np
    import torch

    from tinaural_torch.ops import partitioned_conv as pc
    from tinaural_torch.ops.conv_plan import conv_plan, forward_transforms

    idx, w = _rows(table, (-(-nb // dir_rate),), seed=3)
    xb = torch.tensor(np.random.default_rng(4).standard_normal((nb, B)),
                      dtype=torch.float32, device=table.device)
    res = {}
    H = pc.assemble_partitions_cuda(idx, w, table, B, **PART_FLAGS)
    _report(res, "assemble_partitions", torch.complex(*H),
            torch.complex(*pc.assemble_partitions_reference(
                idx, w, table, B, **PART_FLAGS)),
            lambda: pc.assemble_partitions_cuda(idx, w, table, B,
                                                **PART_FLAGS),
            lambda: pc.assemble_partitions_reference(idx, w, table, B,
                                                     **PART_FLAGS),
            label, reps, partitions_work(table, idx, B))
    P = H[0].shape[1]
    mode = conv_mode(B, P, nb, table.device, False)
    print(f"[{label}] partitioned_conv: P {P}, {mode}", flush=True)
    conv = dict(crossfade=True, dir_rate=dir_rate)
    X = None
    if conv_plan(B, P).body == "register":
        X = pc.frame_spectra_cuda(xb, 0, nb)
        fs = lambda: pc.frame_spectra_cuda(xb, 0, nb)
        # the library's one call: the STFT of frames 2B apart by B, padded
        # by B zeros each side (one frame more than the kernel's)
        flat, box = xb.reshape(-1), torch.ones(2 * B, device=xb.device)
        stft = lambda: torch.stft(flat, 2 * B, hop_length=B, window=box,
                                  center=True, pad_mode="constant",
                                  return_complex=True)
        _report(res, "frame_spectra", X,
                pc.frame_spectra_reference(xb, 0, nb), fs,
                lambda: pc.frame_spectra_reference(xb, 0, nb), label, reps,
                bound(nb * B * 4 + nb * (B + 1) * 8,
                      forward_transforms(nb) * fft_flops(2 * B)), stft)
        res["frame_spectra"].update(forward_transforms=forward_transforms(nb),
                                    frames=nb, mode=mode)
        if profile:
            KERNEL_PROFILES.append((f"{label} frame_spectra",
                                    res["frame_spectra"], "device_ms", fs,
                                    None, "frame_spectra"))
    kern = lambda: pc.partitioned_conv_cuda(xb, *H, spectra=X, **conv)
    _report(res, "partitioned_conv", kern(),
            pc.partitioned_conv_reference(xb, *H, spectra=X, **conv), kern,
            lambda: pc.partitioned_conv_reference(xb, *H, spectra=X, **conv),
            label, reps, bound(
                (nb * B * 4 if X is None else X.numel() * 8)
                + H[0].numel() * 8 + 2 * nb * B * 4,
                nb * (2 * P * (B + 1) * 2 * 8 + 2 * fft_flops(2 * B))
                + (-(-P // 2) * nb if X is None else 0) * fft_flops(2 * B)))
    s64 = snr_db(pc.partitioned_conv_reference(
        xb.double(), *(h.double() for h in H), **conv),
        pc.partitioned_conv_cuda(xb, *H, **conv))
    print(f"[{label}] partitioned_conv alone (its own frames): SNR "
          f"{s64:.2f} dB vs plain fp64", flush=True)
    require(s64 >= KERNEL_SNR_DB, f"{label}: SNR {s64:.2f} vs plain fp64")
    res["partitioned_conv"].update(
        snr_fp64_db=s64, mode=mode, forward_transforms=(
            forward_transforms(nb) if X is not None
            else nb * -(-P // 2)))
    if profile:
        KERNEL_PROFILES.append((f"{label} partitioned_conv",
                                res["partitioned_conv"], "device_ms", kern,
                                None, "partitioned_conv"))
    return res


# (label, table's taps, streams, output blocks, B) of the further
# stream_conv and partitioned_conv checks: the edges of the register body
# (B 64 and 2048) and the radix-2 body outside it (B 32 in shared memory,
# B 4096 in the split mode)
CONV_EDGES = (("B 64", 2048, 7, 40, 64), ("B 2048", 128, 7, 40, 2048),
              ("B 32, radix-2", 128, 7, 40, 32),
              ("B 4096, radix-2", 128, 3, 12, 4096))


def check_conv_edges(tables: dict) -> dict:
    """stream_conv and partitioned_conv at CONV_EDGES against their plain
    fp32 and fp64 versions, SNR ≥ KERNEL_SNR_DB."""
    out = {}
    for name, taps, S, nb, Bq in CONV_EDGES:
        res = check_stream_kernels(tables[taps], S, Bq,
                                   f"stream_conv {name}: {S} streams × "
                                   f"{taps} taps", reps=2, profile=False)
        res.update(check_partitioned_kernels(
            tables[taps], nb, Bq, f"partitioned_conv {name}: {nb} blocks × "
            f"{taps} taps", reps=2, profile=False))
        out[name] = {k: {f: m[f] for f in ("ms", "snr_db", "snr_fp64_db",
                                           "mode") if f in m}
                     for k, m in res.items() if k != "assemble_partitions"}
    return out


def step_fft_flops(n: int, B_: int) -> float:
    """Operations of one block step's forward transform: a block of B_
    samples zero-padded to n is P = n/Q transforms of Q = max(next_pow2(B_),
    128) points (capped at n) of the pre-twiddled block, 5·n·log2 Q, the
    least work whatever implements it (`fft_flops(n)` counts 5·n·log2 n)."""
    from tinaural_torch.ops.step_plan import pruned_q

    return 5.0 * n * math.log2(min(n, pruned_q(B_)))


def step_work(S: int, nb: int, B_: int, n: int, h_numel: int,
              crossfade: bool, chunks: int | None = None,
              full: bool = False) -> dict:
    """block_spectra, or with ``chunks`` (its C partials) block_spectra_mix:
    the blocks and H read once, the spectra written once (S·nb rows, or the
    mix's nb sums over the sources); a forward a block of 2.5·n·log2 Q, a
    real block, or under crossfade 5·n·log2 Q, both ramps in one complex
    transform (`step_fft_flops`: the least work for a zero-padded block);
    its products with both ears' filters, 6 flops an ear and bin, 14 under
    crossfade (two products and their sum), 2 more in the mix for the
    source sum. ``full``: the full-transform count, kept beside it (5·n·
    log2 n a forward, 8 or 16 flops an ear and bin, the mix's C·nb partials
    written)."""
    F = n // 2 + 1
    mix = chunks is not None
    if full:
        fft, mac = fft_flops(n), 16 if crossfade else 8
        out = chunks * nb if mix else S * nb
    else:
        fft = step_fft_flops(n, B_) * (1.0 if crossfade else 0.5)
        mac = (14 if crossfade else 6) + (2 if mix else 0)
        out = nb if mix else S * nb
    return bound(S * nb * B_ * 4 + h_numel * 8 + out * 2 * F * 8,
                 S * nb * (fft + 2 * F * mac))


def step_body(n_fft: int, mix: bool, rows: int, dev, chunk: int = 1,
              B_: int | None = None, forced: bool = False) -> str:
    """The body that block_spectra (``mix`` False, over ``rows`` rows) or
    block_spectra_mix (``rows`` CUDA blocks of chunks of ``chunk``
    sources) runs at this shape over blocks of ``B_`` samples, as the
    wrappers pick it (``forced``: the split mode forced)."""
    from tinaural_torch.ops import _layout
    from tinaural_torch.ops.step_plan import (mix_groups, pruned_plan,
                                              spectra_rows, step_plan)

    pruned = pruned_plan(n_fft, mix, B_ or n_fft)
    if pruned is not None and launch_mode(pruned.body, pruned.shared_f2, n_fft,
                                          forced) == _layout.PRUNED:
        return (f"pruned body, Q {pruned.Q}, P {pruned.P}: "
                f"{pruned.groups} residue groups of {pruned.residues} "
                f"transforms a row, {pruned.threads} threads a block, "
                f"{pruned.resident_blocks()} blocks an SM"
                + (f", chunks of {chunk} sources" if mix else ""))
    plan = step_plan(n_fft, mix)
    sms = _layout.sm_count(dev)
    per = (mix_groups(plan, chunk, rows, sms) if mix
           else spectra_rows(plan, rows, sms))
    mode = launch_mode(plan.body, plan.shared_f2(per), n_fft, forced)
    if mode != _layout.REGISTER:
        return "radix-2 body" + (", split mode" * (mode == _layout.SPLIT))
    what = "groups" if mix else "rows"
    return (f"register body, {per} {what} of {plan.threads} threads a block, "
            f"{plan.resident_blocks(per)} blocks an SM"
            + (f", chunks of {chunk} sources" if mix else ""))


def check_step(res: dict, name: str, xbs, H, n_fft: int, label: str,
               reps: int, chunk: int | None = None, profile: bool = True,
               forced: bool = False, flush: bool = False, **kw) -> dict:
    """block_spectra (or, with ``chunk``, block_spectra_mix) against its
    plain fp32 version (SNR ≥ KERNEL_SNR_DB, timed beside its bound) and
    its plain fp64 version (≥ KERNEL_SNR_DB), equal in bits over two
    calls, naming the body it ran; ``forced``: the split mode forced;
    ``flush``: each timed call after `l2_flush`; with ``profile``, its
    device time a call in phase 5. Its bound is `step_work`'s, the
    full-transform count (5·n·log2 n a forward) beside it."""
    import torch

    from tinaural_torch.ops import block_step as bs

    S, nb, B_ = xbs.shape
    mix = chunk is not None
    if mix:
        kw["chunk"] = chunk
    kern_fn = bs.block_spectra_mix_cuda if mix else bs.block_spectra_cuda
    plain_fn = (bs.block_spectra_mix_reference if mix
                else bs.block_spectra_reference)

    def kern():
        with forced_split(forced):
            return kern_fn(xbs, H, n_fft, **kw)

    plain = lambda: plain_fn(xbs, H, n_fft, **kw)
    got = kern()
    require(torch.equal(got, kern()), f"{label} {name}: two calls differ")
    body = step_body(n_fft, mix, got.shape[0] * nb if mix else S * nb,
                     xbs.device, chunk or 1, B_, forced)
    print(f"[{label}] {name}: {body}", flush=True)
    work = dict(S=S, nb=nb, B_=B_, n=n_fft, h_numel=H.numel(),
                crossfade=kw["crossfade"],
                chunks=got.shape[0] if mix else None)
    fl = l2_flush(xbs.device) if flush else None
    _report(res, name, got, plain(), kern, plain, label, reps,
            step_work(**work), flush=fl)
    s64 = snr_db(plain_fn(xbs.double(), H.to(torch.complex128), n_fft,
                          **kw), got)
    nlogn = step_work(**work, full=True)
    print(f"[{label}] {name}: SNR {s64:.2f} dB vs plain fp64, equal in bits "
          f"over two calls; bound by the full-transform count (5·n·log2 n) "
          f"{nlogn['bound_ms']:.4f} ms ({nlogn['bound_by']})", flush=True)
    require(s64 >= KERNEL_SNR_DB, f"{label} {name}: SNR {s64:.2f} vs plain "
            "fp64")
    res[name].update(snr_fp64_db=s64, body=body, device_ms="not measured",
                     bound_nlogn_ms=nlogn["bound_ms"], l2_flushed=flush,
                     n_fft=n_fft, rows=S * nb, B=B_)
    if profile:
        KERNEL_PROFILES.append((f"{label} {name}", res[name], "device_ms",
                                (lambda: (fl(), kern())) if flush else kern,
                                None, "block_spectra_mix" if mix
                                else "block_spectra"))
    return res[name]


def check_step_kernels(table, S: int, nb: int, label: str, reps: int) -> dict:
    """block_spectra, spectra_inverse and the per-source overlap_add
    against their plain fp32 versions on one set of inputs, with S − 1
    source boundaries inside the rows."""
    import numpy as np
    import torch

    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs

    n_fft = 2048
    F = n_fft // 2 + 1
    idx, w = _rows(table, (S, nb), seed=S + nb)
    xbs = torch.tensor(np.random.default_rng(nb).standard_normal((S, nb, B)),
                       dtype=torch.float32, device=table.device)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **PART_FLAGS)
    res = {}
    check_step(res, "block_spectra", xbs, H, n_fft, label, reps,
               crossfade=True)
    Y = bs.block_spectra_cuda(xbs, H, n_fft, crossfade=True)
    frames = bs.spectra_inverse_cuda(Y, n_fft)
    _report(res, "spectra_inverse", frames,
            bs.spectra_inverse_reference(Y, n_fft),
            lambda: bs.spectra_inverse_cuda(Y, n_fft),
            lambda: bs.spectra_inverse_reference(Y, n_fft), label, reps,
            bound(S * nb * (2 * F * 8 + 2 * n_fft * 4),
                  S * nb * fft_flops(n_fft)),
            library=lambda: torch.fft.irfft(Y, n=n_fft),
            min_snr=INVERSE_SNR_DB)
    check_ola(res, "overlap_add", frames, B, label, reps)
    return res


def ola_body(frames, hop: int) -> str:
    """The body of `overlap_add` that its plan takes for these frames
    (the wrapper's out is allocated 16-byte aligned)."""
    from tinaural_torch.ops.ola_plan import ALIGN_BYTES, ola_plan

    S, nb, _, n = frames.shape
    return ola_plan(S, nb, hop, n, frames.data_ptr() % ALIGN_BYTES == 0).body


def check_ola(res: dict, name: str, frames, hop: int, label: str, reps: int,
              profile: bool = False) -> None:
    """`overlap_add` on (S, nb, 2, n) frames: equal in bits to its plain
    float32 version, timed beside its bound and `fold`, naming its body;
    with ``profile`` its device time a call is taken in phase 5. Every
    timed call follows an L2 flush (`l2_flush`): the frames of the smaller
    shapes fit in L2, and read from there they would beat the byte
    bound."""
    import torch

    from tinaural_torch.ops import block_render as br

    kern = lambda: br.overlap_add_cuda(frames, hop)
    plain = lambda: br.overlap_add(frames.transpose(1, 2), hop)
    flush = l2_flush(frames.device)
    got, ref = kern(), plain()
    S, nb, _, n = frames.shape
    _report(res, name, got, ref, kern, plain, label, reps,
            ola_work(S, nb, hop, n), flush=flush)
    require(torch.equal(got, ref), f"[{label}] {name} differs in bits from "
            "the plain version")
    res[name].update(body=ola_body(frames, hop), l2_flushed=True,
                     library_ms=fold_ms(frames, hop, reps, flush))
    print(f"[{label}] {name}: body {res[name]['body']}, equal in bits; "
          f"library (fold) {res[name]['library_ms']:.4f} ms", flush=True)
    if profile:
        KERNEL_PROFILES.append((f"{label} {name}", res[name], "device_ms",
                                lambda: (flush(), kern()), None,
                                "overlap_add"))


# (label, S, nb, B, n_fft, frames offset in floats) of the further
# overlap_add checks: (k)'s 64 × 128 frames at n_fft 4096 (k = 4), (l)'s
# 4096 × 4096 at B 2048, (j) trajectory's 128 × 32768 (k = 32), and (a)'s
# frames from a pointer one float past 16-byte alignment (the scalar body)
OLA_SHAPES = (("k", 64, 128, 1024, 4096, 0), ("l", 1, 4096, 2048, 4096, 0),
              ("j", 1, 128, 1024, 32768, 0),
              ("a off alignment", 1, 8192, 1024, 2048, 1))


def check_ola_shapes(dev, reps: int) -> dict:
    """`overlap_add` alone at OLA_SHAPES on seeded random frames."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(14)
    res = {}
    for key, S, nb, hop, n, offset in OLA_SHAPES:
        flat = torch.randn(offset + S * nb * 2 * n, generator=g, device=dev)
        frames = flat[offset:].view(S, nb, 2, n)
        check_ola(res, key, frames, hop, f"overlap_add {key}: {S} × {nb} "
                  f"frames, B {hop}, n_fft {n}", reps, profile=True)
    return res


# (label, n_fft, S, nb, B, one filter a source, crossfade) of the further
# block-step checks: render (h)'s shape (4096 rows of one source, one
# filter, no crossfade) and the register bodies' edges, n_fft 128 and 16384
STEP_SHAPES = (("h", 2048, 1, 4096, 1024, True, False),
               ("n_fft 128", 128, 64, 128, 64, False, True),
               ("n_fft 16384", 16384, 8, 16, 8192, False, True))


def check_step_shapes(table, reps: int) -> dict:
    """block_spectra at STEP_SHAPES, and block_spectra_mix on the scene
    route's chunk at the edges, against their plain fp32 and fp64
    versions, each naming its body; the filters made by assemble_filters
    from the synthetic table at (h)'s shape, seeded random spectra at the
    edges (n_fft 128 is below the table's taps + 64 + B)."""
    import numpy as np
    import torch

    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops._layout import sm_count

    dev = table.device
    out = {}
    for key, n_fft, S, nb, B_, one, cf in STEP_SHAPES:
        rng = np.random.default_rng(n_fft + nb)
        xbs = torch.tensor(rng.standard_normal((S, nb, B_)),
                           dtype=torch.float32, device=dev)
        F, k = n_fft // 2 + 1, nb if one else 1
        if key == "h":
            idx, w = _rows(table, (S, 1), seed=3)
            H = br.assemble_filters_cuda(idx, w, table, n_fft, **PART_FLAGS)
        else:
            H = torch.tensor(rng.standard_normal((S, nb, 2, F))
                             + 1j * rng.standard_normal((S, nb, 2, F)),
                             dtype=torch.complex64, device=dev)
        label = f"block step {key}: {S} × {nb} blocks of {B_}, n_fft {n_fft}"
        res = {}
        check_step(res, "block_spectra", xbs, H, n_fft, label, reps,
                   crossfade=cf, dir_rate=k)
        if key != "h":
            check_step(res, "block_spectra_mix", xbs, H, n_fft, label, reps,
                       chunk=bs.mix_chunk(S, nb, n_fft, sm_count(dev), B_,
                                          cf),
                       crossfade=cf, dir_rate=k)
        out[key] = res
    return out


# (label, S, nb, B, n_fft) of the pruned checks on seeded random spectra:
# the edge n_fft 262144 (Q 1024, P 256) and Q 16384 at 65536 (P 4: a block
# a residue, its mirror's transform first)
PRUNED_EDGES = (("n_fft 262144", 2, 8, 1024, 1 << 18),
                ("Q 16384", 2, 4, 16384, 1 << 16))


def check_pruned_kernels(tables: dict, reps: int) -> dict:
    """block_spectra and block_spectra_mix in their pruned mode (n_fft
    above 16384) and, beside each in the same run, with the split mode
    forced: at n_fft 32768 and 65536 on 16 × 64 and 8 × 64 blocks of B
    with filters from the 16,384- and 44,100-tap tables (crossfade, a
    filter a block; at 32768 also without crossfade, two blocks a
    transform), then at PRUNED_EDGES on random spectra; each timed after
    an L2 flush, against plain fp32 and fp64, equal in bits over two
    calls, naming its body, its device ms a call in phase 5."""
    import numpy as np
    import torch

    from tinaural_torch.models.renderer import _n_fft
    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops._layout import sm_count

    out = {}
    shapes = [(f"n_fft {_n_fft(t, B)}", t, S, nb, B, _n_fft(t, B))
              for t, S, nb in ((tables[16384], 16, 64),
                               (tables[44100], 8, 64))]
    shapes += [(key, None, S, nb, Bq, n) for key, S, nb, Bq, n in PRUNED_EDGES]
    for key, table, S, nb, Bq, n_fft in shapes:
        dev = tables[16384].device
        rng = np.random.default_rng(n_fft + Bq)
        xbs = torch.tensor(rng.standard_normal((S, nb, Bq)),
                           dtype=torch.float32, device=dev)
        if table is not None:
            idx, w = _rows(table, (S, nb), seed=S + nb + n_fft)
            H = br.assemble_filters_cuda(idx, w, table, n_fft, **PART_FLAGS)
        else:
            F = n_fft // 2 + 1
            H = torch.tensor(rng.standard_normal((S, nb, 2, F))
                             + 1j * rng.standard_normal((S, nb, 2, F)),
                             dtype=torch.complex64, device=dev)
        label = (f"pruned {key}: {S} × {nb} blocks of {Bq}"
                 + (f", {table.taps} taps" if table is not None else ""))
        res = {}
        # without crossfade (two blocks a transform) at the first shape
        for cf in (True, False) if key == shapes[0][0] else (True,):
            chunk = bs.mix_chunk(S, nb, n_fft, sm_count(dev), Bq, cf)
            for forced in (False, True):
                sfx = ("" if cf else "_no_crossfade") + (
                    "_split_forced" if forced else "")
                for name, ch in (("block_spectra", None),
                                 ("block_spectra_mix", chunk)):
                    m = check_step(res, name + sfx, xbs, H, n_fft, label,
                                   2 if forced else reps, chunk=ch,
                                   forced=forced, flush=True, crossfade=cf)
                    want = "radix-2 body, split mode" if forced else "pruned"
                    require(m["body"].startswith(want),
                            f"{label} {name + sfx} ran {m['body']}")
        out[key] = res
    return out


# rows × n_fft of the further spectra_inverse checks: (k)'s shape, the
# largest shared-mode FFT, (j) trajectory's shape and 65536, both in the
# cluster mode
INVERSE_SHAPES = ((8192, 4096), (2048, 16384), (128, 32768), (64, 65536))


def check_inverse_shapes(dev, reps: int) -> dict:
    """spectra_inverse against its plain fp32 version and torch.fft.irfft
    at INVERSE_SHAPES, on the spectra of seeded random frames; SNR
    ≥ INVERSE_SNR_DB."""
    import torch

    from tinaural_torch.ops import block_step as bs

    g = torch.Generator(device=dev)
    g.manual_seed(6)
    res = {}
    for rows, n_fft in INVERSE_SHAPES:
        F = n_fft // 2 + 1
        Y = torch.fft.rfft(torch.randn((rows, 2, n_fft), generator=g,
                                       device=dev))
        label = f"spectra_inverse {rows} rows n_fft {n_fft}"
        _report(res, f"{rows}x{n_fft}", bs.spectra_inverse_cuda(Y, n_fft),
                bs.spectra_inverse_reference(Y, n_fft),
                lambda: bs.spectra_inverse_cuda(Y, n_fft),
                lambda: bs.spectra_inverse_reference(Y, n_fft), label, reps,
                bound(rows * (2 * F * 8 + 2 * n_fft * 4),
                      rows * fft_flops(n_fft)),
                library=lambda: torch.fft.irfft(Y, n=n_fft),
                min_snr=INVERSE_SNR_DB)
    return res


def check_mix_kernels(table, S: int, nb: int, label: str, reps: int) -> dict:
    """block_spectra_mix with crossfade, without it, and with one filter
    per source, then the summing spectra_inverse, against their plain fp32
    versions at the scene renders' shape and source chunk."""
    import numpy as np
    import torch

    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops._layout import sm_count

    n_fft = 2048
    F = n_fft // 2 + 1
    idx, w = _rows(table, (S, nb), seed=S + nb + 1)
    xbs = torch.tensor(np.random.default_rng(nb + 1).standard_normal(
        (S, nb, B)), dtype=torch.float32, device=table.device)
    chunk = bs.mix_chunk(S, nb, n_fft, sm_count(table.device), B, True)
    C = -(-S // chunk)
    print(f"[{label}] {C} chunks of {chunk} sources: {C * nb} CUDA blocks",
          flush=True)
    res = {}
    for name, cf, one in (("block_spectra_mix", True, False),
                          ("block_spectra_mix_no_crossfade", False, False),
                          ("block_spectra_mix_one_filter", False, True)):
        i, ww = (idx[:, :1].contiguous(), w[:, :1].contiguous()) if one \
            else (idx, w)
        H = br.assemble_filters_cuda(i, ww, table, n_fft, **PART_FLAGS)
        check_step(res, name, xbs, H, n_fft, label, reps, chunk=chunk,
                   crossfade=cf, dir_rate=nb if one else 1)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **PART_FLAGS)
    P = bs.block_spectra_mix_cuda(xbs, H, n_fft, crossfade=True, chunk=chunk)
    _report(res, "spectra_inverse_summed",
            bs.spectra_inverse_cuda(P, n_fft, summed=True),
            bs.spectra_inverse_reference(P.sum(0), n_fft),
            lambda: bs.spectra_inverse_cuda(P, n_fft, summed=True),
            lambda: bs.spectra_inverse_reference(P.sum(0), n_fft), label,
            reps, bound(P.numel() * 8 + nb * 2 * n_fft * 4,
                        nb * (fft_flops(n_fft) + 2 * F * 2 * (C - 1))),
            min_snr=INVERSE_SNR_DB)
    return res


def check_group_step_kernels(table, S: int, nb: int, dir_rate: int,
                             label: str, reps: int) -> dict:
    """block_spectra and block_spectra_mix (the scene renders' source
    chunk) with one filter per group of ``dir_rate`` blocks, block b under
    row ⌊b/k⌋, against their plain fp32 and fp64 versions."""
    import numpy as np
    import torch

    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops._layout import sm_count

    n_fft = 2048
    idx, w = _rows(table, (S, -(-nb // dir_rate)), seed=S + nb + dir_rate)
    xbs = torch.tensor(np.random.default_rng(nb + dir_rate).standard_normal(
        (S, nb, B)), dtype=torch.float32, device=table.device)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **PART_FLAGS)
    chunk = bs.mix_chunk(S, nb, n_fft, sm_count(table.device), B, True)
    kw = dict(crossfade=True, dir_rate=dir_rate)
    res = {}
    check_step(res, "block_spectra", xbs, H, n_fft, label, reps, **kw)
    check_step(res, "block_spectra_mix", xbs, H, n_fft, label, reps,
               chunk=chunk, **kw)
    return res


def check_assembly_mac(table, S: int, nb: int, label: str, reps: int,
                       block: int = B, flush: bool = False,
                       forced: bool = False) -> dict:
    """assembly_mac against its plain fp32 version on S sources of nb
    blocks of ``block`` samples flattened to rows, `first` at each
    source's block 0, on the input spectra of the natural-order route;
    with crossfade also against plain fp64 (≥ MAC_FP64_SNR_DB) and equal
    in bits over two calls, its device ms a call taken in phase 5.
    ``flush``: each timed call after `l2_flush`; ``forced``: the split
    mode forced at any shape."""
    import numpy as np
    import torch

    from tinaural_torch.models.renderer import _n_fft
    from tinaural_torch.ops import _layout
    from tinaural_torch.ops import assembly_mac as am
    from tinaural_torch.ops.mac_plan import mac_plan

    n_fft = _n_fft(table, block)
    F = n_fft // 2 + 1
    rows = S * nb
    idx, w = _rows(table, (rows,), seed=rows + 2)
    xbs = torch.tensor(np.random.default_rng(rows).standard_normal(
        (S, nb, block)), dtype=torch.float32, device=table.device)
    Xu, Xd = am._input_spectra(xbs, n_fft, True)
    first = am._first_rows(S, nb, table.device)
    plan = mac_plan(table.taps, n_fft)
    mode = b1_mode(plan, plan.shared_f2, forced)
    slots = (_layout.cluster_slots(table.device, "tt_assembly_mac_clusters",
                                   n_fft) if mode == "cluster"
             else _layout.sm_count(table.device) * plan.blocks_per_sm)
    run = am.run_length(rows, slots)
    shape = (f"clusters of {plan.ranks} × {plan.threads} threads, {slots} "
             "at once" if mode == "cluster" else
             f"{plan.threads} threads × {plan.blocks_per_sm} blocks per SM")
    print(f"[{label}] n_fft {n_fft}, L {plan.L}, {mode} mode, {shape}, "
          f"{rows} rows in runs of {run}: {1 + 1 / run:.3f} assemblies per "
          "row", flush=True)
    res = {}
    fl = l2_flush(table.device) if flush else None

    def kern(cf: bool = True):
        with forced_split(forced):
            return am.assembly_mac_cuda(idx, w, table, Xu, Xd, first, n_fft,
                                        crossfade=cf, **PART_FLAGS)

    for name, cf in (("assembly_mac", True),
                     ("assembly_mac_no_crossfade", False)):
        plain = lambda cf=cf: am.assembly_mac_reference(
            idx, w, table, Xu, Xd, first, n_fft, crossfade=cf, **PART_FLAGS)
        _report(res, name, kern(cf), plain(), lambda cf=cf: kern(cf), plain,
                label, reps, bound(
                    rows * (32 + 4) + table_bytes(table, idx)
                    + rows * F * 8 * (2 if cf else 1) + rows * 2 * F * 8,
                    rows * (assembly_flops(table, n_fft)
                            + 2 * F * (14 if cf else 6))), flush=fl)
    Y = kern()
    require(torch.equal(Y, kern()), f"{label} assembly_mac: two calls differ")
    Y64 = am.assembly_mac_reference(idx, w.double(), table,
                                    Xu.to(torch.complex128),
                                    Xd.to(torch.complex128), first, n_fft,
                                    crossfade=True, **PART_FLAGS)
    s64 = snr_db(Y64, Y)
    print(f"[{label}] assembly_mac: SNR {s64:.2f} dB vs plain fp64, equal in "
          "bits over two calls", flush=True)
    require(s64 >= MAC_FP64_SNR_DB,
            f"{label} assembly_mac: SNR {s64:.2f} < {MAC_FP64_SNR_DB} dB vs fp64")
    out = res["assembly_mac"]
    out.update(run=run, snr_fp64_db=s64, mode=mode, rows=rows, n_fft=n_fft,
               taps=table.taps, ranks=plan.ranks if mode == "cluster" else 0,
               concurrent=slots, l2_flushed=flush, device_ms="not measured")
    KERNEL_PROFILES.append((label, out, "device_ms",
                            (lambda: (fl(), kern())) if flush else kern,
                            None, "assembly_mac"))
    return res


def check_stream_chain(table, S: int, B: int, n: int, label: str) -> None:
    """n chained pushes at update rate 2 through the kernels and through
    the plain float32 versions, each route carrying its own state: the
    delay line and the previous filter carry without drift."""
    import numpy as np
    import torch

    from tinaural_torch.config import RenderConfig
    from tinaural_torch.models.streaming import _batch_scan_core, init_state
    from tinaural_torch.ops import partitioned_conv as pc

    cfg = RenderConfig(stream_block=B, stream_update_rate=2)
    rng = np.random.default_rng(6)
    blocks = torch.tensor(rng.standard_normal((n, S, B)), dtype=torch.float32,
                          device=table.device)
    azs = torch.tensor(rng.uniform(0, 360, (n, S)), dtype=torch.float32,
                       device=table.device)
    els = torch.zeros_like(azs)
    st0 = init_state(table, cfg, S)
    kst, ky = _batch_scan_core(table, st0, blocks, azs, els, cfg)
    pst, py = _batch_scan_core(table, st0, blocks, azs, els, cfg,
                               pc.stream_step_reference,
                               pc.stream_hold_reference)
    snrs = [snr_db(py[i], ky[i]) for i in range(n)]
    snrs += [snr_db(p, k) for p, k in zip(pst, kst)]
    print(f"[{label}] chain of {n} pushes: per-push SNR "
          f"{min(snrs[:n]):.2f}–{max(snrs[:n]):.2f} dB, final state min "
          f"{min(snrs[n:]):.2f} dB vs the plain fp32 chain", flush=True)
    require(min(snrs) >= KERNEL_SNR_DB, f"{label}: chain SNR {min(snrs):.2f}")


def _assembly_rows(fn, name: str, want: tuple | None):
    """fn(), each launch of `assemble_filters` and `assemble_partitions`
    held to take idx of shape (*want, 4) when ``want`` is given."""
    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops import partitioned_conv as pc

    if want is None:
        return fn()
    seen = []
    spied = [(m, f) for m in (br, bs, pc) for f in ("assemble_filters_cuda",
                                                   "assemble_partitions_cuda")
             if hasattr(m, f)]
    real = {(m, f): getattr(m, f) for m, f in spied}

    def spy(kernel):
        def call(idx, *args, **kw):
            seen.append(tuple(idx.shape[:-1]))
            return kernel(idx, *args, **kw)
        return call

    for (m, f), kernel in real.items():
        setattr(m, f, spy(kernel))
    try:
        out = fn()
    finally:
        for (m, f), kernel in real.items():
            setattr(m, f, kernel)
    require(seen and all(s == tuple(want) for s in seen),
            f"render {name}: assembly launches took rows {seen}, want "
            f"{tuple(want)}")
    print(f"[render {name}] assembly launches took rows {seen}", flush=True)
    return out


def _launches_of(fn) -> dict:
    """The port's kernel launches of one call of fn (counted apart from
    the renders' totals)."""
    import torch

    from tinaural_torch.ops import assembly_mac as am
    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops import partitioned_conv as pc

    for m in (br, bs, pc, am):
        m.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: v for m in (br, bs, pc, am) for k, v in m.launches.items()
            if v}


def _counts_after(fn, expect: dict, name: str, launches_total: dict,
                  no_sync: bool):
    """Run fn with every launch count at 0 and check the counts after."""
    import torch

    from tinaural_torch.ops import assembly_mac as am
    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops import partitioned_conv as pc

    for m in (br, bs, pc, am):
        m.reset_launches()
    torch.cuda.synchronize()
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
    out = fn()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = {**br.launches, **bs.launches, **pc.launches, **am.launches}
    want = {k: expect.get(k, 0) for k in counts}
    require(counts == want, f"render {name}: launches {counts}, want {want}")
    for k, v in counts.items():
        launches_total[k] += v
    return out, {k: v for k, v in counts.items() if v}


def serving_inputs(dev, S: int, K: int, k: int):
    """A serving burst's device-staged inputs: K blocks of 256 for each of
    S streams, heads moving 2° per push → (blocks, azs, els)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(S + K + k)
    blocks = torch.tensor(rng.standard_normal((K, S, 256)),
                          dtype=torch.float32, device=dev)
    azs = torch.tensor((np.linspace(0, 350, S)[None]
                        + 2.0 * np.arange(K)[:, None]) % 360.0,
                       dtype=torch.float32, device=dev)
    return blocks, azs, torch.zeros_like(azs)


def check_serving(name: str, table, S: int, K: int, k: int,
                  launches_total: dict, reps: int) -> dict:
    """BatchedStream.push_many of K device-staged blocks per stream, heads
    moving 2° per push, with no host sync; then the float64 plain check
    and the kernel / plain fp32 timings of the same burst."""
    import torch

    import tinaural_torch as tt
    from tinaural_torch.models.streaming import StreamState, _batch_scan_core
    from tinaural_torch.ops import partitioned_conv as pc

    B = 256
    cfg = tt.RenderConfig(stream_block=B, stream_update_rate=k)
    blocks, azs, els = serving_inputs(table.device, S, K, k)
    bs = tt.BatchedStream(table, S, cfg)
    st0 = bs.state
    n_upd = -(-K // k)
    ys, counts = _counts_after(lambda: bs.push_many(blocks, azs, els),
                               {"assemble_partitions": n_upd,
                                "stream_conv": K}, name, launches_total,
                               no_sync=True)
    require(bool(torch.isfinite(ys).all()), f"render {name}: not finite")

    def core(bl, st, plain=False):
        ops = ((pc.stream_step_reference, pc.stream_hold_reference) if plain
               else (pc.stream_step, pc.stream_hold))
        return _batch_scan_core(table, st, bl, azs, els, cfg, *ops)[1]

    require(torch.equal(ys, core(blocks, st0)),
            f"render {name}: public call and core differ")
    st64 = StreamState(*(t.double() for t in st0))
    s = snr_db(core(blocks.double(), st64, plain=True), ys)
    require(s >= RENDER_SNR_DB, f"render {name}: SNR {s:.2f}")
    ms = cuda_ms(lambda: core(blocks, st0), reps) / K
    plain_ms = cuda_ms(lambda: core(blocks, st0, plain=True), reps) / K
    block_s = B / SR
    res = {"snr_db_vs_plain_fp64": s, "S": S, "K": K, "update_rate": k,
           "taps": table.taps, "launches": counts,
           "kernel_ms_per_block": ms, "plain_fp32_ms_per_block": plain_ms,
           "kernel_realtime_listeners": S * block_s / (ms / 1e3),
           "plain_fp32_realtime_listeners": S * block_s / (plain_ms / 1e3)}
    print(f"[render {name}] S={S} K={K} k={k}: SNR {s:.2f} dB vs plain fp64,"
          f" launches {counts}, no host sync; kernel {ms:.4f} ms/block = "
          f"{res['kernel_realtime_listeners']:.0f} real-time listeners, "
          f"plain fp32 {plain_ms:.4f} ms/block = "
          f"{res['plain_fp32_realtime_listeners']:.0f}", flush=True)
    if k == 1:  # the burst's device time by kernel, in phase 5
        TO_PROFILE.append((f"{name} k={k}", res, lambda: core(blocks, st0)))
    return res


def check_latency(table, n: int, launches_total: dict) -> dict:
    """n single Stream.push calls on host blocks, each read back to the
    host: wall time per push, and the device time of the same pushes."""
    import numpy as np
    import torch

    import tinaural_torch as tt
    from tinaural_torch.models.streaming import StreamState, _scan_core
    from tinaural_torch.ops import partitioned_conv as pc

    B = 256
    cfg = tt.RenderConfig(stream_block=B)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, B)).astype(np.float32)
    azs = ((30.0 + 2.0 * np.arange(n)) % 360.0).astype(np.float32)

    def pushes(s, host):
        out = []
        for i in range(n):
            y = s.push(x[i], float(azs[i]), 0.0)
            out.append(y.cpu() if host else y)
        return out

    s = tt.Stream(table, cfg)
    st0 = s.state
    ys, counts = _counts_after(lambda: pushes(s, False),
                               {"assemble_partitions": n, "stream_conv": n},
                               "f latency", launches_total, no_sync=False)
    y = torch.cat(ys, dim=-1)
    dirs = torch.tensor(np.stack([azs, np.zeros(n, np.float32)], -1),
                        device=table.device)
    xb = torch.tensor(x, device=table.device)
    st64 = StreamState(*(t.double() for t in st0))
    y64 = _scan_core(table, st64, xb.double(), dirs, cfg,
                     pc.stream_step_reference, pc.stream_hold_reference)[1]
    s64 = snr_db(y64, y)
    require(s64 >= RENDER_SNR_DB, f"render f latency: SNR {s64:.2f}")
    walls = []
    s = tt.Stream(table, cfg)
    for i in range(n):
        t0 = time.perf_counter()
        s.push(x[i], float(azs[i]), 0.0).cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy, by, _ = device_breakdown(
        lambda: pushes(tt.Stream(table, cfg), True))
    dev_ms = busy / n
    res = {"snr_db_vs_plain_fp64": s64, "pushes": n, "launches": counts,
           "wall_ms_per_push_median": float(np.median(walls)),
           "wall_ms_per_push_max": float(np.max(walls)),
           "device_ms_per_push": dev_ms if dev_ms > 0 else "not measured"}
    for k in counts:  # each kernel's device time per launch
        if f"{k}_kernel" in by:
            res[f"{k}_device_ms"] = by[f"{k}_kernel"] / n
    res["stream_conv_bound"] = stream_conv_work(
        1, B, -(-(table.taps + 64) // B), True)
    print(f"[render f latency] {n} Stream.push: SNR {s64:.2f} dB vs plain "
          f"fp64, launches {counts}; wall {res['wall_ms_per_push_median']:.3f}"
          f" ms/push median (max {res['wall_ms_per_push_max']:.3f}), device "
          f"{res['device_ms_per_push']} ms/push (profiler): "
          + ", ".join(f"{k} {res[f'{k}_device_ms']:.4f}" for k in counts
                      if f"{k}_device_ms" in res), flush=True)
    return res


def check_streamed(table, N: int, launches_total: dict, reps: int,
                   dir_rate: int = 1) -> dict:
    """render_streamed of N samples at block 512, bench.py's BRIR
    direction track; float64 plain check and both routes' throughput.
    Above ``dir_rate`` 1 the float64 check is the plain path at dir_rate 1
    on the snapped track, and the one assembly launch must take
    ⌈nb/dir_rate⌉ rows."""
    import numpy as np
    import torch

    import tinaural_torch as tt
    from tinaural_torch.models.renderer import _partitioned_core, _snap_dirs
    from tinaural_torch.ops import partitioned_conv as pc

    B = 512
    cfg = tt.RenderConfig(stream_block=B, dir_rate=dir_rate)
    nb = N // B
    x = np.random.default_rng(6).standard_normal(N).astype(np.float32)
    dirs = np.stack([np.linspace(0, 350, nb) % 360,
                     20 * np.sin(np.linspace(0, 9, nb))],
                    axis=1).astype(np.float32)
    r = tt.BinauralRenderer(table, cfg)
    name = "g streamed" + (f" dir_rate {dir_rate}" if dir_rate > 1 else "")
    rows = (-(-nb // dir_rate),)
    y, counts = _counts_after(
        lambda: _assembly_rows(lambda: r.render_streamed(x, dirs), name,
                               rows),
        PART_COUNTS, name, launches_total, no_sync=False)
    require(bool(torch.isfinite(y).all()), f"render {name}: not finite")
    xb = torch.tensor(x.reshape(nb, B), device=table.device)
    dirs_t = torch.tensor(dirs, device=table.device)
    core = lambda xx, render=pc.partitioned_render: _partitioned_core(
        table, xx, dirs_t, cfg, render=render)
    require(torch.equal(y, core(xb)),
            f"render {name}: public call and core differ")
    y64 = _partitioned_core(table, xb.double(), _snap_dirs(dirs_t, dir_rate),
                            cfg.replace(dir_rate=1),
                            render=pc.partitioned_render_reference)
    s = snr_db(y64, y)
    require(s >= RENDER_SNR_DB, f"render {name}: SNR {s:.2f}")
    ms = cuda_ms(lambda: core(xb), reps)
    plain_ms = cuda_ms(lambda: core(xb, pc.partitioned_render_reference), reps)
    res = {"snr_db_vs_plain_fp64": s, "shape": list(y.shape),
           "launches": counts, "kernel_ms": ms, "plain_fp32_ms": plain_ms,
           "kernel_audio_sec_per_sec": N / SR / (ms / 1e3),
           "plain_fp32_audio_sec_per_sec": N / SR / (plain_ms / 1e3),
           "assembly_rows": list(rows)}
    print(f"[render {name}] 2^{N.bit_length() - 1} samples, {table.taps} "
          f"taps, B={B}: SNR {s:.2f} dB vs plain fp64, launches {counts}, "
          f"kernel {ms:.3f} ms = {res['kernel_audio_sec_per_sec']:.1f} "
          f"audio-s/s, plain fp32 {plain_ms:.3f} ms = "
          f"{res['plain_fp32_audio_sec_per_sec']:.1f} audio-s/s", flush=True)
    TO_PROFILE.append((name, res, lambda: core(xb)))
    return res


def check_static(table, N: int, launches_total: dict, reps: int,
                 name: str = "h", direct: bool = True,
                 block: int = B) -> dict:
    """(h) static `render` of N samples at bench.py's direction on the
    block route, in blocks of ``block`` samples, then (``direct``) one
    short call on the direct route, which launches no kernel (`torch.fft`
    on the card)."""
    import numpy as np
    import torch

    import tinaural_torch as tt
    from tinaural_torch.models.renderer import (_static_block_core,
                                                _static_core)
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops.filters import next_pow2

    cfg = tt.RenderConfig(block_size=block)
    r = tt.BinauralRenderer(table, cfg)
    x = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    xb = torch.tensor(x.reshape(-1, block), device=table.device)
    dir2 = torch.tensor([123.4, 5.6], device=table.device)
    res = check_render(
        f"{name} static 2^{N.bit_length() - 1}"
        + (f" {table.taps} taps" if table.taps != 128 else "")
        + (f" block {block}" if block != B else ""),
        lambda: r.render(x, 123.4, 5.6),
        lambda plain, dt: _static_block_core(
            table, xb.to(dt), dir2, cfg,
            render=bs.block_step_render_reference if plain
            else bs.block_step_render),
        N / SR, STEP_COUNTS, launches_total, reps, NEW_RENDER_SNR_DB)
    if not direct:
        return res

    short = 4000  # under 8 blocks of 1024
    y, counts = _counts_after(lambda: r.render(x[:short], 123.4, 5.6), {},
                              "h direct", launches_total, no_sync=False)
    n = next_pow2(short + table.taps + 64 - 1)
    xs = torch.tensor(x[:short], device=table.device)
    y64 = _static_core(table, xs.double(), dir2, cfg, n)
    s = snr_db(y64[:, : y.shape[-1]], y)
    require(s >= NEW_RENDER_SNR_DB, f"render h direct: SNR {s:.2f}")
    ms = cuda_ms(lambda: _static_core(table, xs, dir2, cfg, n), reps)
    res["direct"] = {"samples": short, "snr_db_vs_plain_fp64": s,
                     "launches": counts, "torch_fft_ms": ms}
    print(f"[render h direct] {short} samples: SNR {s:.2f} dB vs plain fp64,"
          f" no kernel launched, {ms:.4f} ms", flush=True)
    return res


def check_batch(name: str, table, S: int, N: int, kern, plain_fn,
                expect: dict, launches_total: dict, reps: int,
                other=None) -> dict:
    """(i), (k) `render_batch` of S requests of N samples, each on its own
    moving track drawn as render (b)'s directions; ``kern`` the route the
    shapes pick, ``plain_fn`` its plain version, ``other`` another route
    timed beside it."""
    import numpy as np
    import torch

    import tinaural_torch as tt
    from tinaural_torch.models.renderer import _batch_core

    cfg = tt.RenderConfig(block_size=B)
    r = tt.BinauralRenderer(table, cfg)
    rng = np.random.default_rng(2)
    nb = N // B
    xs = rng.standard_normal((S, N)).astype(np.float32)
    dirs = np.stack([rng.uniform(0, 360, (S, nb)),
                     rng.uniform(-40, 90, (S, nb))], -1).astype(np.float32)
    xbs = torch.tensor(xs.reshape(S, nb, B), device=table.device)
    dirs_t = torch.tensor(dirs, device=table.device)
    return check_render(
        name, lambda: r.render_batch(xs, dirs),
        lambda plain, dt: _batch_core(table, xbs.to(dt), dirs_t, cfg,
                                      render=plain_fn if plain else kern),
        S * N / SR, expect, launches_total, reps, NEW_RENDER_SNR_DB,
        other_routes=other and {other.__name__: lambda: _batch_core(
            table, xbs, dirs_t, cfg, render=other)})


def check_long(long_streamed, long_traj, N: int, launches_total: dict,
               reps: int) -> dict:
    """(j) the sizes above shared memory, through the public entry points:
    `render_streamed` at 44,100 taps (stream_block 512: L = 65536, P = 87)
    and a trajectory at 16,384 taps (B = 1024: n_fft = L = 32768), N
    samples each."""
    from tinaural_torch.models.renderer import (_partitioned_core,
                                                _trajectory_core)
    from tinaural_torch.ops import assembly_mac as am
    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import partitioned_conv as pc

    return {"streamed_44100_taps": long_render(
                "j streamed 44100 taps", long_streamed, 512, N, True,
                _partitioned_core, pc.partitioned_render,
                pc.partitioned_render_reference, PART_COUNTS,
                launches_total, reps),
            "trajectory_16384_taps": long_render(
                "j trajectory 16384 taps", long_traj, 1024, N, False,
                _trajectory_core, am.assembly_mac_render,
                am.assembly_mac_render_reference, MAC_COUNTS,
                launches_total, reps, other=br.block_render,
                profile_other=True)}


def long_inputs(N: int, Bj: int):
    """(j)'s and (l)'s signal and bench.py's BRIR direction track, one
    direction a block of Bj → (x (N,), dirs (N/Bj, 2))."""
    import numpy as np

    nb = N // Bj
    x = np.random.default_rng(6).standard_normal(N).astype(np.float32)
    dirs = np.stack([np.linspace(0, 350, nb) % 360,
                     20 * np.sin(np.linspace(0, 9, nb))],
                    axis=1).astype(np.float32)
    return x, dirs


def long_render(name: str, table, Bj: int, N: int, streamed: bool, core,
                kern, plain_fn, expect: dict, launches_total: dict,
                reps: int, other=None, dir_rate: int = 1,
                profile_other: bool = False, counted: tuple = ()) -> dict:
    """One render of (j) or (l) on bench.py's BRIR direction track;
    ``other`` another route timed beside it (and profiled in phase 5 with
    ``profile_other``). Above ``dir_rate`` 1 the
    float64 check is the plain path at dir_rate 1 on the snapped track,
    and each assembly launch must take ⌈nb/dir_rate⌉ rows. ``counted``:
    program counters read around the public call, into ``counters``."""
    import torch

    import tinaural_torch as tt
    from tinaural_torch.models.renderer import _snap_dirs
    from tinaural_torch.utils import profiling

    cfg = tt.RenderConfig(block_size=Bj, stream_block=Bj, dir_rate=dir_rate)
    r = tt.BinauralRenderer(table, cfg)
    nb = N // Bj
    x, dirs = long_inputs(N, Bj)
    public = r.render_streamed if streamed else r.render_trajectory
    xb = torch.tensor(x.reshape(nb, Bj), device=table.device)
    dirs_t = torch.tensor(dirs, device=table.device)
    rows = (-(-nb // dir_rate),) if streamed else (1, -(-nb // dir_rate))
    made = {}

    def public_call():
        before = profiling.counters()
        y = public(x, dirs)
        after = profiling.counters()
        made.update({k: after.get(k, 0) - before.get(k, 0) for k in counted})
        return y

    res = check_render(
        name, public_call,
        lambda plain, dt: core(table, xb.to(dt), dirs_t, cfg,
                               render=plain_fn if plain else kern),
        N / SR, expect, launches_total, reps, NEW_RENDER_SNR_DB,
        other_routes=other and {other.__name__: lambda: core(
            table, xb, dirs_t, cfg, render=other)},
        ref=lambda: core(table, xb.double(), _snap_dirs(dirs_t, dir_rate),
                         cfg.replace(dir_rate=1), render=plain_fn),
        assembly_rows=rows if dir_rate > 1 else None,
        profile_routes=profile_other)
    if counted:
        res["counters"] = made
        print(f"[render {name}] counters of the public call: {made}",
              flush=True)
    return res


# the CLI phase: its inputs' sizes, fit's steps, and each render
# subcommand's launches from the route rules at these shapes (512 blocks of
# 1024: the static render on B3 + B2, sweeps and trajectories on B1; 16
# static sources of 128 blocks: B4; 2048 stream blocks of 256: B7 + B8,
# one assembly a push at update rate 1, one every 4 at 4)
CLI_N, CLI_SOURCES, CLI_SOURCE_N, CLI_FIT_N, CLI_FIT_STEPS = (
    1 << 19, 16, 1 << 17, 1 << 15, 100)
CLI_STREAM_BLOCKS = CLI_N // 256
CLI_STREAM_COUNTS = {
    1: {"assemble_partitions": CLI_STREAM_BLOCKS,
        "stream_conv": CLI_STREAM_BLOCKS},
    4: {"assemble_partitions": CLI_STREAM_BLOCKS // 4,
        "stream_conv": CLI_STREAM_BLOCKS}}
CLI_SNR_DB = 60.0  # a subcommand's WAV against its --cpu-golden WAV


def _wav_int16(path):
    import numpy as np
    from scipy.io import wavfile

    sr, y = wavfile.read(path)
    require(y.dtype == np.int16 and y.ndim == 2 and y.shape[1] == 2,
            f"{path}: not a stereo int16 WAV")
    return y.astype(np.int64)


def _kemar_dir(root) -> None:
    """A compact-KEMAR directory of the synthetic set over the whole grid:
    every ring's front half (az ≤ 180) as float32 stereo WAVs, the back
    half left for the loader to mirror."""
    from tinaural_torch.data import synthesize_hrirs, write_wav

    h, g = synthesize_hrirs()
    for e_i, e in enumerate(g.elevs):
        d = root / f"elev{int(e)}"
        d.mkdir()
        for a_i, az in enumerate(g.ring_azimuths(e_i)):
            if az <= 180.0:
                write_wav(d / f"H{int(e)}e{int(round(az)) % 360:03d}a.wav",
                          SR, h[e_i, a_i].T, dtype="float32")


def check_cli(table) -> dict:
    """Phase 4d: `python -m tinaural_torch`'s subcommands, called in
    process on the card at the default table (the synthetic set, 128 taps)
    and block 1024, stream block 256. Each render subcommand's WAV is held
    to within 1 int16 LSB of the port's API on the card with the same
    inputs, to ≥ CLI_SNR_DB against the same subcommand with --cpu-golden,
    and to its exact launch counts; `export` then `info` on the .npz; `fit`
    of 100 steps over 2^15 samples against a target √2 × the port's own
    render, its parameters and losses on the card (spies on
    `fit.train_step` and the CLI's `fit_hrtf`), its ms a step by CUDA
    events, and its fitted table's render error
    < 0.2 × the stock table's; `python -m tinaural_torch info` in a
    subprocess."""
    import contextlib
    import io
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    import tinaural_torch as tt
    from tinaural_torch import cli as cli_module
    from tinaural_torch.data import read_wav, write_wav
    from tinaural_torch.models import fit
    from tinaural_torch.utils import circular_sweep, waypoints_to_block_dirs

    t_phase = time.perf_counter()
    cli = cli_module.main
    cfg = tt.RenderConfig(block_size=B)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(16)
        src = tmp / "in.wav"
        write_wav(src, SR, np.clip(rng.standard_normal(CLI_N) * 0.2, -1, 1))
        _, x = read_wav(src)  # what the CLI renders
        spec, xs, dirs = [], [], []
        for i in range(CLI_SOURCES):
            p = tmp / f"src{i}.wav"
            write_wav(p, SR, np.clip(
                rng.standard_normal(CLI_SOURCE_N) * 0.2, -1, 1))
            az, el = 22.5 * i + 3.0, -30.0 + 7.5 * i  # 16 distinct
            spec.append({"wav": str(p), "az": az, "el": el})
            xs.append(read_wav(p)[1])
            dirs.append([az, el])
        scene = tmp / "scene.json"
        scene.write_text(json.dumps(spec))
        xs, dirs = np.stack(xs), np.asarray(dirs)
        kemar = tmp / "kemar"
        kemar.mkdir()
        _kemar_dir(kemar)
        kemar_table = tt.TorchTable.from_hrir_table(
            tt.load_hrir_set(str(kemar)), table.device)
        nb = CLI_N // B
        wps = [(0.0, 300.0, -20.0), (5.0, 90.0, 40.0), (11.0, 200.0, 0.0)]

        def stream_api(k):
            s = tt.Stream(table, cfg.replace(stream_block=256,
                                             stream_update_rate=k))
            return s.render_offline(x, circular_sweep(CLI_STREAM_BLOCKS,
                                                      0.0, 360.0, 0.0))

        # name → (argv after the output, the API call, launches, normalize)
        r, rk = tt.BinauralRenderer(table, cfg), tt.BinauralRenderer(
            kemar_table, cfg)
        subs = {
            "render": (["render", str(src), "--az", "123.4", "--el", "5.6"],
                       lambda: r.render(x, 123.4, 5.6), STEP_COUNTS, False),
            "sweep": (["sweep", str(src), "--start", "270", "--end", "90",
                       "--el", "10"],
                      lambda: r.render_trajectory(
                          x, circular_sweep(nb, 270.0, 90.0, 10.0)),
                      B1_COUNTS, False),
            "trajectory": (["trajectory", str(src),
                            *(a for w in wps for a in
                              ("--waypoint", ",".join(map(str, w))))],
                           lambda: r.render_trajectory(
                               x, waypoints_to_block_dirs(wps, nb, B, SR)),
                           B1_COUNTS, False),
            "scene": (["scene", str(scene)],
                      lambda: r.render_scene(xs, dirs), MIX_COUNTS, True),
            "stream_update_rate_1": (["stream", str(src), "--update-rate",
                                      "1"], lambda: stream_api(1),
                                     CLI_STREAM_COUNTS[1], False),
            "stream_update_rate_4": (["stream", str(src), "--update-rate",
                                      "4"], lambda: stream_api(4),
                                     CLI_STREAM_COUNTS[4], False),
            "render_kemar_dir": (["render", str(src), "--az", "250",
                                  "--el", "-15", "--hrir", str(kemar)],
                                 lambda: rk.render(x, 250.0, -15.0),
                                 STEP_COUNTS, False)}
        for name, (argv, api, want, normalize) in subs.items():
            out, ref, gold = (tmp / f"{name}_{k}.wav"
                              for k in ("cli", "api", "golden"))
            argv = [argv[0], argv[1], str(out), *argv[2:]]
            t0 = time.perf_counter()
            counts = _launches_of(lambda: require(cli(argv) == 0,
                                                  f"cli {name}: exit code"))
            wall = time.perf_counter() - t0
            require(counts == want, f"cli {name}: launches {counts}, want "
                    f"{want}")
            write_wav(ref, SR, api().cpu().numpy().T, normalize=normalize)
            t0 = time.perf_counter()
            require(cli([*argv[:2], str(gold), *argv[3:], "--cpu-golden"])
                    == 0, f"cli {name} --cpu-golden: exit code")
            golden_wall = time.perf_counter() - t0
            y, y_api, y_gold = (_wav_int16(p) for p in (out, ref, gold))
            require(y.shape == y_api.shape == y_gold.shape,
                    f"cli {name}: shapes {y.shape} {y_api.shape} "
                    f"{y_gold.shape}")
            lsb = int(np.abs(y - y_api).max())
            err = float(np.sum((y - y_gold).astype(np.float64) ** 2))
            snr = (float("inf") if err == 0 else float(10 * np.log10(
                np.sum(y_gold.astype(np.float64) ** 2) / err)))
            require(lsb <= 1, f"cli {name}: {lsb} LSB from the API")
            require(snr >= CLI_SNR_DB, f"cli {name}: {snr:.2f} dB from "
                    f"--cpu-golden")
            res[name] = {"wall_s": wall, "samples": int(y.shape[0]),
                         "launches": counts, "max_lsb_vs_api": lsb,
                         "snr_db_vs_cpu_golden": snr,
                         "cpu_golden_wall_s": golden_wall}
            print(f"[cli {name}] {wall:.3f} s, launches {counts}, "
                  f"{lsb} LSB from the API, {snr:.2f} dB from "
                  f"--cpu-golden ({golden_wall:.3f} s)", flush=True)

        npz = tmp / "table.npz"
        info = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(info):
            counts = _launches_of(lambda: require(
                cli(["export", str(npz)]) == 0
                and cli(["info", "--hrir", str(npz)]) == 0,
                "cli export/info: exit code"))
        require("directions:  710" in info.getvalue() and not counts,
                f"cli export/info: {info.getvalue()!r}, launches {counts}")
        res["export_info"] = {"wall_s": time.perf_counter() - t0,
                              "launches": counts}
        proc = subprocess.run(
            [sys.executable, "-m", "tinaural_torch", "info"],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        require(proc.returncode == 0 and "directions:  710" in proc.stdout,
                f"python -m tinaural_torch info: rc {proc.returncode}, "
                f"{proc.stderr[-2000:]}")
        print(f"[cli export/info] {res['export_info']['wall_s']:.3f} s; "
              f"python -m tinaural_torch info: rc 0", flush=True)

        # fit: a target √2 × the port's own render on the card
        fx = np.clip(rng.standard_normal(CLI_FIT_N) * 0.2, -1, 1)
        fsrc, ftgt, fout = tmp / "fit_src.wav", tmp / "fit_tgt.wav", \
            tmp / "fitted.npz"
        write_wav(fsrc, SR, fx, dtype="float32")
        _, fx = read_wav(fsrc)
        fdir = np.array([[75.0, 10.0]])
        y0 = r.render_scene(fx[None, :], fdir)
        target = y0 * np.sqrt(2.0)
        write_wav(ftgt, SR, target.cpu().numpy().T, dtype="float32")
        _, target_np = read_wav(ftgt)
        seen = {"losses": [], "params": None}
        # the first step's start and the last step's end on the stream
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        real_step, real_fit = fit.train_step, cli_module.fit_hrtf

        def step_spy(*a, **kw):
            if not seen["losses"]:
                start.record()
            loss = real_step(*a, **kw)
            end.record()
            seen["losses"].append(loss)
            return loss

        def fit_spy(*a, **kw):
            params, losses = real_fit(*a, **kw)
            seen["params"] = params
            return params, losses

        fit.train_step, cli_module.fit_hrtf = step_spy, fit_spy
        t0 = time.perf_counter()
        counts = _launches_of(lambda: require(
            cli(["fit", str(fsrc), str(ftgt), str(fout), "--az", "75",
                 "--el", "10", "--steps", str(CLI_FIT_STEPS)]) == 0,
            "cli fit: exit code"))
        wall = time.perf_counter() - t0
        fit.train_step, cli_module.fit_hrtf = real_step, real_fit
        step_ms = start.elapsed_time(end) / CLI_FIT_STEPS
        require(len(seen["losses"]) == CLI_FIT_STEPS
                and all(v.device.type == "cuda" for v in seen["losses"])
                and all(p.device.type == "cuda" for p in seen["params"]),
                "cli fit: parameters or losses off the card")
        require(not counts, f"cli fit: launches {counts}, want none (the "
                "loss runs the plain route)")
        fitted = tt.TorchTable.from_hrir_table(tt.load_hrir_set(str(fout)),
                                               table.device)
        yf = tt.BinauralRenderer(fitted, cfg).render_scene(fx[None, :], fdir)
        tgt = torch.tensor(target_np.T, device=table.device)
        n = min(yf.shape[-1], tgt.shape[-1])
        err_fit = float(((yf[:, :n] - tgt[:, :n]) ** 2).sum())
        err_stock = float(((y0[:, :n] - tgt[:, :n]) ** 2).sum())
        losses = [float(v) for v in seen["losses"]]
        require(err_fit < 0.2 * err_stock, f"cli fit: fitted error "
                f"{err_fit:.3e} not < 0.2 × stock {err_stock:.3e}")
        # one more step of the fitted θ, profiled in phase 5: its device
        # busy time against the CUDA-event time a step
        params = seen["params"]
        opt = torch.optim.Adam(params, lr=3e-2)
        fxb = torch.tensor(fx.reshape(1, -1, B), dtype=torch.float32,
                           device=table.device)
        fdirs = torch.tensor(np.broadcast_to(fdir[:, None], (1, fxb.shape[1],
                                                             2)).copy(),
                             dtype=torch.float32, device=table.device)
        tgt32 = tgt.float()
        step_profile = {"kernel_ms": step_ms, "launches": {}}
        TO_PROFILE.append(("cli fit step", step_profile, lambda: fit.train_step(
            params, opt, table, fxb, fdirs, tgt32, cfg)))
        res["fit"] = {"wall_s": wall, "steps": CLI_FIT_STEPS,
                      "samples": CLI_FIT_N, "ms_per_step": step_ms,
                      "loss_first": losses[0], "loss_last": losses[-1],
                      "err_fit_over_stock": err_fit / err_stock,
                      "launches": counts, "device": "cuda",
                      "step_profile": step_profile}
        print(f"[cli fit] {wall:.3f} s, {CLI_FIT_STEPS} steps at "
              f"{step_ms:.3f} ms a step (CUDA events), loss "
              f"{losses[0]:.3e} -> {losses[-1]:.3e}, fitted error "
              f"{err_fit / err_stock:.3e} × the stock table's", flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    res["card"] = card_line()
    print(f"[cli] phase {res['phase_s']:.2f} s", flush=True)
    return res


# phase 4e: the (src, blk) mesh of a group of one, and each sharded run's
# launches (those of the unsharded public call on the same inputs)
PARALLEL_STREAM_COUNTS = {1: {"assemble_partitions": 32, "stream_conv": 32},
                          4: {"assemble_partitions": 8, "stream_conv": 32}}
FIT_STEPS_4E = 3


def wall_ms(fn, reps: int = 3) -> float:
    """Mean host wall ms of fn() with the card synchronised after each
    call (the first call left out, as a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def check_parallel(table, cfg, traj: tuple, scene: tuple,
                   renders: dict) -> dict:
    """Phase 4e: the parallel layer on a world-size-1 NCCL group (a
    ``file://`` rendezvous in this process) and a (1, 1) mesh, at full
    width. ``traj`` = (a)'s (x, dirs); ``scene`` = (b)'s and (c)'s (xs,
    moving dirs, static dirs). The sharded scenes at (b) and (c) and the
    sharded streams at (d) (update rates 1 and 4) equal the unsharded
    entry points in bits; the sharded long renders at (a) and (l) (one
    span behind a silent block) are ≥ NEW_RENDER_SNR_DB from the float64
    plain path; each run launches exactly the unsharded call's kernels
    and is timed by its wall ms beside the unsharded call's; three
    `fit_step_sharded` steps at phase 4d's fit shape equal `train_step`'s
    losses and parameters to rtol 1e-5. Then (a)'s public call timed
    with `utils.profiling.marginal_cost`, beside phase 4's CUDA-event
    core time. The group is destroyed at the end."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import tinaural_torch as tt
    from tinaural_torch.models import fit
    from tinaural_torch.models.renderer import _trajectory_core
    from tinaural_torch.ops import assembly_mac as am
    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops import partitioned_conv as pc
    from tinaural_torch.parallel import (ShardedBatchedStream,
                                         fit_step_sharded, make_mesh,
                                         render_long_sharded,
                                         render_scene_sharded)
    from tinaural_torch.utils import marginal_cost

    t_phase = time.perf_counter()
    dev = table.device
    launches = dict.fromkeys(
        [*br.KERNELS, *bs.KERNELS, *pc.KERNELS, *am.KERNELS], 0)
    res = {}

    def run(name, sharded, unsharded, expect, no_sync=False):
        """The sharded call with its launches counted, the same for the
        unsharded call, then both timed → (sharded out, unsharded out,
        result)."""
        y, counts = _counts_after(sharded, expect, f"4e {name}", launches,
                                  no_sync)
        y_ref, counts_ref = _counts_after(unsharded, expect,
                                          f"4e {name} unsharded",
                                          dict.fromkeys(launches, 0), no_sync)
        require(bool(torch.isfinite(y).all()), f"4e {name}: not finite")
        r = {"launches": counts, "wall_ms": wall_ms(sharded),
             "unsharded_wall_ms": wall_ms(unsharded), "shape": list(y.shape)}
        return y, y_ref, r

    def report(name, r):
        res[name] = r
        what = (f"SNR {r['snr_db_vs_plain_fp64']:.2f} dB vs plain fp64"
                if "snr_db_vs_plain_fp64" in r else "equal in bits")
        print(f"[parallel {name}] {what}, launches {r['launches']}, wall "
              f"{r['wall_ms']:.3f} ms (unsharded {r['unsharded_wall_ms']:.3f})",
              flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh((1, 1), "cuda")
            r = tt.BinauralRenderer(table, cfg)

            # the scenes (b), (c): B4 at the per-shard shapes
            xs, dmov, dstat = scene
            for name, dirs in (("b_scene_moving", dmov),
                               ("c_scene_static", dstat)):
                y, y_ref, rr = run(
                    name, lambda: render_scene_sharded(table, xs, dirs, mesh,
                                                       cfg),
                    lambda: r.render_scene(xs, dirs), MIX_COUNTS)
                require(torch.equal(y, y_ref),
                        f"4e {name}: sharded scene differs in bits")
                rr["equal_in_bits"] = True
                report(name, rr)

            # the long renders (a) on B1 and (l) on B9 + B2, one span
            x_l, dirs_l = long_inputs(1 << 23, 2048)
            cfg_l = tt.RenderConfig(block_size=2048)
            for name, (x, dirs), c, expect, plain in (
                    ("a_trajectory", traj, cfg, B1_COUNTS,
                     br.block_render_reference),
                    ("l_trajectory_block_2048", (x_l, dirs_l), cfg_l,
                     MAC_COUNTS, am.assembly_mac_render_reference)):
                rl = tt.BinauralRenderer(table, c)
                y, _, rr = run(
                    name, lambda: render_long_sharded(table, x, dirs, mesh,
                                                      c),
                    lambda: rl.render_trajectory(x, dirs), expect)
                Bc = c.block_size
                y64 = _trajectory_core(
                    table, torch.tensor(x.reshape(-1, Bc), device=dev,
                                        dtype=torch.float64),
                    torch.tensor(dirs, device=dev), c, render=plain)
                s = snr_db(y64[:, :y.shape[-1]], y)
                require(s >= NEW_RENDER_SNR_DB,
                        f"4e {name}: SNR {s:.2f} < {NEW_RENDER_SNR_DB}")
                rr["snr_db_vs_plain_fp64"] = s
                del y64
                report(name, rr)

            # the streams (d), update rates 1 and 4 (B7, and B8 at 4)
            for k in (1, 4):
                scfg = tt.RenderConfig(stream_block=256, stream_update_rate=k)
                blocks, azs, els = serving_inputs(dev, 1024, 32, k)
                svc = ShardedBatchedStream(table, 1024, mesh, scfg)
                bst = tt.BatchedStream(table, 1024, scfg)
                st_s, st_b = svc.state, bst.state
                name = f"d_serving_k{k}"
                y, y_ref, rr = run(
                    name, lambda: svc.push_many(blocks, azs, els),
                    lambda: bst.push_many(blocks, azs, els),
                    PARALLEL_STREAM_COUNTS[k], no_sync=True)
                require(torch.equal(y, y_ref),
                        f"4e {name}: sharded streams differ in bits")
                svc.state, bst.state = st_s, st_b  # resume: equal again
                require(torch.equal(svc.push_many(blocks, azs, els), y),
                        f"4e {name}: resumed burst differs")
                rr["equal_in_bits"] = True
                report(name, rr)

            # three fit steps at phase 4d's fit shape against train_step's
            rng = np.random.default_rng(17)
            fx = np.clip(rng.standard_normal(CLI_FIT_N) * 0.2, -1,
                         1).astype(np.float32)
            fdir = np.array([[75.0, 10.0]], np.float32)
            target = r.render_scene(fx[None], fdir) * np.sqrt(2.0)
            fxb = torch.tensor(fx.reshape(1, -1, B), device=dev)
            fdirs = torch.tensor(np.broadcast_to(
                fdir[:, None], (1, fxb.shape[1], 2)).copy(), device=dev)
            out = {}
            for key, step in (("sharded", lambda p, o: fit_step_sharded(
                                  p, o, table, fxb, fdirs, target, cfg,
                                  mesh)),
                              ("train_step", lambda p, o: fit.train_step(
                                  p, o, table, fxb, fdirs, target, cfg))):
                params = fit.FitParams(*(p.requires_grad_() for p in
                                         fit.init_params(device=dev)))
                opt = torch.optim.Adam(params, lr=3e-2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                counts = _launches_of(lambda: out.__setitem__(key, (
                    [float(step(params, opt)) for _ in range(FIT_STEPS_4E)],
                    [p.detach().clone() for p in params])))
                out[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3 \
                    / FIT_STEPS_4E
                require(not counts, f"4e fit ({key}): launches {counts}, "
                        "want none (the loss runs the plain route)")
            (ls, ps), (lt, pt) = out["sharded"], out["train_step"]
            require(np.allclose(ls, lt, rtol=1e-5, atol=0)
                    and all(torch.allclose(a, b, rtol=1e-5, atol=1e-7)
                            for a, b in zip(ps, pt)),
                    f"4e fit: sharded losses {ls} or parameters differ "
                    f"from train_step's {lt}")
            res["fit"] = {"steps": FIT_STEPS_4E, "losses": ls,
                          "train_step_losses": lt, "launches": {},
                          "wall_ms_per_step": out["sharded_ms"],
                          "train_step_wall_ms_per_step":
                              out["train_step_ms"],
                          "max_abs_param_diff": max(
                              float((a - b).abs().max())
                              for a, b in zip(ps, pt))}
            print(f"[parallel fit] {FIT_STEPS_4E} steps: losses {ls} "
                  f"(train_step {lt}), params within "
                  f"{res['fit']['max_abs_param_diff']:.3e}, "
                  f"{out['sharded_ms']:.3f} ms a step (train_step "
                  f"{out['train_step_ms']:.3f})", flush=True)
        finally:
            dist.destroy_process_group()

    # (a)'s public call by marginal_cost, beside phase 4's core time
    x, dirs = traj
    mc = marginal_cost(lambda: r.render_trajectory(x, dirs))
    res["a_marginal_cost_ms"] = mc * 1e3
    res["a_core_cuda_event_ms"] = renders["a_trajectory"]["kernel_ms"]
    res["launches_total"] = {k: v for k, v in launches.items() if v}
    res["phase_s"] = time.perf_counter() - t_phase
    res["card"] = card_line()
    print(f"[parallel] (a)'s public call: marginal_cost "
          f"{res['a_marginal_cost_ms']:.3f} ms a call, phase 4's core "
          f"{res['a_core_cuda_event_ms']:.3f} ms by CUDA events; card "
          f"{res['card']}; phase {res['phase_s']:.2f} s", flush=True)
    return res


def check_trace(name: str, fn, kernels) -> dict:
    """Phase 5: one chrome trace of fn() through `utils.profiling.trace`
    into a temporary directory; every kernel of ``kernels`` must be named
    in the trace file. A trace can come back without its device events
    (as `profile_renders` finds), so up to three are taken."""
    import glob
    import json
    import os
    import tempfile

    from tinaural_torch.utils import trace

    for attempt in range(1, 4):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as d:
                fn()
            (path,) = glob.glob(os.path.join(d, "trace-*.json"))
            size = os.path.getsize(path)
            with open(path) as f:
                names = {e.get("name", "") for e in json.load(f)[
                    "traceEvents"]}
        found = {k: any(f"{k}_kernel" in n for n in names) for k in kernels}
        if all(found.values()):
            break
    require(all(found.values()),
            f"trace of {name}: kernels named {found} after {attempt} traces")
    print(f"[trace {name}] chrome trace of {size} bytes names "
          f"{', '.join(kernels)} ({attempt} trace(s))", flush=True)
    return {"bytes": size, "kernels_named": list(kernels),
            "traces_taken": attempt}


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel instance from nvcc's -Xptxas -v
    report: its name and template arguments, registers and spills."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            sym = m.group(1)
            base = re.search(r"\d+([a-z_]+_kernel)", sym)
            args = re.findall(r"L(b[01]|i\d+)E", sym)
            mark = ("cluster " if "ClusterPlan" in sym else
                    "pruned " if "6pruned" in sym else "")
            name = (base.group(1) if base else sym) + (
                "<" + mark + ",".join(a[1:] for a in args) + ">"
                if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"{m.group(1)} B spill stores, {m.group(2)} B loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return out


def kernel_entry(name: str, source: str, replaces: int, launches: int,
                 m: dict, **extra) -> dict:
    """One kernel's record in the kernels line, from its check ``m``."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": f"{PALLAS}:{replaces}", "launches": launches,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m.get("library_ms"),
            **extra}


def step_extra(m: dict, timed: bool = False) -> dict:
    """A block-step check's body, device ms a call and SNR against plain
    fp64 (``timed``: its CUDA-event ms, plain ms and bound too), for the
    kernels line."""
    keys = ("body", "device_ms", "snr_fp64_db") + (
        ("ms", "plain_ms", "bound_ms", "bound_by", "bound_nlogn_ms",
         "max_abs_err", "snr_db", "n_fft", "rows", "B", "l2_flushed")
        if timed else ())
    return {k: m[k] for k in keys}


def pruned_extra(k_pruned: dict, kernel: str, renders: dict,
                 keys: tuple) -> dict:
    """The block-step kernel's pruned checks and their forced split mode
    beside them, and its device ms and bound in the renders ``keys``, for
    the kernels line."""
    split = f"{kernel}_split_forced"
    real = f"{kernel}_no_crossfade"
    return {"pruned_shapes": {key: step_extra(m[kernel], True)
                              for key, m in k_pruned.items()},
            "pruned_split_forced": {key: step_extra(m[split], True)
                                    for key, m in k_pruned.items()},
            "pruned_no_crossfade": {key: {
                "pruned": step_extra(m[real], True),
                "split_forced": step_extra(m[f"{real}_split_forced"], True)}
                for key, m in k_pruned.items() if real in m},
            "renders": {key: {
                "device_ms": renders[key].get("device_ms_by_kernel", {}).get(
                    f"{kernel}_kernel", "not measured"),
                "bound_ms": renders[key]["bounds"][kernel]["bound_ms"],
                "bound_by": renders[key]["bounds"][kernel]["bound_by"],
                "launches": renders[key]["launches"][kernel]}
                for key in keys}}


def serving_device_ms(renders: dict, kernel: str) -> dict:
    """Device ms per launch of a streaming kernel in the profiled bursts
    of (d) and (e) at update rate 1 (the wrapper times above are bound by
    the host's time per call)."""
    out = {}
    for key in ("d_serving", "e_brir_serving_k1"):
        res = renders[key]
        by = res.get("device_ms_by_kernel", {})
        n = res["launches"].get(kernel, 0)
        out[f"{key}_device_ms"] = (by[f"{kernel}_kernel"] / n
                                   if f"{kernel}_kernel" in by and n
                                   else "not measured")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import numpy as np

    import tinaural_torch as tt
    from tinaural_torch.models.renderer import (_neighbours,
                                                _partitioned_core,
                                                _scene_core,
                                                _scene_static_core,
                                                _snap_dirs, _trajectory_core)
    from tinaural_torch.ops import _build
    from tinaural_torch.ops import assembly_mac as am
    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops import partitioned_conv as pc
    from tinaural_torch.models.renderer import _n_fft
    from tinaural_torch.ops._layout import sm_count
    from tinaural_torch.ops.render_plan import filters_plan, mix_plan
    from tinaural_torch.ops.step_plan import pruned_plan

    # 1. device
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}",
          flush=True)
    for line in ptxas_summary(lib_path.with_suffix(".log").read_text()):
        print(f"  ptxas: {line}", flush=True)

    table = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), dev)
    cfg = tt.RenderConfig(block_size=B)
    cfg4 = cfg.replace(dir_rate=4)
    t0 = time.perf_counter()
    brir, long_streamed, long_traj, t8000, t448 = (
        tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic", taps=n),
                                      dev)
        for n in (2048, 44100, 16384, 8000, 448))
    # the 44,100-tap table kept whole, as room44k's: neither ITD nor ILD
    long_whole = tt.TorchTable.from_hrir_table(
        tt.load_hrir_set("synthetic", taps=44100, decompose=False), dev)
    print(f"long tables: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    check_kernels(table, 1, 256, True, "check", reps=5)
    k_traj = check_kernels(table, 1, 8192, True, "trajectory", reps=5)
    k_scene = check_kernels(table, 64, 128, True, "scene", reps=5)
    check_kernels(table, 64, 128, False, "static scene", reps=5)
    # render (m)'s shape: 16 sources × 1024 blocks
    k_m = check_kernels(table, 16, 1024, True, "m scene", reps=5)
    # B1's cluster mode at the 16,384-tap table's n_fft 32768: (j)'s 128
    # rows (clusters of 2), the same with the split mode forced, and 64
    # rows × 44,100 taps at 65536 (clusters of 4), each timed call after
    # an L2 flush, ≥ 100 dB against plain fp64
    k_cl = check_kernels(long_traj, 1, 128, True, "cluster n_fft 32768",
                         reps=5, flush=True, min_fp64=KERNEL_SNR_DB)
    k_split = check_kernels(long_traj, 1, 128, True,
                            "split n_fft 32768 forced", reps=2, flush=True,
                            forced=True, min_fp64=KERNEL_SNR_DB)
    k_cl65 = check_kernels(long_streamed, 1, 64, True, "cluster n_fft 65536",
                           reps=5, flush=True, min_fp64=KERNEL_SNR_DB)
    # the dir_rate path: one filter per group of 4 blocks, at (a4)'s shape
    # and in the cluster mode (8 filters for 30 blocks)
    k_traj4 = check_kernels(table, 1, 8192, True, "trajectory dir_rate 4",
                            reps=5, dir_rate=4)
    k_cl4 = check_kernels(long_traj, 1, 30, True,
                          "cluster n_fft 32768 dir_rate 4", reps=2,
                          dir_rate=4, min_fp64=KERNEL_SNR_DB)
    # the split mode's ⌊b/k⌋ row map and group-start predecessor, which
    # n_fft above 131072 still takes
    k_split4 = check_kernels(long_traj, 1, 30, True,
                             "split n_fft 32768 forced dir_rate 4", reps=2,
                             dir_rate=4, forced=True, min_fp64=KERNEL_SNR_DB)
    for res, want in ((k_cl, "cluster"), (k_split, "split"),
                      (k_cl65, "cluster"), (k_cl4, "cluster"),
                      (k_split4, "split")):
        for name in ("assemble_filters", "block_spectra_mix_inverse"):
            require(res[name]["mode"] == want, f"{name} ran the "
                    f"{res[name]['mode']} mode, want {want}")

    # 3b. the partitioned-convolution kernels against their plain versions
    k_serve = check_stream_kernels(table, 1024, 256, "stream 128 taps P=1",
                                   reps=10)
    k_brir = check_stream_kernels(brir, 64, 256, "stream 2048 taps P=9",
                                  reps=10)
    k_part = check_partitioned_kernels(brir, 2048, 512,
                                       "partitioned 2048 taps P=5", reps=5)
    k_part4 = check_partitioned_kernels(
        brir, 2048, 512, "partitioned 2048 taps P=5 dir_rate 4", reps=5,
        dir_rate=4)
    k_part_long = check_partitioned_kernels(
        long_streamed, 256, 512, "partitioned 44100 taps P=87", reps=3)
    k_part_j = check_partition_assembly(long_streamed, 256, 512,
                                        "assemble_partitions 256 rows 44100 "
                                        "taps B=512", reps=5)
    # the direct body (neither ITD nor ILD) at one chunk of
    # room44k.streamed: 375 rows of the 44,100-tap table kept whole, B 512
    k_direct = check_partition_assembly(
        long_whole, 375, 512, "assemble_partitions direct 375 rows 44100 "
        "taps B=512", reps=5, flags=NO_FLAGS)["assemble_partitions"]
    require(k_direct["body"] == "direct",
            f"assemble_partitions without ITD/ILD ran the {k_direct['body']}"
            " body, want direct")
    # the shared mode's register body alone at (d)'s, (e)'s, (f)'s and
    # (g)'s shapes, then at its edges and beside the radix-2 body
    k_asm = {key: check_partition_assembly(
                 tb, rows, Bq, f"assemble_partitions ({key}) {rows} rows × "
                 f"{tb.taps} taps × B {Bq}", reps=10, variants=True)[
                     "assemble_partitions"]
             for key, tb, rows, Bq in (("d", table, 1024, 256),
                                       ("e", brir, 64, 256),
                                       ("f", table, 1, 256),
                                       ("g", brir, 2048, 512))}
    k_edges = check_partition_edges({128: table, 2048: brir, 8000: t8000,
                                     448: t448})
    k_conv_edges = check_conv_edges({128: table, 2048: brir})
    for key, us in host_costs({128: table, 2048: brir}).items():
        k_asm[key]["host_us"] = us
    check_stream_chain(brir, 64, 256, 12, "stream 2048 taps P=9")
    check_stream_chain(table, 1024, 256, 4, "stream 128 taps P=1")

    # 3c. the block-step kernels against their plain versions
    k_step = check_step_kernels(table, 64, 128, "block step S=64 nb=128",
                                reps=5)
    check_step_kernels(table, 32, 1, "block step S=32 nb=1", reps=5)
    k_step4 = check_group_step_kernels(
        table, 64, 128, 4, "block step and mix S=64 nb=128 dir_rate 4",
        reps=5)
    # render (h)'s shape, and the register bodies' edges
    k_step_shapes = check_step_shapes(table, reps=5)
    # the pruned mode above n_fft 16384, the split mode forced beside it
    k_pruned = check_pruned_kernels({16384: long_traj, 44100: long_streamed},
                                    reps=5)
    k_inverse = check_inverse_shapes(dev, reps=5)

    # 3d. the scene mixdown's and the natural-order route's kernels
    k_mix = check_mix_kernels(table, 64, 128, "mix S=64 nb=128", reps=5)
    k_mac = check_assembly_mac(brir, 64, 128,
                               "assembly_mac 8192 rows n_fft 4096", reps=5)
    # (l)'s shape: one 4096-block trajectory at block 2048, 128 taps
    k_mac_l = check_assembly_mac(table, 1, 4096,
                                 "assembly_mac 4096 rows n_fft 4096 128 taps",
                                 reps=5, block=2048)
    # (j)'s trajectory shape, 128 rows × 16,384 taps at n_fft 32768 (the
    # cluster mode, clusters of 2), 128 rows × 44,100 taps at 65536
    # (clusters of 4), and (j)'s shape with the split mode forced (the
    # radix-2 body), each timed call after an L2 flush
    k_mac_j = check_assembly_mac(long_traj, 1, 128,
                                 "assembly_mac 128 rows n_fft 32768 16384 "
                                 "taps", reps=5, flush=True)
    k_mac_j65 = check_assembly_mac(long_streamed, 1, 128,
                                   "assembly_mac 128 rows n_fft 65536 44100 "
                                   "taps", reps=5, flush=True)
    k_mac_split = check_assembly_mac(long_traj, 1, 128,
                                     "assembly_mac 128 rows n_fft 32768 "
                                     "split mode forced", reps=2, flush=True,
                                     forced=True)
    for res, want in ((k_mac, "register"), (k_mac_l, "register"),
                      (k_mac_j, "cluster"), (k_mac_j65, "cluster"),
                      (k_mac_split, "split")):
        require(res["assembly_mac"]["mode"] == want,
                f"assembly_mac ran the {res['assembly_mac']['mode']} mode, "
                f"want {want}")
    # overlap_add at (k)'s, (l)'s and (j)'s shapes and off alignment
    k_ola = check_ola_shapes(dev, reps=5)

    # 4. the renders
    r = tt.BinauralRenderer(table, cfg)
    launches = dict.fromkeys(
        [*br.KERNELS, *bs.KERNELS, *pc.KERNELS, *am.KERNELS], 0)
    renders = {}

    rng = np.random.default_rng(0)
    N = 1 << 23
    x = rng.standard_normal(N).astype(np.float32)
    dirs = trajectory_dirs(N // B)
    xb = torch.tensor(x.reshape(-1, B), device=dev)
    dirs_t = torch.tensor(dirs, device=dev)
    block_op = lambda plain: br.block_render_reference if plain else br.block_render
    mix_op = (lambda plain: bs.scene_step_render_reference if plain
              else bs.scene_step_render)
    renders["a_trajectory"] = check_render(
        "a trajectory 2^23", lambda: r.render_trajectory(x, dirs),
        lambda plain, dt: _trajectory_core(table, xb.to(dt), dirs_t, cfg,
                                           render=block_op(plain)),
        N / SR, B1_COUNTS, launches, reps=3)
    # (a4): the same at dir_rate 4 (bench.py w_traj_dir4), held against
    # the float64 plain path at dir_rate 1 on the snapped track
    r4 = tt.BinauralRenderer(table, cfg4)
    renders["a4_trajectory_dir_rate_4"] = check_render(
        "a4 trajectory 2^23 dir_rate 4", lambda: r4.render_trajectory(x, dirs),
        lambda plain, dt: _trajectory_core(table, xb.to(dt), dirs_t, cfg4,
                                           render=block_op(plain)),
        N / SR, B1_COUNTS, launches, reps=3,
        ref=lambda: _trajectory_core(table, xb.double(),
                                     _snap_dirs(dirs_t, 4), cfg,
                                     render=br.block_render_reference),
        assembly_rows=(1, N // B // 4))

    rng = np.random.default_rng(2)
    S, N = 64, 1 << 17
    xs = rng.standard_normal((S, N)).astype(np.float32)
    dmov = np.stack([rng.uniform(0, 360, (S, N // B)),
                     rng.uniform(-40, 90, (S, N // B))], -1).astype(np.float32)
    xbs = torch.tensor(xs.reshape(S, -1, B), device=dev)
    dmov_t = torch.tensor(dmov, device=dev)
    renders["b_scene_moving"] = check_render(
        "b scene 64 moving", lambda: r.render_scene(xs, dmov),
        lambda plain, dt: _scene_core(table, xbs.to(dt), dmov_t, cfg,
                                      render=mix_op(plain)),
        S * N / SR, MIX_COUNTS, launches, reps=3,
        min_snr=NEW_RENDER_SNR_DB, same_bits=True,
        other_routes={"block_render": lambda: _scene_core(
            table, xbs, dmov_t, cfg, render=br.block_render)})

    # (b4): the same at dir_rate 4 (bench.py w_scene_moving_dir4)
    renders["b4_scene_moving_dir_rate_4"] = check_render(
        "b4 scene 64 moving dir_rate 4", lambda: r4.render_scene(xs, dmov),
        lambda plain, dt: _scene_core(table, xbs.to(dt), dmov_t, cfg4,
                                      render=mix_op(plain)),
        S * N / SR, MIX_COUNTS, launches, reps=3,
        min_snr=NEW_RENDER_SNR_DB, same_bits=True,
        other_routes={"block_render": lambda: _scene_core(
            table, xbs, dmov_t, cfg4, render=br.block_render)},
        ref=lambda: _scene_core(table, xbs.double(), _snap_dirs(dmov_t, 4),
                                cfg, render=bs.scene_step_render_reference),
        assembly_rows=(S, N // B // 4))

    dstat = np.stack([rng.uniform(0, 360, S), rng.uniform(-40, 90, S)],
                     -1).astype(np.float32)
    dstat_t = torch.tensor(dstat, device=dev)
    renders["c_scene_static"] = check_render(
        "c scene 64 static", lambda: r.render_scene(xs, dstat),
        lambda plain, dt: _scene_static_core(table, xbs.to(dt), dstat_t,
                                             cfg, render=mix_op(plain)),
        S * N / SR, MIX_COUNTS, launches, reps=3,
        min_snr=NEW_RENDER_SNR_DB, same_bits=True,
        other_routes={"block_render": lambda: _scene_static_core(
            table, xbs, dstat_t, cfg, render=br.block_render)})

    S, N = 16, 1 << 20
    xs_m = rng.standard_normal((S, N)).astype(np.float32)
    dm = np.stack([rng.uniform(0, 360, (S, N // B)),
                   rng.uniform(-40, 90, (S, N // B))], -1).astype(np.float32)
    xbs_m = torch.tensor(xs_m.reshape(S, -1, B), device=dev)
    dm_t = torch.tensor(dm, device=dev)
    renders["m_scene_moving_long"] = check_render(
        "m scene 16 moving 2^20", lambda: r.render_scene(xs_m, dm),
        lambda plain, dt: _scene_core(table, xbs_m.to(dt), dm_t, cfg,
                                      render=block_op(plain)),
        S * N / SR, B1_COUNTS, launches, reps=3, min_snr=NEW_RENDER_SNR_DB,
        other_routes={"scene_step_render": lambda: _scene_core(
            table, xbs_m, dm_t, cfg, render=bs.scene_step_render)})

    # (n): a moving scene of 64 sources × 2^18 samples at 16,384 taps:
    # 256 blocks, more than the SMs, so B1's route at n_fft 32768, both
    # FFT kernels in the cluster mode (16,384 filter rows, H 4.3 GB)
    require(filters_plan(long_traj.taps, 1 << 15).body
            == mix_plan(1 << 15).body == "cluster",
            "(n)'s shapes leave the cluster mode")
    rng_n = np.random.default_rng(3)
    S, N = 64, 1 << 18
    xs_n = rng_n.standard_normal((S, N)).astype(np.float32)
    dn = np.stack([rng_n.uniform(0, 360, (S, N // B)),
                   rng_n.uniform(-40, 90, (S, N // B))], -1).astype(np.float32)
    xbs_n = torch.tensor(xs_n.reshape(S, -1, B), device=dev)
    dn_t = torch.tensor(dn, device=dev)
    rn = tt.BinauralRenderer(long_traj, cfg)
    renders["n_scene_moving_16384_taps"] = check_render(
        "n scene 64 moving 2^18 16384 taps",
        lambda: rn.render_scene(xs_n, dn),
        lambda plain, dt: _scene_core(long_traj, xbs_n.to(dt), dn_t, cfg,
                                      render=block_op(plain)),
        S * N / SR, B1_COUNTS, launches, reps=3, min_snr=NEW_RENDER_SNR_DB,
        ref=lambda: scene_reference_chunked(long_traj, xbs_n, dn_t, cfg, 8))
    # (n)'s bound, from its inputs: each kernel's bytes and operations
    nb_n, n_n = N // B, 1 << 15
    idx_n, _ = _neighbours(long_traj, dn_t, cfg)
    bounds_n = {"assemble_filters": assembly_work(long_traj, idx_n, n_n),
                "block_spectra_mix_inverse": mix_work(
                    S, nb_n, B, n_n, S * nb_n * 2 * (n_n // 2 + 1),
                    cfg.crossfade),
                "overlap_add": ola_work(1, nb_n, B, n_n)}
    renders["n_scene_moving_16384_taps"]["bounds"] = bounds_n
    print("[render n scene 64 moving 2^18 16384 taps] bounds: " + ", ".join(
        f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']})"
        for k, v in bounds_n.items()) + f"; the render "
        f"{sum(v['bound_ms'] for v in bounds_n.values()):.4f} ms", flush=True)

    # (o), (p), (q): (h)'s static render at 2^20 samples, (c)'s 64 static
    # and (b)'s 64 moving sources × 2^17 (128 blocks < 132 SMs: B4) on
    # (j)'s 16,384-tap table at block 1024, n_fft 32768: the block step's
    # pruned mode (Q 1024, P 32); their float64 plain paths 8 sources at
    # a time, as (n)'s; B1 timed and profiled beside (q)
    n_o = _n_fft(long_traj, B)
    require(all(pruned_plan(n_o, mix, B) is not None for mix in (False, True)),
            "(o)–(q) leave the pruned mode")
    renders["o_static_16384_taps"] = check_static(long_traj, 1 << 20,
                                                  launches, reps=3, name="o",
                                                  direct=False)
    # (r): (h)'s static render at 2^20 samples in blocks of 16384 (the
    # CLI's --block) on the 44,100-tap table, n_fft 65536: the pruned
    # mode's Q 16384 (P 4: a residue a CUDA block, its mirror run first)
    B_r = 1 << 14
    n_r = _n_fft(long_streamed, B_r)
    plan_r = pruned_plan(n_r, False, B_r)
    require(plan_r is not None and plan_r.half and plan_r.P == 4,
            "(r) leaves the pruned mode's Q 16384")
    renders["r_static_44100_taps_block_16384"] = check_static(
        long_streamed, 1 << 20, launches, reps=3, name="r", direct=False,
        block=B_r)
    rng_pq = np.random.default_rng(5)
    S, N = 64, 1 << 17
    nb_pq = N // B
    xs_pq = rng_pq.standard_normal((S, N)).astype(np.float32)
    dp = np.stack([rng_pq.uniform(0, 360, S), rng_pq.uniform(-40, 90, S)],
                  -1).astype(np.float32)
    dq = np.stack([rng_pq.uniform(0, 360, (S, nb_pq)),
                   rng_pq.uniform(-40, 90, (S, nb_pq))], -1).astype(np.float32)
    xbs_pq = torch.tensor(xs_pq.reshape(S, -1, B), device=dev)
    dp_t, dq_t = (torch.tensor(d, device=dev) for d in (dp, dq))
    rl = tt.BinauralRenderer(long_traj, cfg)
    renders["p_scene_static_16384_taps"] = check_render(
        "p scene 64 static 16384 taps", lambda: rl.render_scene(xs_pq, dp),
        lambda plain, dt: _scene_static_core(long_traj, xbs_pq.to(dt), dp_t,
                                             cfg, render=mix_op(plain)),
        S * N / SR, MIX_COUNTS, launches, reps=3,
        min_snr=NEW_RENDER_SNR_DB, same_bits=True,
        ref=lambda: scene_reference_chunked(long_traj, xbs_pq, dp_t, cfg, 8,
                                            static=True))
    renders["q_scene_moving_16384_taps"] = check_render(
        "q scene 64 moving 16384 taps", lambda: rl.render_scene(xs_pq, dq),
        lambda plain, dt: _scene_core(long_traj, xbs_pq.to(dt), dq_t, cfg,
                                      render=mix_op(plain)),
        S * N / SR, MIX_COUNTS, launches, reps=3,
        min_snr=NEW_RENDER_SNR_DB, same_bits=True,
        other_routes={"block_render": lambda: _scene_core(
            long_traj, xbs_pq, dq_t, cfg, render=br.block_render)},
        ref=lambda: scene_reference_chunked(long_traj, xbs_pq, dq_t, cfg, 8),
        profile_routes=True)
    # their block-step kernel's and assemble_filters' bounds, from inputs
    F_o = n_o // 2 + 1
    for key, dirs_k, cf in (("p_scene_static_16384_taps", dp_t[:, None],
                             False),
                            ("q_scene_moving_16384_taps", dq_t,
                             cfg.crossfade)):
        idx_k, _ = _neighbours(long_traj, dirs_k, cfg)
        chunk_k = bs.mix_chunk(S, nb_pq, n_o, sm_count(dev), B, cf)
        renders[key]["bounds"] = {
            "assemble_filters": assembly_work(long_traj, idx_k, n_o),
            "block_spectra_mix": step_work(
                S, nb_pq, B, n_o, idx_k.numel() // 4 * 2 * F_o, cf,
                -(-S // chunk_k))}
    nb_o = (1 << 20) // B
    idx_o, _ = _neighbours(long_traj, torch.tensor([[123.4, 5.6]],
                                                   device=dev), cfg)
    renders["o_static_16384_taps"]["bounds"] = {
        "assemble_filters": assembly_work(long_traj, idx_o, n_o),
        "block_spectra": step_work(1, nb_o, B, n_o, 2 * F_o, False)}
    idx_r, _ = _neighbours(long_streamed, torch.tensor([[123.4, 5.6]],
                                                       device=dev), cfg)
    renders["r_static_44100_taps_block_16384"]["bounds"] = {
        "assemble_filters": assembly_work(long_streamed, idx_r, n_r),
        "block_spectra": step_work(1, (1 << 20) // B_r, B_r, n_r,
                                   n_r + 2, False)}
    for key in ("o_static_16384_taps", "p_scene_static_16384_taps",
                "q_scene_moving_16384_taps",
                "r_static_44100_taps_block_16384"):
        print(f"[render {key}] bounds: " + ", ".join(
            f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']})"
            for k, v in renders[key]["bounds"].items()), flush=True)

    # 4b. the streaming and partitioned renders
    renders["d_serving"] = check_serving("d serving", table, 1024, 32, 1,
                                         launches, reps=3)
    renders["e_brir_serving_k1"] = check_serving("e BRIR serving", brir, 64,
                                                 8, 1, launches, reps=3)
    renders["e_brir_serving_k4"] = check_serving("e BRIR serving", brir, 64,
                                                 8, 4, launches, reps=3)
    renders["f_latency"] = check_latency(table, 64, launches)
    renders["g_streamed"] = check_streamed(brir, 1 << 20, launches, reps=3)
    renders["g4_streamed_dir_rate_4"] = check_streamed(
        brir, 1 << 20, launches, reps=3, dir_rate=4)

    # 4c. static render, render_batch on both routes, the natural-order
    # trajectory, and the sizes above shared memory
    renders["h_static"] = check_static(table, 1 << 22, launches, reps=3)
    renders["i_batch"] = check_batch(
        "i batch 64 moving", table, 64, 1 << 17, bs.block_step_render,
        bs.block_step_render_reference, STEP_COUNTS, launches, reps=3)
    renders["k_batch_2048_taps"] = check_batch(
        "k batch 64 moving 2048 taps", brir, 64, 1 << 17,
        am.assembly_mac_render, am.assembly_mac_render_reference, MAC_COUNTS,
        launches, reps=3, other=bs.block_step_render)
    renders["l_trajectory_block_2048"] = long_render(
        "l trajectory 2^23 block 2048", table, 2048, 1 << 23, False,
        _trajectory_core, am.assembly_mac_render,
        am.assembly_mac_render_reference, MAC_COUNTS, launches, reps=3,
        other=br.block_render)
    renders["j_long"] = check_long(long_streamed, long_traj, 1 << 17,
                                   launches, reps=2)
    renders["j4_streamed_44100_taps_dir_rate_4"] = long_render(
        "j4 streamed 44100 taps dir_rate 4", long_streamed, 512, 1 << 17,
        True, _partitioned_core, pc.partitioned_render,
        pc.partitioned_render_reference, PART_COUNTS, launches, reps=2,
        dir_rate=4)
    # (jd) (j)'s stream on the table kept whole: the direct body on the
    # main path, its rows × P counted around the public call
    jd = renders["jd_streamed_44100_taps_whole"] = long_render(
        "jd streamed 44100 taps whole", long_whole, 512, 1 << 17, True,
        _partitioned_core, pc.partitioned_render,
        pc.partitioned_render_reference, PART_COUNTS, launches, reps=2,
        counted=("partition_rows", "direct_partition_rows"))
    require(jd["counters"]["partition_rows"] > 0
            and jd["counters"]["direct_partition_rows"]
            == jd["counters"]["partition_rows"],
            f"render jd: counters {jd['counters']}, want every partition "
            "row through the direct body")

    # 4d. the CLI, after every timing and before the profiles
    cli_res = check_cli(table)
    # 4e. the parallel layer on a world-size-1 NCCL group
    par_res = check_parallel(table, cfg, (x, dirs), (xs, dmov, dstat),
                             renders)
    profile_renders()
    profile_kernels()
    check_assembly_savings(renders)
    # one chrome trace of (a)'s core through utils.profiling.trace
    par_res["a_trace"] = check_trace(
        "a trajectory 2^23", lambda: _trajectory_core(table, xb, dirs_t, cfg),
        br.KERNELS)

    # overlap_add ends the B1 renders and is the OLA half of B2 in every
    # render that launched spectra_inverse
    ola_b2 = sum(res["launches"].get("overlap_add", 0)
                 for _, res, _ in TO_PROFILE
                 if "spectra_inverse" in res["launches"])
    # each k-path kernel's check at dir_rate 4, and its launches in the
    # dir_rate 4 renders
    k4_checks = {"assemble_filters": k_traj4["assemble_filters"],
                 "block_spectra_mix_inverse":
                     k_traj4["block_spectra_mix_inverse"],
                 "assemble_partitions": k_part4["assemble_partitions"],
                 "frame_spectra": k_part4["frame_spectra"],
                 "partitioned_conv": k_part4["partitioned_conv"],
                 "block_spectra": k_step4["block_spectra"],
                 "block_spectra_mix": k_step4["block_spectra_mix"]}
    k4 = {name: {"launches": sum(
              res["launches"].get(name, 0) for key, res in renders.items()
              if key.endswith("dir_rate_4")),
              **{f: m.get(f) for f in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "max_abs_err", "snr_db",
                                       "library_ms")},
              **{f: m[f] for f in ("device_ms", "body") if f in m}}
          for name, m in k4_checks.items()}
    # device ms a launch of a kernel in a profiled render
    def render_ms(key, kernel: str):
        res = renders
        for k in (key,) if isinstance(key, str) else key:
            res = res[k]
        return res.get("device_ms_by_kernel", {}).get(f"{kernel}_kernel",
                                                      "not measured")
    kernels = [kernel_entry(
        name, B1_SOURCES[name], FUSED_BLOCK_RENDER,
        launches[name] - (ola_b2 if name == "overlap_add" else 0),
        k_traj[name], scene_ms=k_scene[name]["ms"],
        scene_plain_ms=k_scene[name]["plain_ms"],
        m_shape={f: k_m[name][f] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "snr_db")
            + (("snr_fp64_db",) if "snr_fp64_db" in k_m[name] else ())},
        **({"also_replaces": [f"{PALLAS}:{FUSED_BLOCK_STEP}",
                              f"{PALLAS}:{FUSED_BLOCK_STEP_MIX}"]}
           if name == "assemble_filters" else {}),
        **({"cluster_shapes": {key: {f: m[name].get(f) for f in B1_FIELDS}
                               for key, m in (("j_n_fft_32768", k_cl),
                                              ("n_fft_65536", k_cl65),
                                              ("j_split_forced", k_split),
                                              ("j_dir_rate_4", k_cl4),
                                              ("j_dir_rate_4_split_forced",
                                               k_split4))},
            "j_route_device_ms": render_ms(
                ("j_long", "trajectory_16384_taps", "block_render_route"),
                name),
            "n_render_device_ms": render_ms("n_scene_moving_16384_taps",
                                            name),
            "n_render_bound_ms": renders["n_scene_moving_16384_taps"][
                "bounds"][name]["bound_ms"]}
           if name != "overlap_add" else {}),
        **({"body": k_traj[name]["body"],
            "shapes": {key: {f: m.get(f) for f in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "body", "device_ms", "l2_flushed")}
                for key, m in k_ola.items()}}
           if name == "overlap_add" else {}))
        for name in br.KERNELS]
    # main shapes: the serving step (128 taps, S = 1024) and the offline
    # BRIR render; the BRIR serving step's times ride along
    main = {"assemble_partitions": k_serve, "stream_conv": k_serve,
            "frame_spectra": k_part, "partitioned_conv": k_part}
    long_stream = renders["j_long"]["streamed_44100_taps"]
    part_fields = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                   "snr_db", "snr_fp64_db", "device_ms", "forward_transforms",
                   "mode")
    shape_fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "max_abs_err", "snr_db", "snr_fp64_db", "ranks",
                    "rows_per_block", "host_us")
    extra = {"assemble_partitions": {
                 "brir_stream_ms": k_brir["assemble_partitions"]["ms"],
                 "brir_stream_plain_ms":
                     k_brir["assemble_partitions"]["plain_ms"],
                 "j_shape": {f: v for f, v in
                             k_part_j["assemble_partitions"].items()
                             if f in shape_fields},
                 "shapes": {k: {f: v for f, v in m.items()
                                if f in shape_fields or f.startswith("G")
                                or f == "device_ms"}
                            for k, m in k_asm.items()},
                 "edges": {k: {f: m[f] for f in ("ms", "snr_db",
                                                 "snr_fp64_db")}
                           for k, m in k_edges.items()},
                 # the direct body alone at one room44k.streamed chunk,
                 # and in (jd)'s render
                 "direct_shape": {f: v for f, v in k_direct.items()
                                  if f in shape_fields or f in (
                                      "device_ms", "body",
                                      "units_per_block")},
                 "direct_render": {
                     "launches": jd["launches"].get("assemble_partitions"),
                     "device_ms": render_ms("jd_streamed_44100_taps_whole",
                                            "assemble_partitions"),
                     **jd["counters"]},
                 "f_device_ms": renders["f_latency"].get(
                     "assemble_partitions_device_ms", "not measured"),
                 "g_device_ms": renders["g_streamed"].get(
                     "device_ms_by_kernel", {}).get(
                         "assemble_partitions_kernel", "not measured"),
                 **serving_device_ms(renders, "assemble_partitions")},
             "stream_conv": {
                 "hold_ms": k_serve["stream_conv_hold"]["ms"],
                 "hold_plain_ms": k_serve["stream_conv_hold"]["plain_ms"],
                 "brir_stream_ms": k_brir["stream_conv"]["ms"],
                 "brir_stream_plain_ms": k_brir["stream_conv"]["plain_ms"],
                 "brir_hold_ms": k_brir["stream_conv_hold"]["ms"],
                 "brir_hold_plain_ms": k_brir["stream_conv_hold"]["plain_ms"],
                 # device ms a call alone, from the profiles of phase 5
                 "device_ms": k_serve["stream_conv"]["device_ms"],
                 "hold_device_ms": k_serve["stream_conv_hold"]["device_ms"],
                 "hold_bound_ms": k_serve["stream_conv_hold"]["bound_ms"],
                 "brir_device_ms": k_brir["stream_conv"]["device_ms"],
                 "brir_hold_device_ms":
                     k_brir["stream_conv_hold"]["device_ms"],
                 "brir_hold_bound_ms": k_brir["stream_conv_hold"]["bound_ms"],
                 "f_bound_ms":
                     renders["f_latency"]["stream_conv_bound"]["bound_ms"],
                 "f_device_ms": renders["f_latency"].get(
                     "stream_conv_device_ms", "not measured"),
                 "mode": k_serve["stream_conv"]["mode"],
                 "forward_transforms": k_serve["stream_conv"][
                     "forward_transforms"],
                 "brir_mode": k_brir["stream_conv"]["mode"],
                 "edges": {k: m["stream_conv"]
                           for k, m in k_conv_edges.items()},
                 **serving_device_ms(renders, "stream_conv")},
             "frame_spectra": {
                 "device_ms": k_part["frame_spectra"]["device_ms"],
                 "forward_transforms":
                     k_part["frame_spectra"]["forward_transforms"],
                 "frames": k_part["frame_spectra"]["frames"],
                 "g_device_ms": render_ms("g_streamed", "frame_spectra"),
                 "j_shape": {f: v for f, v in
                             k_part_long["frame_spectra"].items()
                             if f in part_fields},
                 "j_device_ms": long_stream.get("device_ms_by_kernel", {}).get(
                     "frame_spectra_kernel", "not measured")},
             "partitioned_conv": {
                 "device_ms": k_part["partitioned_conv"]["device_ms"],
                 "forward_transforms":
                     k_part["frame_spectra"]["forward_transforms"],
                 "mode": k_part["partitioned_conv"]["mode"],
                 "g_device_ms": render_ms("g_streamed", "partitioned_conv"),
                 "j_shape": {f: v for f, v in
                             k_part_long["partitioned_conv"].items()
                             if f in part_fields},
                 "j_device_ms": long_stream.get("device_ms_by_kernel", {}).get(
                     "partitioned_conv_kernel", "not measured"),
                 "edges": {k: m["partitioned_conv"]
                           for k, m in k_conv_edges.items()}}}
    for name in pc.KERNELS:
        first, *also = PART_REPLACES[name]
        kernels.append(kernel_entry(
            name, ASM_SOURCE if name == "assemble_partitions" else PART_SOURCE,
            first, launches[name], main[name][name],
            also_replaces=[f"{PALLAS}:{n}" for n in also],
            **extra.get(name, {})))
    kernels += [
        kernel_entry("block_spectra", STEP_SOURCE, FUSED_BLOCK_STEP,
                     launches["block_spectra"], k_step["block_spectra"],
                     **step_extra(k_step["block_spectra"]),
                     h_shape=step_extra(
                         k_step_shapes["h"]["block_spectra"], True),
                     edges={key: step_extra(m["block_spectra"], True)
                            for key, m in k_step_shapes.items()
                            if key != "h"},
                     **pruned_extra(k_pruned, "block_spectra", renders,
                                    ("o_static_16384_taps",
                                     "r_static_44100_taps_block_16384"))),
        kernel_entry("spectra_inverse", INVERSE_SOURCE, FUSED_EPILOGUE,
                     launches["spectra_inverse"], k_step["spectra_inverse"],
                     summed_ms=k_mix["spectra_inverse_summed"]["ms"],
                     summed_plain_ms=k_mix["spectra_inverse_summed"]["plain_ms"],
                     shapes={k: {f: m[f] for f in ("ms", "plain_ms",
                                                   "library_ms", "bound_ms",
                                                   "snr_db")}
                             for k, m in k_inverse.items()},
                     also_replaces=[f"{PALLAS}:{FUSED_BLOCK_STEP_MIX}"]),
        kernel_entry("overlap_add", SOURCE, FUSED_EPILOGUE, ola_b2,
                     k_step["overlap_add"], sources=64,
                     body=k_step["overlap_add"]["body"]),
        kernel_entry("block_spectra_mix", STEP_SOURCE, FUSED_BLOCK_STEP_MIX,
                     launches["block_spectra_mix"], k_mix["block_spectra_mix"],
                     **step_extra(k_mix["block_spectra_mix"]),
                     **{f"{k}_{f}": k_mix[f"block_spectra_mix_{k}"][f]
                        for k in ("no_crossfade", "one_filter")
                        for f in ("ms", "device_ms", "bound_ms", "bound_by")},
                     edges={key: step_extra(m["block_spectra_mix"], True)
                            for key, m in k_step_shapes.items()
                            if key != "h"},
                     **pruned_extra(k_pruned, "block_spectra_mix", renders,
                                    ("p_scene_static_16384_taps",
                                     "q_scene_moving_16384_taps"))),
        kernel_entry("assembly_mac", MAC_SOURCE, FUSED_ASSEMBLY_MAC,
                     launches["assembly_mac"], k_mac["assembly_mac"],
                     run=k_mac["assembly_mac"]["run"],
                     mode=k_mac["assembly_mac"]["mode"],
                     device_ms=k_mac["assembly_mac"]["device_ms"],
                     snr_fp64_db=k_mac["assembly_mac"]["snr_fp64_db"],
                     no_crossfade_ms=k_mac["assembly_mac_no_crossfade"]["ms"],
                     shapes={key: {
                         **{f: m["assembly_mac"][f] for f in MAC_FIELDS},
                         "no_crossfade_ms":
                             m["assembly_mac_no_crossfade"]["ms"]}
                         for key, m in (("l", k_mac_l), ("j", k_mac_j),
                                        ("j_65536", k_mac_j65),
                                        ("j_split_forced", k_mac_split))},
                     j_render_device_ms=render_ms(
                         ("j_long", "trajectory_16384_taps"),
                         "assembly_mac"))]
    for k in kernels:
        require(k["launches"] > 0, f"kernel {k['name']} was not launched")
        if k["name"] in k4:
            k["dir_rate_4"] = k4[k["name"]]
    print(json.dumps({"renders": renders}), flush=True)
    print(json.dumps({"cli": cli_res}), flush=True)
    print(json.dumps({"parallel": par_res}), flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

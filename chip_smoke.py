#!/usr/bin/env python3
"""Drive tinaural_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run on any error (nothing is caught):
  1. device: require CUDA, print the card, its power limit and the toolchain;
  2. build the kernels of tinaural_torch/csrc/ (timed);
  3. each block-render kernel against its plain torch version at the main
     path's shapes (128-tap synthetic table, B = 1024, n_fft = 2048: one
     8192-block trajectory, 64 sources × 128 blocks with and without
     crossfade, render (m)'s 16 sources × 1024 blocks) and in the split
     mode at n_fft 32768: SNR ≥ 100 dB, each FFT kernel's SNR against
     plain fp64 printed;
  3b. each partitioned-convolution kernel against its plain version, SNR
     ≥ 100 dB: the streaming step at 128 taps (S = 1024, B = 256, P = 1)
     and 2048 taps (S = 64, B = 256, P = 9), the offline render at 2048
     taps (nb = 2048, B = 512, P = 5), `assemble_partitions` alone at
     render (j)'s 256 rows × 44,100 taps × B 512 (L = 65536, P = 87: the
     cluster mode, 4 blocks per row; also ≥ 100 dB against plain fp64),
     and a chain of pushes that carries the delay line and the previous
     filter;
  3c. the block-step kernels (`block_spectra`, `spectra_inverse`, the
     per-source `overlap_add`) against their plain versions at S = 64,
     nb = 128 and at S = 32, nb = 1 (B = 1024, 128 taps), SNR ≥ 100 dB
     (≥ 130 dB for `spectra_inverse`); then `spectra_inverse` alone, timed
     beside `torch.fft.irfft`, at 8192 rows × n_fft 4096, 2048 × 16384
     (the largest shared-mode FFT), 128 × 32768 and 64 × 65536 (cluster
     mode, 2 and 4 blocks per row);
  3d. the scene mixdown's `block_spectra_mix` (crossfade on and off, and one
     filter per source) with the summing `spectra_inverse` at S = 64,
     nb = 128, and the natural-order `assembly_mac` at 8192 rows (64 sources
     × 128 blocks, `first` at each source's block 0; 2048 taps, B = 1024,
     n_fft = 4096) and at render (l)'s 4096 rows (one source, 128 taps,
     B = 2048, n_fft = 4096), against their plain versions, SNR ≥ 100 dB
     (≥ 110 dB against plain fp64 for `assembly_mac`);
  4. the renders through the public entry points — (a) a 2^23-sample
     trajectory, (b) a 64-source moving scene and (c) a 64-source static
     scene of 2^17 samples each on the mixdown route, their cores timed on
     B1's route too, and (m) a 16-source moving scene of 2^20 samples
     (1024 blocks, B1's route) — with every kernel's launch count read
     around them, each output held against the port's own plain path in
     float64 on the card (SNR ≥ 60 dB for (a), ≥ 100 dB for the others;
     the mixdown route's output equal in bits over two calls), and the
     kernel and plain float32 routes timed with CUDA events;
  4b. the same for the streaming and partitioned renders — (d) serving,
     `BatchedStream.push_many` of 1024 streams × 32 blocks; (e) BRIR
     serving, 64 streams × 8 blocks at 2048 taps, update rate 1 and 4;
     (f) 64 single `Stream.push` calls; (g) `render_streamed` of 2^20
     samples at 2048 taps — (d) and (e) under
     ``torch.cuda.set_sync_debug_mode("error")``, so a host sync fails;
  4c. (h) static `render` of 2^22 samples at (123.4°, 5.6°) and one short
     call on the direct route; (i) `render_batch` of 64 requests × 2^17
     samples on moving tracks; (k) the same at 2048 taps (n_fft 4096, the
     natural-order route); (l) a 2^23-sample trajectory at block 2048
     (n_fft 4096, natural order); (j) the sizes above shared memory:
     `render_streamed` at 44,100 taps (L = 65536, P = 87) and a trajectory
     at 16,384 taps (n_fft = 32768, natural order) — each against the
     float64 plain path (SNR ≥ 100 dB) with its exact launch counts;
  5. one torch.profiler window per block render, and one per burst of (d)
     and of (e) at update rate 1, after every timing: device busy time,
     idle share and the largest kernels.
Every render reads every kernel's launch count, all set to 0 just before
it. The line before the last is the kernels' JSON record (with each
kernel's bound: the larger of its bytes over 3.35 TB/s and its FLOPs,
FFTs counted as 5·n·log2 n, over 67 TFLOP/s fp32); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
NEW_RENDER_SNR_DB = 100.0  # renders (b), (c), (h)–(m)
SOURCE = "tinaural_torch/csrc/block_render.cu"
# the block render's kernels → their sources
B1_SOURCES = {"assemble_filters": "tinaural_torch/csrc/assemble_filters.cu",
              "block_spectra_mix_inverse":
                  "tinaural_torch/csrc/block_mix_inverse.cu",
              "overlap_add": SOURCE}
PART_SOURCE = "tinaural_torch/csrc/partitioned.cu"
STEP_SOURCE = "tinaural_torch/csrc/block_step.cu"
INVERSE_SOURCE = "tinaural_torch/csrc/spectra_inverse.cu"
MAC_SOURCE = "tinaural_torch/csrc/assembly_mac.cu"
PALLAS = "tinaural/ops/pallas_kernels.py"
# each partitioned kernel → the TPU kernels it replaces (def lines)
PART_REPLACES = {"assemble_partitions": (2215, 1710),
                 "stream_conv": (2215, 2338),
                 "partitioned_conv": (1413, 1710)}
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


def table_bytes(table) -> int:
    return 4 * (table.h.numel() + table.delays.numel() + table.gains.numel())


def assembly_work(table, rows: int, n_fft: int) -> dict:
    """assemble_filters: gather and lerp of 4 rows, rfft_L, ramp·gain,
    irfft_L, rfft_nfft per row."""
    F = n_fft // 2 + 1
    return bound(rows * 32 + table_bytes(table) + rows * 2 * F * 8,
                 rows * assembly_flops(table, n_fft))


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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def trajectory_dirs(nb: int):
    import numpy as np

    return np.stack([np.linspace(0, 350, nb) % 360,
                     40 * np.sin(np.linspace(0, 20, nb))],
                    axis=1).astype(np.float32)


def check_kernels(table, S: int, nb: int, crossfade: bool, label: str,
                  reps: int) -> dict:
    """Each kernel against its plain version on the same inputs."""
    import numpy as np
    import torch

    from tinaural_torch.config import RenderConfig
    from tinaural_torch.models.renderer import _n_fft, _neighbours
    from tinaural_torch.ops import block_render as br

    dev = table.device
    n_fft = _n_fft(table, B)
    rng = np.random.default_rng(S * 7919 + nb)
    if S == 1:
        dirs = trajectory_dirs(nb)[None]
    else:
        dirs = np.stack([rng.uniform(0, 360, (S, nb)),
                         rng.uniform(-40, 90, (S, nb))], -1)
    idx, w = _neighbours(table, torch.tensor(dirs, dtype=torch.float32,
                                             device=dev), RenderConfig())
    xbs = torch.tensor(rng.standard_normal((S, nb, B)), dtype=torch.float32,
                       device=dev)
    flags = dict(apply_itd=True, apply_ild=True)

    H = br.assemble_filters_cuda(idx, w, table, n_fft, **flags)
    H_ref = br.assemble_filters_reference(idx, w, table, n_fft, **flags)
    H_64 = br.assemble_filters_reference(idx, w.double(), table, n_fft, **flags)
    frames = br.block_spectra_mix_inverse_cuda(xbs, H, n_fft,
                                               crossfade=crossfade)
    frames_ref = br.block_spectra_mix_inverse_reference(
        xbs, H, n_fft, crossfade=crossfade)
    out = br.overlap_add_cuda(frames[None], B)[0]
    out_ref = br.overlap_add(frames.transpose(0, 1), B)
    torch.cuda.synchronize()

    res = {}
    for name, got, ref, kern, plain in (
            ("assemble_filters", H, H_ref,
             lambda: br.assemble_filters_cuda(idx, w, table, n_fft, **flags),
             lambda: br.assemble_filters_reference(idx, w, table, n_fft,
                                                   **flags)),
            ("block_spectra_mix_inverse", frames, frames_ref,
             lambda: br.block_spectra_mix_inverse_cuda(
                 xbs, H, n_fft, crossfade=crossfade),
             lambda: br.block_spectra_mix_inverse_reference(
                 xbs, H, n_fft, crossfade=crossfade)),
            ("overlap_add", out, out_ref,
             lambda: br.overlap_add_cuda(frames[None], B),
             lambda: br.overlap_add(frames.transpose(0, 1), B))):
        require(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                    else got).all()), f"{name} not finite")
        s = snr_db(ref, got)
        res[name] = {"snr_db": s, "max_abs_err": max_abs(ref, got),
                     "ms": cuda_ms(kern, reps), "plain_ms": cuda_ms(plain, reps)}
        print(f"[{label} S={S} nb={nb} crossfade={crossfade}] {name}: "
              f"SNR {s:.2f} dB vs plain fp32, max abs err "
              f"{res[name]['max_abs_err']:.3e}, kernel {res[name]['ms']:.4f} ms,"
              f" plain {res[name]['plain_ms']:.4f} ms", flush=True)
        require(s >= KERNEL_SNR_DB, f"{name} SNR {s:.2f} < {KERNEL_SNR_DB} dB")
    frames_64 = br.block_spectra_mix_inverse_reference(
        xbs.double(), H.to(torch.complex128), n_fft, crossfade=crossfade)
    for name, ref64, got, plain in (
            ("assemble_filters", H_64, H, H_ref),
            ("block_spectra_mix_inverse", frames_64, frames, frames_ref)):
        res[name]["snr_fp64_db"] = snr_db(ref64, got)
        print(f"[{label}] {name}: SNR {res[name]['snr_fp64_db']:.2f} dB vs "
              f"plain fp64 (plain fp32: {snr_db(ref64, plain):.2f} dB)",
              flush=True)
    F = n_fft // 2 + 1
    mac = 16 if crossfade else 8
    res["assemble_filters"].update(assembly_work(table, S * nb, n_fft))
    res["block_spectra_mix_inverse"].update(bound(
        S * nb * B * 4 + S * nb * 2 * F * 8 + nb * 2 * n_fft * 4,
        S * nb * (fft_flops(n_fft) + 2 * F * mac) + nb * fft_flops(n_fft)))
    res["overlap_add"].update(ola_work(1, nb, B, n_fft))
    res["overlap_add"]["library_ms"] = fold_ms(frames[None], B, reps)
    print(f"[{label}] bounds: " + ", ".join(
        f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']})" for k, v in res.items())
        + f"; overlap_add library (fold) {res['overlap_add']['library_ms']:.4f}"
        " ms", flush=True)
    return res


def fold_ms(frames, hop: int, reps: int) -> float:
    """Time of `torch.nn.functional.fold`, one PyTorch call that
    overlap-adds (S, nb, 2, n) frames laid out as (S·2, n, nb), checked
    against the plain version first."""
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
    return cuda_ms(call, reps)


B1_COUNTS = {"assemble_filters": 1, "block_spectra_mix_inverse": 1,
             "overlap_add": 1}
STEP_COUNTS = {"assemble_filters": 1, "block_spectra": 1,
               "spectra_inverse": 1, "overlap_add": 1}
MIX_COUNTS = {"assemble_filters": 1, "block_spectra_mix": 1,
              "spectra_inverse": 1, "overlap_add": 1}
MAC_COUNTS = {"assembly_mac": 1, "spectra_inverse": 1, "overlap_add": 1}


def check_render(name: str, public_call, core_call, audio_sec: float,
                 expect: dict, launches_total: dict, reps: int,
                 min_snr: float = RENDER_SNR_DB, no_sync: bool = False,
                 other_routes: dict | None = None,
                 same_bits: bool = False) -> dict:
    """One render through the public entry point with every launch count
    at 0 before it and exactly ``expect`` after, then the float64 plain
    check and the kernel / plain fp32 timings, both on the render core
    with the inputs already on the card. core_call(plain, dtype).
    ``other_routes``: name → core call on another route, each held against
    the same float64 output and timed; ``same_bits``: two core calls must
    give equal bits."""
    import torch

    y, counts = _counts_after(public_call, expect, name, launches_total,
                              no_sync)
    require(bool(torch.isfinite(y).all()), f"render {name}: output not finite")

    y_core = core_call(False, torch.float32)
    y64 = core_call(True, torch.float64)
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
    TO_PROFILE.append((name, res, lambda: core_call(False, torch.float32)))
    return res



# (name, result, core call) of each block render, profiled once all renders
# are timed, so that no trace runs between two timings
TO_PROFILE = []


def profile_renders() -> None:
    """Each block render's core in a torch.profiler window: device busy
    time, idle share against its CUDA-event time, and the device time of
    its largest kernels, added to its result. A trace can come back
    missing device events, so one counts only when it holds every kernel
    the render launched; after three that do not, "not measured". A
    serving burst's CUDA-event time is its time per block × K."""
    for name, res, fn in TO_PROFILE:
        event_ms = res.get("kernel_ms") or res["kernel_ms_per_block"] * res["K"]
        want = {f"{k}_kernel" for k in res["launches"]}
        for _ in range(3):
            busy, by_kernel = device_breakdown(fn)
            if want <= by_kernel.keys():
                break
        else:
            res["device_busy_ms"] = "not measured"
            print(f"[profile {name}] incomplete traces: not measured",
                  flush=True)
            continue
        top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])
        top.update({k: by_kernel[k] for k in want})  # the port's, always
        res.update(device_busy_ms=busy, device_ms_by_kernel=top,
                   idle_share=max(0.0, 1.0 - busy / event_ms))
        print(f"[profile {name}] device busy {busy:.3f} ms of "
              f"{event_ms:.3f} (idle {100 * res['idle_share']:.0f}%): "
              + ", ".join(f"{k} {v:.3f}" for k, v in top.items()),
              flush=True)


def device_breakdown(fn) -> tuple[float, dict]:
    """Device time of one call of fn from a torch.profiler trace: the sum
    of all kernel and copy times, and the time by name (kernel names cut
    to their function)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            name = name.split("::")[-1].strip()
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return sum(by.values()), by


PART_FLAGS = dict(apply_itd=True, apply_ild=True)


def _report(res: dict, name: str, got, ref, kern, plain, label: str,
            reps: int, work: dict | None = None, library=None,
            min_snr: float = KERNEL_SNR_DB) -> None:
    """Hold one kernel output against its plain version (SNR ≥
    ``min_snr``), time both (and the library call, where there is one);
    ``work`` is its bound."""
    import torch

    require(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                else got).all()), f"{name} not finite")
    s = snr_db(ref, got)
    r = {"snr_db": s, "max_abs_err": max_abs(ref, got),
         "ms": cuda_ms(kern, reps), "plain_ms": cuda_ms(plain, reps),
         "library_ms": cuda_ms(library, reps) if library else None,
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


def check_stream_kernels(table, S: int, B: int, label: str, reps: int) -> dict:
    """assemble_partitions, and stream_conv as update and as hold step,
    against their plain versions on one random carried state (half the
    streams started, half not)."""
    import numpy as np
    import torch

    from tinaural_torch.ops import partitioned_conv as pc

    dev = table.device
    rng = np.random.default_rng(S + B + table.taps)
    idx, w = _rows(table, (S,), seed=1)
    ph_re, ph_im = pc.assemble_partitions_reference(*_rows(table, (S,), 2),
                                                    table, B, **PART_FLAGS)
    P = ph_re.shape[1]
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
            label, reps, partitions_work(table, S, B))
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
        n_h = 2 if cf else 1  # H and the previous filter, or H alone
        _report(res, name, got[0], ref[0],
                lambda: pc.stream_conv_cuda(*args, crossfade=cf),
                lambda: pc.stream_conv_reference(*args, crossfade=cf),
                label, reps, bound(
                    S * (B * 4 * 2 + 4 + P * (B + 1) * 8 * 2
                         + n_h * P * 2 * (B + 1) * 8 + 3 * B * 4),
                    S * ((1 + n_h) * fft_flops(2 * B)
                         + n_h * P * (B + 1) * 2 * 8)))
    return res


def partitions_work(table, rows: int, B: int) -> dict:
    """assemble_partitions: the effective-filter chain, then P rfft_2B."""
    L = 1 << math.ceil(math.log2(table.taps + 64))
    P = -(-(table.taps + 64) // B)
    return bound(rows * 32 + table_bytes(table) + rows * P * 2 * (B + 1) * 8,
                 rows * (16 * table.taps + 2 * fft_flops(L) + 16 * (L // 2 + 1)
                         + P * fft_flops(2 * B)))


def check_partition_assembly(table, rows: int, B: int, label: str,
                             reps: int) -> dict:
    """assemble_partitions alone against its plain fp32 and fp64 versions
    at render (j)'s shape."""
    import torch

    from tinaural_torch.ops import partitioned_conv as pc
    from tinaural_torch.ops.partitions_plan import partitions_plan

    plan = partitions_plan(table.taps, B)
    print(f"[{label}] L {plan.L}, P {plan.parts}, "
          + (f"cluster mode, {plan.ranks} blocks per row" if plan.cluster
             else "not the cluster mode"), flush=True)
    idx, w = _rows(table, (rows,), seed=5)
    kern = lambda: pc.assemble_partitions_cuda(idx, w, table, B, **PART_FLAGS)
    plain = lambda: pc.assemble_partitions_reference(idx, w, table, B,
                                                     **PART_FLAGS)
    res = {}
    H = torch.complex(*kern())
    _report(res, "assemble_partitions", H, torch.complex(*plain()), kern,
            plain, label, reps, partitions_work(table, rows, B))
    H64 = torch.complex(*pc.assemble_partitions_reference(
        idx, w.double(), table, B, **PART_FLAGS))
    s64 = snr_db(H64, H)
    print(f"[{label}] assemble_partitions: SNR {s64:.2f} dB vs plain fp64",
          flush=True)
    require(s64 >= KERNEL_SNR_DB, f"{label}: SNR {s64:.2f} vs plain fp64")
    res["assemble_partitions"].update(snr_fp64_db=s64, ranks=plan.ranks)
    return res


def check_partitioned_kernels(table, nb: int, B: int, label: str,
                              reps: int) -> dict:
    """assemble_partitions per block and partitioned_conv against their
    plain versions at the offline render's shape."""
    import numpy as np
    import torch

    from tinaural_torch.ops import partitioned_conv as pc

    idx, w = _rows(table, (nb,), seed=3)
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
            label, reps, partitions_work(table, nb, B))
    P = H[0].shape[1]
    _report(res, "partitioned_conv",
            pc.partitioned_conv_cuda(xb, *H, crossfade=True),
            pc.partitioned_conv_reference(xb, *H, crossfade=True),
            lambda: pc.partitioned_conv_cuda(xb, *H, crossfade=True),
            lambda: pc.partitioned_conv_reference(xb, *H, crossfade=True),
            label, reps, bound(
                nb * B * 4 + nb * P * 2 * (B + 1) * 8 + 2 * nb * B * 4,
                nb * (-(-P // 2) * fft_flops(2 * B) + 2 * P * (B + 1) * 2 * 8
                      + 2 * fft_flops(2 * B))))
    return res


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
    Y = bs.block_spectra_cuda(xbs, H, n_fft, crossfade=True)
    frames = bs.spectra_inverse_cuda(Y, n_fft)
    res = {}
    _report(res, "block_spectra", Y,
            bs.block_spectra_reference(xbs, H, n_fft, crossfade=True),
            lambda: bs.block_spectra_cuda(xbs, H, n_fft, crossfade=True),
            lambda: bs.block_spectra_reference(xbs, H, n_fft, crossfade=True),
            label, reps, bound(
                S * nb * (B * 4 + 2 * 2 * F * 8),
                S * nb * (fft_flops(n_fft) + 2 * F * 14)))
    _report(res, "spectra_inverse", frames,
            bs.spectra_inverse_reference(Y, n_fft),
            lambda: bs.spectra_inverse_cuda(Y, n_fft),
            lambda: bs.spectra_inverse_reference(Y, n_fft), label, reps,
            bound(S * nb * (2 * F * 8 + 2 * n_fft * 4),
                  S * nb * fft_flops(n_fft)),
            library=lambda: torch.fft.irfft(Y, n=n_fft),
            min_snr=INVERSE_SNR_DB)
    _report(res, "overlap_add", br.overlap_add_cuda(frames, B),
            br.overlap_add(frames.transpose(1, 2), B),
            lambda: br.overlap_add_cuda(frames, B),
            lambda: br.overlap_add(frames.transpose(1, 2), B), label, reps,
            ola_work(S, nb, B, n_fft))
    res["overlap_add"]["library_ms"] = fold_ms(frames, B, reps)
    print(f"[{label}] overlap_add library (fold) "
          f"{res['overlap_add']['library_ms']:.4f} ms", flush=True)
    return res


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
    chunk = bs.mix_chunk(S, nb, sm_count(table.device))
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
        kern = lambda H=H, cf=cf: bs.block_spectra_mix_cuda(
            xbs, H, n_fft, crossfade=cf, chunk=chunk)
        plain = lambda H=H, cf=cf: bs.block_spectra_mix_reference(
            xbs, H, n_fft, crossfade=cf, chunk=chunk)
        _report(res, name, kern(), plain(), kern, plain, label, reps, bound(
            S * nb * B * 4 + H.numel() * 8 + C * nb * 2 * F * 8,
            S * nb * (fft_flops(n_fft) + 2 * F * (16 if cf else 8))))
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


def check_assembly_mac(table, S: int, nb: int, label: str, reps: int,
                       block: int = B) -> dict:
    """assembly_mac against its plain fp32 version on S sources of nb
    blocks of ``block`` samples flattened to rows, `first` at each
    source's block 0, on the input spectra of the natural-order route."""
    import numpy as np
    import torch

    from tinaural_torch.models.renderer import _n_fft
    from tinaural_torch.ops import assembly_mac as am
    from tinaural_torch.ops._layout import sm_count
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
    run = am.run_length(rows, sm_count(table.device) * plan.blocks_per_sm)
    print(f"[{label}] n_fft {n_fft}, L {plan.L}, {plan.threads} threads × "
          f"{plan.blocks_per_sm} blocks per SM, {rows} rows in runs of {run}: "
          f"{1 + 1 / run:.3f} assemblies per row", flush=True)
    res = {}
    for name, cf in (("assembly_mac", True),
                     ("assembly_mac_no_crossfade", False)):
        kern = lambda cf=cf: am.assembly_mac_cuda(
            idx, w, table, Xu, Xd, first, n_fft, crossfade=cf, **PART_FLAGS)
        plain = lambda cf=cf: am.assembly_mac_reference(
            idx, w, table, Xu, Xd, first, n_fft, crossfade=cf, **PART_FLAGS)
        _report(res, name, kern(), plain(), kern, plain, label, reps, bound(
            rows * (32 + 4) + table_bytes(table)
            + rows * F * 8 * (2 if cf else 1) + rows * 2 * F * 8,
            rows * (assembly_flops(table, n_fft) + 2 * F * (14 if cf else 6))))
    Y = am.assembly_mac_cuda(idx, w, table, Xu, Xd, first, n_fft,
                             crossfade=True, **PART_FLAGS)
    Y64 = am.assembly_mac_reference(idx, w.double(), table,
                                    Xu.to(torch.complex128),
                                    Xd.to(torch.complex128), first, n_fft,
                                    crossfade=True, **PART_FLAGS)
    s64 = snr_db(Y64, Y)
    print(f"[{label}] assembly_mac: SNR {s64:.2f} dB vs plain fp64",
          flush=True)
    require(s64 >= MAC_FP64_SNR_DB,
            f"{label} assembly_mac: SNR {s64:.2f} < {MAC_FP64_SNR_DB} dB vs fp64")
    res["assembly_mac"].update(run=run, snr_fp64_db=s64)
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


def check_serving(name: str, table, S: int, K: int, k: int,
                  launches_total: dict, reps: int) -> dict:
    """BatchedStream.push_many of K device-staged blocks per stream, heads
    moving 2° per push, with no host sync; then the float64 plain check
    and the kernel / plain fp32 timings of the same burst."""
    import numpy as np
    import torch

    import tinaural_torch as tt
    from tinaural_torch.models.streaming import StreamState, _batch_scan_core
    from tinaural_torch.ops import partitioned_conv as pc

    B = 256
    cfg = tt.RenderConfig(stream_block=B, stream_update_rate=k)
    dev = table.device
    rng = np.random.default_rng(S + K + k)
    blocks = torch.tensor(rng.standard_normal((K, S, B)), dtype=torch.float32,
                          device=dev)
    azs = torch.tensor((np.linspace(0, 350, S)[None]
                        + 2.0 * np.arange(K)[:, None]) % 360.0,
                       dtype=torch.float32, device=dev)
    els = torch.zeros_like(azs)
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
    dev_ms = device_breakdown(lambda: pushes(tt.Stream(table, cfg), True))[0] / n
    res = {"snr_db_vs_plain_fp64": s64, "pushes": n, "launches": counts,
           "wall_ms_per_push_median": float(np.median(walls)),
           "wall_ms_per_push_max": float(np.max(walls)),
           "device_ms_per_push": dev_ms if dev_ms > 0 else "not measured"}
    print(f"[render f latency] {n} Stream.push: SNR {s64:.2f} dB vs plain "
          f"fp64, launches {counts}; wall {res['wall_ms_per_push_median']:.3f}"
          f" ms/push median (max {res['wall_ms_per_push_max']:.3f}), device "
          f"{res['device_ms_per_push']} ms/push (profiler)", flush=True)
    return res


def check_streamed(table, N: int, launches_total: dict, reps: int) -> dict:
    """render_streamed of N samples at block 512, bench.py's BRIR
    direction track; float64 plain check and both routes' throughput."""
    import numpy as np
    import torch

    import tinaural_torch as tt
    from tinaural_torch.models.renderer import _partitioned_core
    from tinaural_torch.ops import partitioned_conv as pc

    B = 512
    cfg = tt.RenderConfig(stream_block=B)
    nb = N // B
    x = np.random.default_rng(6).standard_normal(N).astype(np.float32)
    dirs = np.stack([np.linspace(0, 350, nb) % 360,
                     20 * np.sin(np.linspace(0, 9, nb))],
                    axis=1).astype(np.float32)
    r = tt.BinauralRenderer(table, cfg)
    y, counts = _counts_after(lambda: r.render_streamed(x, dirs),
                              {"assemble_partitions": 1,
                               "partitioned_conv": 1}, "g streamed",
                              launches_total, no_sync=False)
    require(bool(torch.isfinite(y).all()), "render g: not finite")
    xb = torch.tensor(x.reshape(nb, B), device=table.device)
    dirs_t = torch.tensor(dirs, device=table.device)
    core = lambda xx, render=pc.partitioned_render: _partitioned_core(
        table, xx, dirs_t, cfg, render=render)
    require(torch.equal(y, core(xb)), "render g: public call and core differ")
    s = snr_db(core(xb.double(), pc.partitioned_render_reference), y)
    require(s >= RENDER_SNR_DB, f"render g: SNR {s:.2f}")
    ms = cuda_ms(lambda: core(xb), reps)
    plain_ms = cuda_ms(lambda: core(xb, pc.partitioned_render_reference), reps)
    res = {"snr_db_vs_plain_fp64": s, "shape": list(y.shape),
           "launches": counts, "kernel_ms": ms, "plain_fp32_ms": plain_ms,
           "kernel_audio_sec_per_sec": N / SR / (ms / 1e3),
           "plain_fp32_audio_sec_per_sec": N / SR / (plain_ms / 1e3)}
    print(f"[render g streamed] 2^{N.bit_length() - 1} samples, {table.taps} "
          f"taps, B={B}: SNR {s:.2f} dB vs plain fp64, launches {counts}, "
          f"kernel {ms:.3f} ms = {res['kernel_audio_sec_per_sec']:.1f} "
          f"audio-s/s, plain fp32 {plain_ms:.3f} ms = "
          f"{res['plain_fp32_audio_sec_per_sec']:.1f} audio-s/s", flush=True)
    return res


def check_static(table, N: int, launches_total: dict, reps: int) -> dict:
    """(h) static `render` of N samples at bench.py's direction (B = 1024)
    on the block route, then one short call on the direct route, which
    launches no kernel (`torch.fft` on the card)."""
    import numpy as np
    import torch

    import tinaural_torch as tt
    from tinaural_torch.models.renderer import (_static_block_core,
                                                _static_core)
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops.filters import next_pow2

    cfg = tt.RenderConfig(block_size=B)
    r = tt.BinauralRenderer(table, cfg)
    x = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    xb = torch.tensor(x.reshape(-1, B), device=table.device)
    dir2 = torch.tensor([123.4, 5.6], device=table.device)
    res = check_render(
        f"h static 2^{N.bit_length() - 1}", lambda: r.render(x, 123.4, 5.6),
        lambda plain, dt: _static_block_core(
            table, xb.to(dt), dir2, cfg,
            render=bs.block_step_render_reference if plain
            else bs.block_step_render),
        N / SR, STEP_COUNTS, launches_total, reps, NEW_RENDER_SNR_DB)

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
                pc.partitioned_render_reference,
                {"assemble_partitions": 1, "partitioned_conv": 1},
                launches_total, reps),
            "trajectory_16384_taps": long_render(
                "j trajectory 16384 taps", long_traj, 1024, N, False,
                _trajectory_core, am.assembly_mac_render,
                am.assembly_mac_render_reference, MAC_COUNTS,
                launches_total, reps, other=br.block_render)}


def long_render(name: str, table, Bj: int, N: int, streamed: bool, core,
                kern, plain_fn, expect: dict, launches_total: dict,
                reps: int, other=None) -> dict:
    """One render of (j) or (l) on bench.py's BRIR direction track;
    ``other`` another route timed beside it."""
    import numpy as np
    import torch

    import tinaural_torch as tt

    cfg = tt.RenderConfig(block_size=Bj, stream_block=Bj)
    r = tt.BinauralRenderer(table, cfg)
    nb = N // Bj
    x = np.random.default_rng(6).standard_normal(N).astype(np.float32)
    dirs = np.stack([np.linspace(0, 350, nb) % 360,
                     20 * np.sin(np.linspace(0, 9, nb))],
                    axis=1).astype(np.float32)
    public = r.render_streamed if streamed else r.render_trajectory
    xb = torch.tensor(x.reshape(nb, Bj), device=table.device)
    dirs_t = torch.tensor(dirs, device=table.device)
    return check_render(
        name, lambda: public(x, dirs),
        lambda plain, dt: core(table, xb.to(dt), dirs_t, cfg,
                               render=plain_fn if plain else kern),
        N / SR, expect, launches_total, reps, NEW_RENDER_SNR_DB,
        other_routes=other and {other.__name__: lambda: core(
            table, xb, dirs_t, cfg, render=other)})


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
            name = (base.group(1) if base else sym) + (
                "<" + ",".join(a[1:] for a in args) + ">" if args else "")
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
    from tinaural_torch.models.renderer import (_scene_core,
                                                _scene_static_core,
                                                _trajectory_core)
    from tinaural_torch.ops import _build
    from tinaural_torch.ops import assembly_mac as am
    from tinaural_torch.ops import block_render as br
    from tinaural_torch.ops import block_step as bs
    from tinaural_torch.ops import partitioned_conv as pc

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
    t0 = time.perf_counter()
    brir, long_streamed, long_traj = (
        tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic", taps=n),
                                      dev) for n in (2048, 44100, 16384))
    print(f"long tables: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    check_kernels(table, 1, 256, True, "check", reps=5)
    k_traj = check_kernels(table, 1, 8192, True, "trajectory", reps=5)
    k_scene = check_kernels(table, 64, 128, True, "scene", reps=5)
    check_kernels(table, 64, 128, False, "static scene", reps=5)
    # render (m)'s shape: 16 sources × 1024 blocks
    k_m = check_kernels(table, 16, 1024, True, "m scene", reps=5)
    # B1's split mode, at the 16,384-tap table's n_fft 32768
    check_kernels(long_traj, 1, 32, True, "split n_fft 32768", reps=2)

    # 3b. the partitioned-convolution kernels against their plain versions
    k_serve = check_stream_kernels(table, 1024, 256, "stream 128 taps P=1",
                                   reps=10)
    k_brir = check_stream_kernels(brir, 64, 256, "stream 2048 taps P=9",
                                  reps=10)
    k_part = check_partitioned_kernels(brir, 2048, 512,
                                       "partitioned 2048 taps P=5", reps=5)
    k_part_j = check_partition_assembly(long_streamed, 256, 512,
                                        "assemble_partitions 256 rows 44100 "
                                        "taps B=512", reps=5)
    check_stream_chain(brir, 64, 256, 12, "stream 2048 taps P=9")
    check_stream_chain(table, 1024, 256, 4, "stream 128 taps P=1")

    # 3c. the block-step kernels against their plain versions
    k_step = check_step_kernels(table, 64, 128, "block step S=64 nb=128",
                                reps=5)
    check_step_kernels(table, 32, 1, "block step S=32 nb=1", reps=5)
    k_inverse = check_inverse_shapes(dev, reps=5)

    # 3d. the scene mixdown's and the natural-order route's kernels
    k_mix = check_mix_kernels(table, 64, 128, "mix S=64 nb=128", reps=5)
    k_mac = check_assembly_mac(brir, 64, 128,
                               "assembly_mac 8192 rows n_fft 4096", reps=5)
    # (l)'s shape: one 4096-block trajectory at block 2048, 128 taps
    k_mac_l = check_assembly_mac(table, 1, 4096,
                                 "assembly_mac 4096 rows n_fft 4096 128 taps",
                                 reps=5, block=2048)

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

    # 4b. the streaming and partitioned renders
    renders["d_serving"] = check_serving("d serving", table, 1024, 32, 1,
                                         launches, reps=3)
    renders["e_brir_serving_k1"] = check_serving("e BRIR serving", brir, 64,
                                                 8, 1, launches, reps=3)
    renders["e_brir_serving_k4"] = check_serving("e BRIR serving", brir, 64,
                                                 8, 4, launches, reps=3)
    renders["f_latency"] = check_latency(table, 64, launches)
    renders["g_streamed"] = check_streamed(brir, 1 << 20, launches, reps=3)

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
    profile_renders()

    # overlap_add ends the B1 renders and is the OLA half of B2 in every
    # render that launched spectra_inverse
    ola_b2 = sum(res["launches"].get("overlap_add", 0)
                 for _, res, _ in TO_PROFILE
                 if "spectra_inverse" in res["launches"])
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
           if name == "assemble_filters" else {}))
        for name in br.KERNELS]
    # main shapes: the serving step (128 taps, S = 1024) and the offline
    # BRIR render; the BRIR serving step's times ride along
    main = {"assemble_partitions": k_serve, "stream_conv": k_serve,
            "partitioned_conv": k_part}
    extra = {"assemble_partitions": {
                 "brir_stream_ms": k_brir["assemble_partitions"]["ms"],
                 "brir_stream_plain_ms":
                     k_brir["assemble_partitions"]["plain_ms"],
                 "j_shape": {f: k_part_j["assemble_partitions"][f] for f in (
                     "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                     "max_abs_err", "snr_db", "snr_fp64_db", "ranks")},
                 **serving_device_ms(renders, "assemble_partitions")},
             "stream_conv": {
                 "hold_ms": k_serve["stream_conv_hold"]["ms"],
                 "hold_plain_ms": k_serve["stream_conv_hold"]["plain_ms"],
                 "brir_stream_ms": k_brir["stream_conv"]["ms"],
                 "brir_stream_plain_ms": k_brir["stream_conv"]["plain_ms"],
                 "brir_hold_ms": k_brir["stream_conv_hold"]["ms"],
                 "brir_hold_plain_ms": k_brir["stream_conv_hold"]["plain_ms"],
                 **serving_device_ms(renders, "stream_conv")}}
    for name in pc.KERNELS:
        first, *also = PART_REPLACES[name]
        kernels.append(kernel_entry(
            name, PART_SOURCE, first, launches[name], main[name][name],
            also_replaces=[f"{PALLAS}:{n}" for n in also],
            **extra.get(name, {})))
    kernels += [
        kernel_entry("block_spectra", STEP_SOURCE, FUSED_BLOCK_STEP,
                     launches["block_spectra"], k_step["block_spectra"]),
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
                     k_step["overlap_add"], sources=64),
        kernel_entry("block_spectra_mix", STEP_SOURCE, FUSED_BLOCK_STEP_MIX,
                     launches["block_spectra_mix"], k_mix["block_spectra_mix"],
                     **{f"{k}_ms": k_mix[f"block_spectra_mix_{k}"]["ms"]
                        for k in ("no_crossfade", "one_filter")}),
        kernel_entry("assembly_mac", MAC_SOURCE, FUSED_ASSEMBLY_MAC,
                     launches["assembly_mac"], k_mac["assembly_mac"],
                     run=k_mac["assembly_mac"]["run"],
                     snr_fp64_db=k_mac["assembly_mac"]["snr_fp64_db"],
                     no_crossfade_ms=k_mac["assembly_mac_no_crossfade"]["ms"],
                     l_shape={f: k_mac_l["assembly_mac"][f] for f in (
                         "ms", "plain_ms", "bound_ms", "bound_by",
                         "max_abs_err", "snr_db", "snr_fp64_db", "run")})]
    for k in kernels:
        require(k["launches"] > 0, f"kernel {k['name']} was not launched")
    print(json.dumps({"renders": renders}), flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive tinaural_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run on any error (nothing is caught):
  1. device: require CUDA, print the card, its power limit and the toolchain;
  2. build the kernels of tinaural_torch/csrc/ (timed);
  3. each kernel against its plain torch version at the main path's shapes
     (128-tap synthetic table, B = 1024, n_fft = 2048): SNR ≥ 100 dB;
  4. the renders through the public entry points — (a) a 2^23-sample
     trajectory, (b) a 64-source moving scene and (c) a 64-source static
     scene of 2^17 samples each — with every kernel's launch count read
     around them, each output held against the port's own plain path in
     float64 on the card (SNR ≥ 60 dB), and the kernel and plain float32
     routes timed with CUDA events.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SR = 44100
B = 1024
KERNEL_SNR_DB = 100.0
RENDER_SNR_DB = 60.0
SOURCE = "tinaural_torch/csrc/block_render.cu"
REPLACES = "tinaural/ops/pallas_kernels.py:1089"


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
    out = br.overlap_add_cuda(frames, B)
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
             lambda: br.overlap_add_cuda(frames, B),
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
    print(f"[{label}] assemble_filters: SNR {snr_db(H_64, H):.2f} dB vs plain "
          f"fp64 (plain fp32: {snr_db(H_64, H_ref):.2f} dB)", flush=True)
    return res


def check_render(name: str, public_call, core_call, audio_sec: float,
                 launches_total: dict, reps: int) -> dict:
    """One render through the public entry point with its launch counts,
    then the float64 plain check and the kernel / plain fp32 timings, both
    on the render core with the inputs already on the card."""
    import torch

    from tinaural_torch.ops import block_render as br

    br.reset_launches()
    y = public_call()
    torch.cuda.synchronize()
    counts = dict(br.launches)
    for k, v in counts.items():
        require(v > 0, f"render {name}: kernel {k} was not launched")
        launches_total[k] += v
    require(bool(torch.isfinite(y).all()), f"render {name}: output not finite")

    y_core = core_call(br.block_render, torch.float32)
    y64 = core_call(br.block_render_reference, torch.float64)
    require(torch.equal(y, y_core[:, : y.shape[1]]),
            f"render {name}: public call and core differ")
    s = snr_db(y64, y_core)
    require(s >= RENDER_SNR_DB, f"render {name}: SNR {s:.2f} < {RENDER_SNR_DB}")
    ms = cuda_ms(lambda: core_call(br.block_render, torch.float32), reps)
    plain_ms = cuda_ms(
        lambda: core_call(br.block_render_reference, torch.float32), reps)
    res = {"snr_db_vs_plain_fp64": s, "shape": list(y.shape),
           "launches": counts, "kernel_ms": ms, "plain_fp32_ms": plain_ms,
           "kernel_audio_sec_per_sec": audio_sec / (ms / 1e3),
           "plain_fp32_audio_sec_per_sec": audio_sec / (plain_ms / 1e3)}
    print(f"[render {name}] out {tuple(y.shape)}, SNR {s:.2f} dB vs plain "
          f"fp64, launches {counts}, kernel {ms:.3f} ms = "
          f"{res['kernel_audio_sec_per_sec']:.1f} audio-s/s, plain fp32 "
          f"{plain_ms:.3f} ms = {res['plain_fp32_audio_sec_per_sec']:.1f} "
          f"audio-s/s", flush=True)
    return res


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
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    table = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), dev)
    cfg = tt.RenderConfig(block_size=B)

    # 3. kernels against their plain versions
    check_kernels(table, 1, 256, True, "check", reps=5)
    k_traj = check_kernels(table, 1, 8192, True, "trajectory", reps=5)
    k_scene = check_kernels(table, 64, 128, True, "scene", reps=5)
    check_kernels(table, 64, 128, False, "static scene", reps=5)

    # 4. the renders
    r = tt.BinauralRenderer(table, cfg)
    launches = dict.fromkeys(k_traj, 0)
    renders = {}

    rng = np.random.default_rng(0)
    N = 1 << 23
    x = rng.standard_normal(N).astype(np.float32)
    dirs = trajectory_dirs(N // B)
    xb = torch.tensor(x.reshape(-1, B), device=dev)
    dirs_t = torch.tensor(dirs, device=dev)
    renders["a_trajectory"] = check_render(
        "a trajectory 2^23", lambda: r.render_trajectory(x, dirs),
        lambda render, dt: _trajectory_core(table, xb.to(dt), dirs_t, cfg,
                                            render=render),
        N / SR, launches, reps=3)

    rng = np.random.default_rng(2)
    S, N = 64, 1 << 17
    xs = rng.standard_normal((S, N)).astype(np.float32)
    dmov = np.stack([rng.uniform(0, 360, (S, N // B)),
                     rng.uniform(-40, 90, (S, N // B))], -1).astype(np.float32)
    xbs = torch.tensor(xs.reshape(S, -1, B), device=dev)
    dmov_t = torch.tensor(dmov, device=dev)
    renders["b_scene_moving"] = check_render(
        "b scene 64 moving", lambda: r.render_scene(xs, dmov),
        lambda render, dt: _scene_core(table, xbs.to(dt), dmov_t, cfg,
                                       render=render),
        S * N / SR, launches, reps=3)

    dstat = np.stack([rng.uniform(0, 360, S), rng.uniform(-40, 90, S)],
                     -1).astype(np.float32)
    dstat_t = torch.tensor(dstat, device=dev)
    renders["c_scene_static"] = check_render(
        "c scene 64 static", lambda: r.render_scene(xs, dstat),
        lambda render, dt: _scene_static_core(table, xbs.to(dt), dstat_t,
                                              cfg, render=render),
        S * N / SR, launches, reps=3)

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES, "launches": launches[name],
                "max_abs_err": k_traj[name]["max_abs_err"],
                "ms": k_traj[name]["ms"], "plain_ms": k_traj[name]["plain_ms"],
                "scene_ms": k_scene[name]["ms"],
                "scene_plain_ms": k_scene[name]["plain_ms"]}
               for name in k_traj]
    print(json.dumps({"renders": renders}), flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time chip_smoke.py's dir_rate renders and their dir_rate 1 counterparts
on one CUDA card, through what every tree of the port has: the public
entry points and the renderer's cores with their default routes.

    PYTHONPATH=<tree> python3 scripts/torch_dir_rate_ab.py [--reps 3]
        [--small]

Renders, each at dir_rate 1 and 4 on chip_smoke.py's inputs: (a) a
2^23-sample trajectory (B1), (b) 64 moving sources × 2^17 samples (the
scene mixdown route, B1's timed beside it), (g) `render_streamed` of 2^20
samples at 2048 taps and block 512, (j) `render_streamed` of 2^17 samples
at 44,100 taps. For each: the public call's output checked finite and
equal in bits to the core's, the core's CUDA-event ms (mean of ``reps``
after a warm-up); then, after every timing (a profiler session slows the
host-bound renders timed after it), one torch.profiler window per core:
device busy ms, idle share and the ms of the port's assembly and MAC
kernels. One JSON line per render; the card's name and power limit
first. It runs against whatever tinaural_torch is first on sys.path, so
a parent and a change compare in one call (parent, change, change,
parent). ``--small`` cuts every size (`renders` takes any device, so the
CPU can rehearse its inputs and calls).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

import tinaural_torch as tt
from tinaural_torch.models.renderer import (_partitioned_core, _scene_core,
                                            _trajectory_core)
from tinaural_torch.ops import block_render as br

KERNELS = ("assemble_filters_kernel", "assemble_partitions_kernel",
           "block_spectra_mix_inverse_kernel", "block_spectra_mix_kernel",
           "partitioned_conv_kernel", "overlap_add_kernel")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events, after a warm-up."""
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


def device_breakdown(fn) -> tuple[float, dict]:
    """Device ms of one call of fn from a torch.profiler trace: the sum of
    every kernel and copy, and the port's kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, by = 0.0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            name = next((k for k in KERNELS if k in e.name), None)
            if name:
                by[name] = by.get(name, 0.0) + ms
    return busy, by


def track(nb: int, amp: float, turns: float) -> np.ndarray:
    return np.stack([np.linspace(0, 350, nb) % 360,
                     amp * np.sin(np.linspace(0, turns, nb))],
                    axis=1).astype(np.float32)


def renders(dev, small: bool):
    """(name, public call, core call) of each render at dir_rate 1 and 4."""
    cut = (lambda n, m: m) if small else (lambda n, m: n)
    table = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), dev)
    brir = tt.TorchTable.from_hrir_table(
        tt.load_hrir_set("synthetic", taps=cut(2048, 256)), dev)
    long_t = tt.TorchTable.from_hrir_table(
        tt.load_hrir_set("synthetic", taps=cut(44100, 512)), dev)
    B = 1024
    rng = np.random.default_rng(0)
    N = cut(1 << 23, 1 << 14)
    x = rng.standard_normal(N).astype(np.float32)
    dirs = track(N // B, 40, 20)
    xb = torch.tensor(x.reshape(-1, B), device=dev)
    dirs_t = torch.tensor(dirs, device=dev)
    rng = np.random.default_rng(2)
    S, Ns = cut(64, 4), cut(1 << 17, 1 << 13)
    xs = rng.standard_normal((S, Ns)).astype(np.float32)
    dmov = np.stack([rng.uniform(0, 360, (S, Ns // B)),
                     rng.uniform(-40, 90, (S, Ns // B))], -1).astype(
                         np.float32)
    xbs = torch.tensor(xs.reshape(S, -1, B), device=dev)
    dmov_t = torch.tensor(dmov, device=dev)
    out = []
    for k in (1, 4):
        cfg = tt.RenderConfig(block_size=B, dir_rate=k)
        r = tt.BinauralRenderer(table, cfg)
        out += [
            (f"a trajectory dir_rate {k}",
             lambda r=r: r.render_trajectory(x, dirs),
             lambda cfg=cfg: _trajectory_core(table, xb, dirs_t, cfg)),
            (f"b scene 64 moving dir_rate {k}",
             lambda r=r: r.render_scene(xs, dmov),
             lambda cfg=cfg: _scene_core(table, xbs, dmov_t, cfg)),
            (f"b scene 64 moving dir_rate {k} on block_render", None,
             lambda cfg=cfg: _scene_core(table, xbs, dmov_t, cfg,
                                         render=br.block_render))]
        for name, tb, Nq in (("g streamed 2048 taps", brir,
                              cut(1 << 20, 1 << 13)),
                             ("j streamed 44100 taps", long_t,
                              cut(1 << 17, 1 << 12))):
            cfg_s = tt.RenderConfig(stream_block=512, dir_rate=k)
            nb = Nq // 512
            xq = np.random.default_rng(6).standard_normal(Nq).astype(
                np.float32)
            dq = track(nb, 20, 9)
            xq_t = torch.tensor(xq.reshape(nb, 512), device=dev)
            dq_t = torch.tensor(dq, device=dev)
            rq = tt.BinauralRenderer(tb, cfg_s)
            out.append((f"{name} dir_rate {k}",
                        lambda rq=rq, xq=xq, dq=dq: rq.render_streamed(xq, dq),
                        lambda tb=tb, xq_t=xq_t, dq_t=dq_t, cfg_s=cfg_s:
                        _partitioned_core(tb, xq_t, dq_t, cfg_s)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    items = renders(torch.device("cuda", 0), args.small)
    res = []
    for name, public, core in items:
        if public is not None:
            y = public()
            if not (bool(torch.isfinite(y).all())
                    and torch.equal(y, core()[..., : y.shape[-1]])):
                raise SystemExit(f"{name}: public call and core differ")
        res.append({"render": name, "core_ms": cuda_ms(core, args.reps)})
    for r, (_, _, core) in zip(res, items):
        busy, by = device_breakdown(core)
        r.update(device_busy_ms=busy, idle_share=max(0.0, 1 - busy / r[
            "core_ms"]), device_ms_by_kernel=by)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

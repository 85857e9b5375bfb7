#!/usr/bin/env python3
"""Time the overlap-add kernel `overlap_add` alone and in chip_smoke.py's
renders that run it, on one CUDA card, through what every tree of the port
has: the wrapper `overlap_add_cuda` and the renderer's cores.

    PYTHONPATH=<tree> python3 scripts/torch_ola_ab.py [--small] [--kernels]

Kernel alone, on seeded random frames at the shapes of chip_smoke.py's
renders (each held equal in bits to the plain float32 `ola.overlap_add`
on the same card, and timed by CUDA events, mean of 20 after a warm-up,
beside its bound and `torch.nn.functional.fold`; every timed or profiled
call follows a 256 MB write that evicts the frames from L2, so that the
smaller shapes read them from device memory, as their bound assumes): (a) 8192 frames ×
n_fft 2048, B 1024; (a) again from a frames pointer one float past 16-byte
alignment (the scalar body); (i) 64 sources × 128 frames; (h) 4096
frames; (b) the scene mixdown's 128 summed frames; (k) 64 × 128 ×
n_fft 4096; (l) 4096 × 4096 at B 2048; (j) 128 × n_fft 32768 (k = 32).
Renders, each core held against its float64 plain path (SNR printed) and
timed by CUDA events (mean of 3 after a warm-up): (a) a 2^23-sample
trajectory (B1), (h) static `render` of 2^22, (i) `render_batch` of 64 ×
2^17 (B3), (k) the same at 2048 taps (B9), (l) a 2^23 trajectory at block
2048 (B9). Then, after every timing (a profiler window slows the
host-bound renders timed after it), one torch.profiler window per kernel
shape (10 calls: device ms a call) and per render (device busy ms, idle
share, ms by kernel). One JSON line per item, the card's name and power
limit first. It runs against whatever tinaural_torch is first on
sys.path, so a parent and a change compare in one call (parent, change,
change, parent).

``--small`` cuts every size, so the CPU can rehearse the inputs and calls
(no timings). ``--kernels`` times the kernel alone and no render, and
builds only ``csrc/block_render.cu``, printing its ptxas lines.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import numpy as np
import torch

import tinaural_torch as tt
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops.ola import overlap_add

KERNELS = ("assemble_filters_kernel", "block_spectra_kernel",
           "block_spectra_mix_inverse_kernel", "spectra_inverse_kernel",
           "assembly_mac_kernel", "overlap_add_kernel")
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at 700 W
SR = 44100

# (label, S, nb, B, n_fft, frames offset in floats) of the kernel alone
SHAPES = (("a", 1, 8192, 1024, 2048, 0), ("a scalar", 1, 8192, 1024, 2048, 1),
          ("i", 64, 128, 1024, 2048, 0), ("h", 1, 4096, 1024, 2048, 0),
          ("b", 1, 128, 1024, 2048, 0), ("k", 64, 128, 1024, 4096, 0),
          ("l", 1, 4096, 2048, 4096, 0), ("j", 1, 128, 1024, 32768, 0))

L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of one call, by CUDA events, after a warm-up; with
    ``flush``, each call timed on its own after flush()."""
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


def device_breakdown(fn, calls: int = 1) -> tuple[float, dict, dict]:
    """Device ms of ``calls`` calls of fn from a torch.profiler trace: the
    sum of every kernel and copy, the port's kernels by name, and how
    many launches of each the trace holds."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy, by, seen = 0.0, {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            # the kernel's function name, cut of namespaces and arguments
            fn_name = re.split(r"[(<]", e.name.replace(
                "(anonymous namespace)::", "").removeprefix("void "))[0]
            name = next((k for k in KERNELS if fn_name.endswith(k)), None)
            if name:
                by[name] = by.get(name, 0.0) + ms
                seen[name] = seen.get(name, 0) + 1
    return busy, by, seen


def snr_db(ref, test) -> float:
    ref, test = ref.double(), test.double()
    return float(10 * torch.log10(ref.pow(2).sum()
                                  / (ref - test).pow(2).sum()))


def body(S: int, nb: int, B: int, n_fft: int, frames) -> str:
    """The kernel body the tree's plan picks ("first cut" where the tree
    has no plan)."""
    try:
        from tinaural_torch.ops.ola_plan import ALIGN_BYTES, ola_plan
    except ImportError:
        return "first cut"
    aligned = frames.data_ptr() % ALIGN_BYTES == 0
    return ola_plan(S, nb, B, n_fft, aligned).body


def ola_call(frames, B: int):
    """The wrapper on a card, its plain version on the CPU."""
    if frames.device.type == "cuda":
        return br.overlap_add_cuda(frames, B)
    return overlap_add(frames.transpose(1, 2), B)


def kernel_items(dev, cut) -> list:
    """(label, record, kernel call after an L2 flush) of the kernel alone
    at SHAPES, each checked equal in bits to the plain version on the same
    frames."""
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    flush = torch.empty(L2_FLUSH_BYTES // 4 if dev.type == "cuda" else 1,
                        device=dev).zero_
    out = []
    for label, S, nb, B, n_fft, offset in SHAPES:
        nb = cut(nb, 3)
        numel = S * nb * 2 * n_fft
        flat = torch.randn(numel + offset, generator=g, device=dev)
        frames = flat[offset:].view(S, nb, 2, n_fft)
        got = ola_call(frames, B)
        ref = overlap_add(frames.transpose(1, 2), B)
        out_len = (nb - 1) * B + n_fft
        rec = {"kernel": f"overlap_add {label}", "S": S, "nb": nb, "B": B,
               "n_fft": n_fft, "body": body(S, nb, B, n_fft, frames),
               "bit_equal": bool(torch.equal(got, ref)),
               "max_abs_err": float((got - ref).abs().max()),
               "bound_ms": (numel + S * 2 * out_len) * 4 / HBM_BYTES_PER_S
               * 1e3}
        if not rec["bit_equal"]:
            raise SystemExit(f"overlap_add {label}: not equal in bits to "
                             f"the plain version ({rec['max_abs_err']})")
        kern = lambda frames=frames, B=B: ola_call(frames, B)
        out.append((label, rec, lambda kern=kern: (flush(), kern())))
        if dev.type == "cuda":
            rec["ms"] = cuda_ms(kern, 20, flush)
            rec["fold_ms"] = fold_ms(frames, B, flush)
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return out


def fold_ms(frames, B: int, flush) -> float:
    """`torch.nn.functional.fold` over the same frames, (S·2, n, nb)."""
    import torch.nn.functional as F

    S, nb, _, n = frames.shape
    cols = frames.permute(0, 2, 3, 1).reshape(S * 2, n, nb).contiguous()
    return cuda_ms(lambda: F.fold(cols, (1, (nb - 1) * B + n), (1, n),
                                  stride=(1, B)), 20, flush)


def trajectory_dirs(nb: int):
    return np.stack([np.linspace(0, 350, nb) % 360,
                     40 * np.sin(np.linspace(0, 20, nb))],
                    axis=1).astype(np.float32)


def renders(dev, cut) -> list:
    """(name, core call, float64 plain call) of (a), (h), (i), (k), (l)."""
    from tinaural_torch.models.renderer import (_batch_core,
                                                _static_block_core,
                                                _trajectory_core)
    from tinaural_torch.ops import assembly_mac as am
    from tinaural_torch.ops import block_step as bs

    table = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), dev)
    brir = tt.TorchTable.from_hrir_table(
        tt.load_hrir_set("synthetic", taps=2048), dev)
    B = 1024
    cfg = tt.RenderConfig(block_size=B)
    out = []
    N = cut(1 << 23, 9 * B)
    xa = torch.tensor(np.random.default_rng(0).standard_normal(
        (N // B, B)), dtype=torch.float32, device=dev)
    da = torch.tensor(trajectory_dirs(N // B), device=dev)
    out.append(("a trajectory", lambda: _trajectory_core(
                    table, xa, da, cfg, render=br.block_render),
                lambda: _trajectory_core(table, xa.double(), da, cfg,
                                         render=br.block_render_reference)))
    nh = cut(1 << 22, 9 * B)
    xh = torch.tensor(np.random.default_rng(3).standard_normal((nh // B, B)),
                      dtype=torch.float32, device=dev)
    dir2 = torch.tensor([123.4, 5.6], device=dev)
    step64 = bs.block_step_render_reference
    out.append(("h static", lambda: _static_block_core(table, xh, dir2, cfg),
                lambda: _static_block_core(table, xh.double(), dir2, cfg,
                                           render=step64)))
    rng = np.random.default_rng(2)
    S, nbi = cut(64, 3), cut(128, 9)
    xbs = torch.tensor(rng.standard_normal((S, nbi, B)), dtype=torch.float32,
                       device=dev)
    dmov = torch.tensor(np.stack([rng.uniform(0, 360, (S, nbi)),
                                  rng.uniform(-40, 90, (S, nbi))], -1),
                        dtype=torch.float32, device=dev)
    for name, tb, kern, plain in (
            ("i batch", table, bs.block_step_render, step64),
            ("k batch 2048 taps", brir, am.assembly_mac_render,
             am.assembly_mac_render_reference)):
        out.append((name, lambda tb=tb, kern=kern: _batch_core(
                        tb, xbs, dmov, cfg, render=kern),
                    lambda tb=tb, plain=plain: _batch_core(
                        tb, xbs.double(), dmov, cfg, render=plain)))
    Bl = 2048
    cfg_l = tt.RenderConfig(block_size=Bl, stream_block=Bl)
    nl = cut(1 << 23, 9 * Bl)
    xl = torch.tensor(np.random.default_rng(6).standard_normal(
        (nl // Bl, Bl)), dtype=torch.float32, device=dev)
    dl = torch.tensor(np.stack([np.linspace(0, 350, nl // Bl) % 360,
                                20 * np.sin(np.linspace(0, 9, nl // Bl))],
                               axis=1).astype(np.float32), device=dev)
    out.append(("l trajectory block 2048", lambda: _trajectory_core(
                    table, xl, dl, cfg_l, render=am.assembly_mac_render),
                lambda: _trajectory_core(
                    table, xl.double(), dl, cfg_l,
                    render=am.assembly_mac_render_reference)))
    return out


def build_ola_only() -> None:
    """Build and bind only ``csrc/block_render.cu`` (which holds
    `overlap_add` and the library's shared entry points), and print its
    ptxas lines for overlap_add."""
    from tinaural_torch.ops import _build

    sources = _build._sources
    _build._sources = lambda: [p for p in sources()
                               if p.suffix == ".cuh"
                               or p.name == "block_render.cu"]
    text = (_build.CSRC / "block_render.cu").read_text()
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if f"int {k}(" in text}
    t0 = time.perf_counter()
    _build.library()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    name = None
    for line in _build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "overlap_add" in name:
            print(json.dumps({"ptxas": name, "registers": int(m.group(1))}),
                  flush=True)
        if ("spill" in line and name and "overlap_add" in name
                and not line.strip().startswith("0 bytes")):
            print(json.dumps({"ptxas": name, "spills": line.strip()}),
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    cut = (lambda n, m: m) if args.small else (lambda n, m: n)
    if args.small:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise SystemExit("torch.cuda.is_available() is false")
        dev = torch.device("cuda", 0)
        print(json.dumps({"card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), "tree": tt.__file__}), flush=True)
        if args.kernels:
            build_ola_only()
    items = kernel_items(dev, cut)
    cores = [] if args.kernels else renders(dev, cut)
    res = [rec for _, rec, _ in items]
    for name, core, plain in cores:
        r = {"render": name, "snr_db_vs_plain_fp64": snr_db(plain(), core())}
        if dev.type == "cuda":
            r["core_ms"] = cuda_ms(core, 3)
        res.append(r)
    if dev.type == "cuda":
        for (_, rec, kern) in items:
            # a trace that lost launches reads "not measured"
            _, by, seen = device_breakdown(kern, calls=10)
            whole = seen.get("overlap_add_kernel") == 10
            rec["device_ms"] = (by["overlap_add_kernel"] / 10 if whole
                                else "not measured")
            if whole:
                rec["device_bound_share"] = rec["bound_ms"] / rec["device_ms"]
        for r, (_, core, _) in zip(res[len(items):], cores):
            # a trace can come back without device events: three tries
            for _ in range(3):
                busy, by, _ = device_breakdown(core)
                if by:
                    break
            else:
                busy = "not measured"
            r.update(device_busy_ms=busy, device_ms_by_kernel=by)
            if by:
                r["idle_share"] = max(0.0, 1 - busy / r["core_ms"])
    for r in res:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

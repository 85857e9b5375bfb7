#!/usr/bin/env python3
"""Time the block-step kernels, `block_spectra` and `block_spectra_mix`,
alone and in chip_smoke.py's renders that run them, on one CUDA card,
through what every tree of the port has: the kernels' wrappers and the
renderer's cores.

    PYTHONPATH=<tree> python3 scripts/torch_step_ab.py [--small] [--kernels]

Kernels alone, on seeded inputs at chip_smoke.py's shapes (128-tap
synthetic table, B = 1024, n_fft 2048; the filters made by the plain
`assemble_filters` on the card), each held against its plain float64
version (SNR printed): `block_spectra` at (i)'s 64 × 128 rows with
crossfade and at (h)'s 4096 rows of one source under one filter without
it; `block_spectra_mix` at (b)'s 64 sources × 128 blocks (crossfade), (c)'s
(no crossfade, one filter a source) and (b4)'s (dir_rate 4), on the
source chunk that the tree's scene route takes. Renders: (b), (c) and (b4)
on the mixdown route (B4) and, beside each, on B1's route; (h) static
`render` of 2^22 samples; (i) `render_batch` of 64 × 2^17. Each render's
core is held against its float64 plain path (SNR printed) and timed by
CUDA events (mean of 3 after a warm-up). Then, after
every timing (a profiler window slows the host-bound renders timed after
it), one torch.profiler window per kernel (10 calls: device ms a call)
and per render (device busy ms, idle share, ms by kernel). One JSON line
per item; the card's name and power limit first. It runs against
whatever tinaural_torch is first on sys.path, so a parent and a change
compare in one call (parent, change, change, parent). ``--small`` cuts
every size, so the CPU can rehearse the inputs and calls (without
timings). ``--kernels`` times the kernels alone and no render, and builds
only the two sources they need (``csrc/block_step.cu`` and
``csrc/block_render.cu``), printing their ptxas lines: a quick way to
compare edited copies of a tree. ``--pruned`` adds both kernels at the
shapes of chip_smoke.py's (o), (p) and (q) on the 16,384-tap table
(n_fft 32768: the pruned mode, or the split mode on a tree without it).
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import time

import numpy as np
import torch

import tinaural_torch as tt
from tinaural_torch.models.renderer import (_batch_core, _neighbours,
                                            _scene_core, _scene_static_core,
                                            _static_block_core)
from tinaural_torch.ops import _layout
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops import block_step as bs

KERNELS = ("assemble_filters_kernel", "block_spectra_kernel",
           "block_spectra_mix_kernel", "block_spectra_mix_inverse_kernel",
           "spectra_inverse_kernel", "overlap_add_kernel")
FLAGS = dict(apply_itd=True, apply_ild=True)
B = 1024


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
    ref, test = (torch.view_as_real(z.cdouble()) if z.is_complex()
                 else z.double() for z in (ref, test))
    return float(10 * torch.log10(ref.pow(2).sum()
                                  / (ref - test).pow(2).sum()))


def chunk_of(S: int, nb: int, n_fft: int, dev, crossfade: bool = True) -> int:
    """The source chunk of the tree's scene route over blocks of B (its
    mix_chunk took no n_fft before the register body, and no block length
    or crossfade before the pruned mode)."""
    sms = _layout.sm_count(dev)
    params = len(inspect.signature(bs.mix_chunk).parameters)
    if params >= 6:
        return bs.mix_chunk(S, nb, n_fft, sms, B, crossfade)
    if params == 4:
        return bs.mix_chunk(S, nb, n_fft, sms)
    return bs.mix_chunk(S, nb, sms)


def rows(table, shape, seed: int):
    rng = np.random.default_rng(seed)
    dirs = np.stack([rng.uniform(0, 360, shape), rng.uniform(-40, 90, shape)],
                    -1).astype(np.float32)
    return _neighbours(table, torch.tensor(dirs, device=table.device),
                       tt.RenderConfig())


def spectra_call(xbs, H, n_fft, **kw):
    """block_spectra's wrapper (its plain version on the CPU)."""
    fn = (bs.block_spectra_cuda if xbs.device.type == "cuda"
          else bs.block_spectra_reference)
    return fn(xbs, H, n_fft, **kw)


def mix_call(xbs, H, n_fft, **kw):
    """block_spectra_mix's wrapper (its plain version on the CPU)."""
    fn = (bs.block_spectra_mix_cuda if xbs.device.type == "cuda"
          else bs.block_spectra_mix_reference)
    return fn(xbs, H, n_fft, **kw)


def kernels(table, cut) -> list:
    """(name, kernel call, plain float64 call) of both kernels at (i),
    (h), (b), (c) and (b4)."""
    dev, n_fft = table.device, 2048
    out = []
    S, nb = cut(64, 3), cut(128, 5)
    xbs = torch.tensor(np.random.default_rng(1).standard_normal((S, nb, B)),
                       dtype=torch.float32, device=dev)
    for key, k, one, cf in (("i", 1, False, True), ("b", 1, False, True),
                            ("c", nb, True, False), ("b4", 4, False, True)):
        idx, w = rows(table, (S, 1 if one else -(-nb // k)), seed=k)
        H = br.assemble_filters_reference(idx, w, table, n_fft, **FLAGS)
        kw = dict(crossfade=cf, dir_rate=k)
        if key == "i":
            out.append(("i block_spectra",
                        lambda H=H, kw=kw: spectra_call(xbs, H, n_fft, **kw),
                        lambda H=H, kw=kw: bs.block_spectra_reference(
                            xbs.double(), H.cdouble(), n_fft, **kw)))
            continue
        kw["chunk"] = chunk_of(S, nb, n_fft, dev)
        out.append((f"{key} block_spectra_mix",
                    lambda H=H, kw=kw: mix_call(xbs, H, n_fft, **kw),
                    lambda H=H, kw=kw: bs.block_spectra_mix_reference(
                        xbs.double(), H.cdouble(), n_fft, **kw)))
    nb_h = cut(4096, 9)
    xh = torch.tensor(np.random.default_rng(2).standard_normal((1, nb_h, B)),
                      dtype=torch.float32, device=dev)
    H = br.assemble_filters_reference(*rows(table, (1, 1), seed=3), table,
                                      n_fft, **FLAGS)
    kw = dict(crossfade=False, dir_rate=nb_h)
    out.append(("h block_spectra",
                lambda: spectra_call(xh, H, n_fft, **kw),
                lambda: bs.block_spectra_reference(xh.double(), H.cdouble(),
                                                   n_fft, **kw)))
    return out


def pruned_kernels(dev, cut) -> list:
    """(name, kernel call, plain float64 call) of both kernels at the
    shapes of chip_smoke.py's renders (o), (p) and (q) on the 16,384-tap
    synthetic table (n_fft 32768; the pruned mode on a tree that has it,
    else the split mode): (o)'s 1024 rows of one source under one filter
    without crossfade, (p)'s 64 × 128 blocks under one filter a source
    without it, (q)'s under a filter a block with it."""
    table = tt.TorchTable.from_hrir_table(
        tt.load_hrir_set("synthetic", taps=cut(16384, 256)), dev)
    n_fft = cut(1 << 15, 2048)
    rng = np.random.default_rng(4)
    out = []
    nb_o = cut(1024, 9)
    xo = torch.tensor(rng.standard_normal((1, nb_o, B)), dtype=torch.float32,
                      device=dev)
    H = br.assemble_filters_reference(*rows(table, (1, 1), seed=5), table,
                                      n_fft, **FLAGS)
    kw_o = dict(crossfade=False, dir_rate=nb_o)
    out.append(("o block_spectra", lambda: spectra_call(xo, H, n_fft, **kw_o),
                lambda: bs.block_spectra_reference(xo.double(), H.cdouble(),
                                                   n_fft, **kw_o)))
    S, nb = cut(64, 3), cut(128, 5)
    xbs = torch.tensor(rng.standard_normal((S, nb, B)), dtype=torch.float32,
                       device=dev)
    for key, one, cf in (("p", True, False), ("q", False, True)):
        Hk = br.assemble_filters_reference(
            *rows(table, (S, 1 if one else nb), seed=6), table, n_fft,
            **FLAGS)
        kw = dict(crossfade=cf, dir_rate=nb if one else 1,
                  chunk=chunk_of(S, nb, n_fft, dev, cf))
        out.append((f"{key} block_spectra_mix",
                    lambda Hk=Hk, kw=kw: mix_call(xbs, Hk, n_fft, **kw),
                    lambda Hk=Hk, kw=kw: bs.block_spectra_mix_reference(
                        xbs.double(), Hk.cdouble(), n_fft, **kw)))
    return out


def renders(table, cut) -> list:
    """(name, core call, float64 plain call) of each render: (b), (c),
    (b4) on both scene routes, (h) and (i)."""
    dev = table.device
    cfg = tt.RenderConfig(block_size=B)
    rng = np.random.default_rng(2)
    S, N = cut(64, 3), cut(1 << 17, 5 * B)
    xbs = torch.tensor(rng.standard_normal((S, N // B, B)),
                       dtype=torch.float32, device=dev)
    dmov = torch.tensor(np.stack([rng.uniform(0, 360, (S, N // B)),
                                  rng.uniform(-40, 90, (S, N // B))], -1),
                        dtype=torch.float32, device=dev)
    dstat = torch.tensor(np.stack([rng.uniform(0, 360, S),
                                   rng.uniform(-40, 90, S)], -1),
                         dtype=torch.float32, device=dev)
    cfg4 = cfg.replace(dir_rate=4)
    mix64 = bs.scene_step_render_reference
    out = []
    for route, render in (("B4", bs.scene_step_render),
                          ("B1", br.block_render)):
        out += [(f"b scene moving {route}", lambda render=render: _scene_core(
                    table, xbs, dmov, cfg, render=render),
                 lambda: _scene_core(table, xbs.double(), dmov, cfg,
                                     render=mix64)),
                (f"c scene static {route}",
                 lambda render=render: _scene_static_core(
                     table, xbs, dstat, cfg, render=render),
                 lambda: _scene_static_core(table, xbs.double(), dstat, cfg,
                                            render=mix64)),
                (f"b4 scene moving dir_rate 4 {route}",
                 lambda render=render: _scene_core(
                     table, xbs, dmov, cfg4, render=render),
                 lambda: _scene_core(table, xbs.double(), dmov, cfg4,
                                     render=mix64))]
    nh = cut(1 << 22, 9 * B)
    xh = torch.tensor(np.random.default_rng(3).standard_normal((nh // B, B)),
                      dtype=torch.float32, device=dev)
    dir2 = torch.tensor([123.4, 5.6], device=dev)
    step64 = bs.block_step_render_reference
    out.append(("h static", lambda: _static_block_core(table, xh, dir2, cfg),
                lambda: _static_block_core(table, xh.double(), dir2, cfg,
                                           render=step64)))
    out.append(("i batch", lambda: _batch_core(table, xbs, dmov, cfg,
                                               render=bs.block_step_render),
                lambda: _batch_core(table, xbs.double(), dmov, cfg,
                                    render=step64)))
    return out


def build_step_only() -> None:
    """Build and bind only the block step's source (and block_render.cu,
    which holds the library's shared entry points), and print their
    ptxas lines."""
    from tinaural_torch.ops import _build

    keep = ("block_render.cu", "block_step.cu")
    sources = _build._sources
    _build._sources = lambda: [p for p in sources()
                               if p.suffix == ".cuh" or p.name in keep]
    text = "".join((_build.CSRC / k).read_text() for k in keep)
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if f"int {k}(" in text}
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    name = None
    for line in _build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "block_spectra" in name:
            print(f"ptxas {name}: {m.group(1)} registers", flush=True)
        if ("spill" in line and name and "block_spectra" in name
                and not line.strip().startswith("0 bytes")):
            print(f"ptxas {name}: {line.strip()}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--pruned", action="store_true")
    args = ap.parse_args()
    cut = (lambda n, m: m) if args.small else (lambda n, m: n)
    if args.small:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise SystemExit("torch.cuda.is_available() is false")
        dev = torch.device("cuda", 0)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        if args.kernels:
            build_step_only()
    table = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), dev)
    items = kernels(table, cut) + (pruned_kernels(dev, cut) if args.pruned
                                   else [])
    res = []
    for name, kern, plain in items:
        res.append({"kernel": name, "snr_db_vs_plain_fp64": snr_db(plain(),
                                                                   kern())})
    cores = [] if args.kernels else renders(table, cut)
    for name, core, plain in cores:
        r = {"render": name, "snr_db_vs_plain_fp64": snr_db(plain(), core())}
        if dev.type == "cuda":
            r["core_ms"] = cuda_ms(core, 3)
        res.append(r)
    if dev.type == "cuda":
        for r, (_, kern, _) in zip(res, items):
            # a trace that lost launches reads "not measured"
            _, by, seen = device_breakdown(kern, calls=10)
            whole = by and all(v == 10 for v in seen.values())
            r["device_ms"] = (sum(by.values()) / 10 if whole
                              else "not measured")
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

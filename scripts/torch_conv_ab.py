#!/usr/bin/env python3
"""Time the partitioned convolution's kernels, `stream_conv` and
`partitioned_conv` (with `frame_spectra` where the tree has it), alone
and in chip_smoke.py's streaming and partitioned renders, on one CUDA card,
through what every tree of the port has: the kernels' wrappers, the public
entry points and the renderer's cores with their default routes.

    PYTHONPATH=<tree> python3 scripts/torch_conv_ab.py [--small]

Kernels alone, on seeded random inputs at chip_smoke.py's shapes, each
held against its plain float64 version (SNR printed): `stream_conv` with
blend and as the hold step at (d) (1024 streams, 128 taps: P 1), (e) (64
streams, 2048 taps: P 9) and (f) (one stream), B 256; `partitioned_conv`
at (g) (2048 blocks of 512, 2048 taps: P 5), (g4) (the same at dir_rate
4), (j) (256 blocks of 512, 44,100 taps: P 87) and (j4). Renders: (d)
`BatchedStream.push_many` of 1024 streams × 32 blocks, (e) 64 × 8 at
update rate 1, (f) 64 `Stream.push` calls, (g), (g4), (j) and (j4)
`render_streamed`. Each render's core is timed by CUDA events (mean of 3
after a warm-up; (f): the median wall time of a push read back). Then,
after every timing (a profiler session slows the host-bound renders timed
after it), one torch.profiler window per kernel call (10 calls: device ms
a call of each of the port's kernels it ran) and per render (device busy
ms, idle share, ms by kernel). One JSON line per item; the card's name
and power limit first. It runs against whatever tinaural_torch is first
on sys.path, so a parent and a change compare in one call (parent,
change, change, parent). ``--small`` cuts every size, so the CPU can
rehearse the inputs and calls (without timings). ``--kernels`` times the
kernels alone and no render, and builds only the two sources they need
(``csrc/partitioned.cu`` and ``csrc/block_render.cu``), printing their
ptxas lines: a quick way to compare edited copies of a tree.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

import tinaural_torch as tt
from tinaural_torch.models.renderer import _neighbours, _partitioned_core
from tinaural_torch.models.streaming import _batch_scan_core, init_state
from tinaural_torch.ops import partitioned_conv as pc

KERNELS = ("assemble_partitions_kernel", "stream_conv_kernel",
           "frame_spectra_kernel", "partitioned_conv_kernel")
FLAGS = dict(apply_itd=True, apply_ild=True)


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
            name = next((k for k in KERNELS if k in e.name), None)
            if name:
                by[name] = by.get(name, 0.0) + ms
                seen[name] = seen.get(name, 0) + 1
    return busy, by, seen


def snr_db(ref, test) -> float:
    ref, test = ref.double().cpu(), test.double().cpu()
    return float(10 * torch.log10(ref.pow(2).sum()
                                  / (ref - test).pow(2).sum()))


def rows(table, shape, seed: int):
    rng = np.random.default_rng(seed)
    dirs = np.stack([rng.uniform(0, 360, shape), rng.uniform(-40, 90, shape)],
                    -1).astype(np.float32)
    return _neighbours(table, torch.tensor(dirs, device=table.device),
                       tt.RenderConfig())


def track(nb: int) -> np.ndarray:
    return np.stack([np.linspace(0, 350, nb) % 360,
                     20 * np.sin(np.linspace(0, 9, nb))],
                    axis=1).astype(np.float32)


def stream_call(args, crossfade: bool):
    """stream_conv's wrapper (its plain version on the CPU)."""
    conv = (pc.stream_conv_cuda if args[0].device.type == "cuda"
            else pc.stream_conv_reference)
    return conv(*args, crossfade=crossfade)


def conv_call(xb, H, dir_rate: int):
    """partitioned_conv's wrapper, whichever kernels it launches (its plain
    version on the CPU)."""
    conv = (pc.partitioned_conv_cuda if xb.device.type == "cuda"
            else pc.partitioned_conv_reference)
    return conv(xb, *H, crossfade=True, dir_rate=dir_rate)


def stream_kernels(tables: dict, cut) -> list:
    """(name, kernel call, plain float64 call) of stream_conv at (d), (e),
    (f), with blend and as the hold step, on one random carried state
    (half the streams started)."""
    out = []
    for key, taps, S in (("d", 128, cut(1024, 8)), ("e", 2048, cut(64, 3)),
                         ("f", 128, 1)):
        table, B = tables[taps], 256
        rng = np.random.default_rng(S + taps)
        H = pc.assemble_partitions_reference(*rows(table, (S,), 1), table,
                                             B, **FLAGS)
        ph = pc.assemble_partitions_reference(*rows(table, (S,), 2), table,
                                              B, **FLAGS)
        P = H[0].shape[1]
        t32 = lambda *s: torch.tensor(rng.standard_normal(s),
                                      dtype=torch.float32,
                                      device=table.device)
        state = (t32(S, B), t32(S, B), t32(S, P, B + 1) * 8,
                 t32(S, P, B + 1) * 8)
        started = (torch.arange(S, device=table.device) % 2).float()
        for name, hs, cf in ((f"{key} stream_conv", (*H, *ph), True),
                             (f"{key} stream_conv hold", (*ph, *ph), False)):
            args = (*state, *hs, started)
            out.append((name, lambda args=args, cf=cf: stream_call(args, cf),
                        lambda args=args, cf=cf: pc.stream_conv_reference(
                            *(a.double() for a in args), crossfade=cf)))
    return out


def partitioned_kernels(tables: dict, cut) -> list:
    """(name, kernel call, plain float64 call) of partitioned_conv at (g),
    (g4), (j) and (j4)."""
    out = []
    for key, taps, nb in (("g", 2048, cut(2048, 16)),
                          ("j", 44100, cut(256, 8))):
        table, B = tables[taps], 512
        xb = torch.tensor(np.random.default_rng(4).standard_normal((nb, B)),
                          dtype=torch.float32, device=table.device)
        for k in (1, 4):
            H = pc.assemble_partitions_reference(
                *rows(table, (-(-nb // k),), 3), table, B, **FLAGS)
            out.append((f"{key}{4 if k == 4 else ''} partitioned_conv",
                        lambda xb=xb, H=H, k=k: conv_call(xb, H, k),
                        lambda xb=xb, H=H, k=k: pc.partitioned_conv_reference(
                            xb.double(), *(h.double() for h in H),
                            crossfade=True, dir_rate=k)))
    return out


def renders(tables: dict, cut) -> list:
    """(name, core call, call timed by the host clock or None) of each
    render."""
    dev = tables[128].device
    out = []
    for key, taps, S, K in (("d serving", 128, cut(1024, 4), cut(32, 2)),
                            ("e BRIR serving k=1", 2048, cut(64, 2),
                             cut(8, 2))):
        table, B = tables[taps], 256
        cfg = tt.RenderConfig(stream_block=B, stream_update_rate=1)
        rng = np.random.default_rng(S + K + 1)
        blocks = torch.tensor(rng.standard_normal((K, S, B)),
                              dtype=torch.float32, device=dev)
        azs = torch.tensor((np.linspace(0, 350, S)[None]
                            + 2.0 * np.arange(K)[:, None]) % 360.0,
                           dtype=torch.float32, device=dev)
        st0 = init_state(table, cfg, S)
        out.append((key, lambda table=table, st0=st0, blocks=blocks,
                    azs=azs, cfg=cfg: _batch_scan_core(
                        table, st0, blocks, azs, torch.zeros_like(azs),
                        cfg)[1], None))
    table, B, n = tables[128], 256, cut(64, 4)
    cfg_f = tt.RenderConfig(stream_block=B)
    x = np.random.default_rng(9).standard_normal((n, B)).astype(np.float32)
    azs = ((30.0 + 2.0 * np.arange(n)) % 360.0).astype(np.float32)

    def pushes():
        s = tt.Stream(table, cfg_f)
        return [s.push(x[i], float(azs[i]), 0.0).cpu() for i in range(n)]

    out.append(("f latency", pushes, pushes))
    for key, taps, N in (("g streamed", 2048, cut(1 << 20, 1 << 13)),
                         ("j streamed", 44100, cut(1 << 17, 1 << 12))):
        table = tables[taps]
        nb = N // 512
        xq = torch.tensor(np.random.default_rng(6).standard_normal(
            (nb, 512)), dtype=torch.float32, device=dev)
        dq = torch.tensor(track(nb), device=dev)
        for k in (1, 4):
            cfg = tt.RenderConfig(stream_block=512, dir_rate=k)
            name = f"{key} dir_rate {k}"
            out.append((name, lambda table=table, xq=xq, dq=dq, cfg=cfg:
                        _partitioned_core(table, xq, dq, cfg), None))
    return out


def build_conv_only() -> None:
    """Build and bind only the sources of the partitioned convolution's
    kernels, and print their ptxas lines."""
    import re

    from tinaural_torch.ops import _build

    keep = ("block_render.cu", "partitioned.cu")
    sources = _build._sources
    _build._sources = lambda: [p for p in sources()
                               if p.suffix == ".cuh" or p.name in keep]
    text = (_build.CSRC / "partitioned.cu").read_text()
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if k == "tt_max_shared_bytes" or f"int {k}(" in text}
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
        if m and name:
            print(f"ptxas {name}: {m.group(1)} registers", flush=True)
        if "spill" in line and name and not line.strip().startswith("0 bytes"):
            print(f"ptxas {name}: {line.strip()}", flush=True)


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
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
    tables = {taps: tt.TorchTable.from_hrir_table(
                  tt.load_hrir_set("synthetic", taps=cut(taps, min(taps, 512))),
                  dev)
              for taps in (128, 2048, 44100)}
    if args.kernels and dev.type == "cuda":
        build_conv_only()
    kernels = stream_kernels(tables, cut) + partitioned_kernels(tables, cut)
    res = []
    for name, kern, plain in kernels:
        got = kern()
        ref = plain()
        got, ref = (got[0], ref[0]) if isinstance(got, tuple) else (got, ref)
        res.append({"kernel": name, "snr_db_vs_plain_fp64": snr_db(ref, got)})
    items = [] if args.kernels else renders(tables, cut)
    for name, core, host in items:
        r = {"render": name}
        if dev.type == "cuda":
            if host is None:
                r["core_ms"] = cuda_ms(core, 3)
            else:
                host()
                walls = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    host()
                    walls.append((time.perf_counter() - t0) * 1e3)
                r["wall_ms_per_push_median"] = float(np.median(walls)) / cut(
                    64, 4)
        else:
            (host or core)()
        res.append(r)
    if dev.type == "cuda":
        for r, (_, kern, _) in zip(res, kernels):
            # a trace that lost launches reads "not measured"
            _, by, seen = device_breakdown(kern, calls=10)
            whole = by and all(v == 10 for v in seen.values())
            r["device_ms_by_kernel"] = {k: v / 10 for k, v in by.items()}
            r["device_ms"] = (sum(by.values()) / 10 if whole
                              else "not measured")
        for r, (_, core, host) in zip(res[len(kernels):], items):
            # (f)'s pushes read back, as chip_smoke.py profiles them; a
            # trace can come back without device events: three tries
            for _ in range(3):
                busy, by, _ = device_breakdown(core if host is None else host)
                if by:
                    break
            else:
                busy = "not measured"
            r.update(device_busy_ms=busy, device_ms_by_kernel=by)
            if "core_ms" in r and by:
                r["idle_share"] = max(0.0, 1 - busy / r["core_ms"])
    for r in res:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

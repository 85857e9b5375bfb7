#!/usr/bin/env python3
"""Time the natural-order kernel `assembly_mac` alone and in the renders
that run it, on one CUDA card, through what every tree of the port has:
the wrapper `assembly_mac_cuda` and the renderer's cores.

    PYTHONPATH=<tree> python3 scripts/torch_mac_ab.py [--small] [--kernels]

Kernel alone, on the input spectra of the natural-order route (seeded
blocks, `first` at each source's block 0, rows from seeded directions):
(j) 128 rows × 16,384 taps at n_fft 32768 (the cluster mode, clusters of
2, where the tree has it; the split mode before), (j) again with the
split mode forced, (j65536) 128 rows × 44,100 taps at n_fft 65536
(clusters of 4), (k) 8192 rows × 2048 taps and (l) 4096 rows × 128 taps at
n_fft 4096 (the register kernel). Each is held against the plain float32
version (SNR) and the plain float64 one, checked equal in bits over two
calls, and timed by CUDA events (mean of 10, each call after a 256 MB
write that evicts L2) beside its bound: the larger of its bytes (idx, w,
first, the table rows idx names, Xu, Xd, Y, each once) over 3.35 TB/s
and its operations (FFTs as 5·n·log2 n) over 67 TFLOP/s fp32. Renders,
each core held against its float64 plain path and timed by CUDA events
(mean of 3 after a warm-up): (j) a 2^17-sample trajectory at 16,384 taps
on B9 and on B1, (k) `render_batch` of 64 × 2^17 at 2048 taps (B9), (l) a
2^23 trajectory at block 2048 (B9). Then, after every timing, one
torch.profiler window per kernel shape (10 calls: device ms a call) and
per render (device busy ms, idle share, ms by kernel). One JSON line per
item, the card's name and power limit first. It runs against whatever
tinaural_torch is first on sys.path, so a parent and a change compare in
one call (parent, change, change, parent).

``--small`` cuts every size and runs the plain versions on the CPU, so
the CPU can rehearse the inputs and calls (no timings). ``--kernels``
times the kernel alone and no render, and builds only
``csrc/assembly_mac.cu`` and ``csrc/block_render.cu``, printing
`assembly_mac`'s ptxas lines.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import time

import numpy as np
import torch

import tinaural_torch as tt
from tinaural_torch.ops import _layout
from tinaural_torch.ops import assembly_mac as am
from tinaural_torch.ops import block_render as br

KERNELS = ("assemble_filters_kernel", "block_spectra_kernel",
           "block_spectra_mix_inverse_kernel", "spectra_inverse_kernel",
           "assembly_mac_kernel", "overlap_add_kernel")
# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
FLAGS = dict(apply_itd=True, apply_ild=True)

# (label, taps, sources, blocks, block, forced split) of the kernel alone
SHAPES = (("j", 16384, 1, 128, 1024, False),
          ("j forced split", 16384, 1, 128, 1024, True),
          ("j65536", 44100, 1, 128, 1024, False),
          ("k", 2048, 64, 128, 1024, False),
          ("l", 128, 1, 4096, 2048, False))


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
            fn_name = re.split(r"[(<]", e.name.replace(
                "(anonymous namespace)::", "").removeprefix("void "))[0]
            name = next((k for k in KERNELS if fn_name.endswith(k)), None)
            if name:
                by[name] = by.get(name, 0.0) + ms
                seen[name] = seen.get(name, 0) + 1
    return busy, by, seen


def snr_db(ref, test) -> float:
    if ref.is_complex():
        ref, test = torch.view_as_real(ref), torch.view_as_real(test)
    ref, test = ref.double(), test.double()
    return float(10 * torch.log10(ref.pow(2).sum()
                                  / (ref - test).pow(2).sum()))


def fft_flops(n: int) -> float:
    return 5.0 * n * math.log2(n)


def bound_ms(table, idx, rows: int, n_fft: int) -> tuple[float, str]:
    """The kernel's bound with crossfade (chip_smoke.py's count)."""
    F = n_fft // 2 + 1
    cells = table.h.shape[0] * table.h.shape[1]
    per_row = (table.h.numel() + table.delays.numel()
               + table.gains.numel()) // cells  # both ears' taps, d, g
    table_bytes = 4 * per_row * int(idx.unique().numel())
    nbytes = rows * 36 + table_bytes + rows * F * 16 + rows * 2 * F * 8
    L = 1 << math.ceil(math.log2(table.taps + 64))
    flops = rows * (16 * table.taps + 2 * fft_flops(L) + 16 * (L // 2 + 1)
                    + fft_flops(n_fft) + 2 * F * 14)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS_PER_S * 1e3
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def mode(taps: int, n_fft: int, forced: bool) -> str:
    """The buffer mode the tree's plan takes ("split" for a tree whose
    plan has no cluster mode; a tree whose plans state no ``body`` reads
    their ``register`` and ``cluster`` properties)."""
    from tinaural_torch.ops.mac_plan import mac_plan

    plan = mac_plan(taps, n_fft)
    body = getattr(plan, "body", None) or (
        "register" if plan.register
        else "cluster" if getattr(plan, "cluster", False) else "split")
    return "split" if forced or body not in ("register", "cluster") else body


def mac_call(idx, w, table, Xu, Xd, first, n_fft, forced):
    """The wrapper on a card (the split mode forced where asked), its plain
    version on the CPU."""
    if Xu.device.type != "cuda":
        return am.assembly_mac_reference(idx, w, table, Xu, Xd, first, n_fft,
                                         crossfade=True, **FLAGS)
    _layout.force_work = _layout.SPLIT_WORK if forced else 0
    try:
        return am.assembly_mac_cuda(idx, w, table, Xu, Xd, first, n_fft,
                                    crossfade=True, **FLAGS)
    finally:
        _layout.force_work = 0


def kernel_items(dev, cut, tables) -> list:
    """(label, record, kernel call after an L2 flush) of the kernel alone
    at SHAPES."""
    from tinaural_torch.models.renderer import _n_fft, _neighbours

    flush = torch.empty(L2_FLUSH_BYTES // 4 if dev.type == "cuda" else 1,
                        device=dev).zero_
    out = []
    for label, taps, S, nb, blk, forced in SHAPES:
        table = tables[taps]
        S, nb = cut(S, 1), cut(nb, 3)
        rows = S * nb
        n_fft = _n_fft(table, blk)
        rng = np.random.default_rng(rows + taps)
        dirs = torch.tensor(np.stack([rng.uniform(0, 360, rows),
                                      rng.uniform(-40, 90, rows)], -1),
                            dtype=torch.float32, device=dev)
        idx, w = _neighbours(table, dirs, tt.RenderConfig())
        xbs = torch.tensor(rng.standard_normal((S, nb, blk)),
                           dtype=torch.float32, device=dev)
        Xu, Xd = am._input_spectra(xbs, n_fft, True)
        first = am._first_rows(S, nb, dev)
        args = (idx, w, table, Xu, Xd, first, n_fft)
        got = mac_call(*args, forced)
        ref = am.assembly_mac_reference(*args, crossfade=True, **FLAGS)
        ref64 = am.assembly_mac_reference(
            idx, w.double(), table, Xu.to(torch.complex128),
            Xd.to(torch.complex128), first, n_fft, crossfade=True, **FLAGS)
        b, by = bound_ms(table, idx, rows, n_fft)
        rec = {"kernel": f"assembly_mac {label}", "rows": rows, "taps": taps,
               "n_fft": n_fft, "mode": mode(table.taps, n_fft, forced),
               "snr_db": snr_db(ref, got), "snr_fp64_db": snr_db(ref64, got),
               "same_bits": bool(torch.equal(got, mac_call(*args, forced))),
               "bound_ms": b, "bound_by": by}
        if not rec["same_bits"] or rec["snr_db"] < 100:
            raise SystemExit(f"assembly_mac {label}: {rec}")
        kern = lambda args=args, forced=forced: mac_call(*args, forced)
        out.append((label, rec, lambda kern=kern: (flush(), kern())))
        if dev.type == "cuda":
            rec["ms"] = cuda_ms(kern, 10, flush)
            rec["bound_share"] = b / rec["ms"]
    return out


def renders(dev, cut, tables) -> list:
    """(name, core call, float64 plain call) of (j) on B9 and B1, (k), (l)."""
    from tinaural_torch.models.renderer import _batch_core, _trajectory_core

    B = 1024
    cfg = tt.RenderConfig(block_size=B, stream_block=B)
    out = []
    nj = cut(1 << 17, 9 * B)
    xj = torch.tensor(np.random.default_rng(6).standard_normal(
        (nj // B, B)), dtype=torch.float32, device=dev)
    dj = torch.tensor(np.stack([np.linspace(0, 350, nj // B) % 360,
                                20 * np.sin(np.linspace(0, 9, nj // B))],
                               axis=1).astype(np.float32), device=dev)
    plain_j = lambda: _trajectory_core(tables[16384], xj.double(), dj, cfg,
                                       render=am.assembly_mac_render_reference)
    for name, kern in (("j trajectory 16384 taps", am.assembly_mac_render),
                       ("j trajectory 16384 taps on B1", br.block_render)):
        out.append((name, lambda kern=kern: _trajectory_core(
            tables[16384], xj, dj, cfg, render=kern), plain_j))
    rng = np.random.default_rng(2)
    S, nbk = cut(64, 2), cut(128, 9)
    xbs = torch.tensor(rng.standard_normal((S, nbk, B)), dtype=torch.float32,
                       device=dev)
    dmov = torch.tensor(np.stack([rng.uniform(0, 360, (S, nbk)),
                                  rng.uniform(-40, 90, (S, nbk))], -1),
                        dtype=torch.float32, device=dev)
    out.append(("k batch 2048 taps", lambda: _batch_core(
                    tables[2048], xbs, dmov, cfg,
                    render=am.assembly_mac_render),
                lambda: _batch_core(tables[2048], xbs.double(), dmov, cfg,
                                    render=am.assembly_mac_render_reference)))
    Bl = 2048
    cfg_l = tt.RenderConfig(block_size=Bl, stream_block=Bl)
    nl = cut(1 << 23, 9 * Bl)
    xl = torch.tensor(np.random.default_rng(6).standard_normal(
        (nl // Bl, Bl)), dtype=torch.float32, device=dev)
    dl = torch.tensor(np.stack([np.linspace(0, 350, nl // Bl) % 360,
                                20 * np.sin(np.linspace(0, 9, nl // Bl))],
                               axis=1).astype(np.float32), device=dev)
    out.append(("l trajectory block 2048", lambda: _trajectory_core(
                    tables[128], xl, dl, cfg_l, render=am.assembly_mac_render),
                lambda: _trajectory_core(
                    tables[128], xl.double(), dl, cfg_l,
                    render=am.assembly_mac_render_reference)))
    return out


def build_mac_only() -> None:
    """Build and bind only ``csrc/assembly_mac.cu`` and
    ``csrc/block_render.cu`` (the library's shared entry points), and print
    assembly_mac's ptxas lines."""
    from tinaural_torch.ops import _build

    keep = ("assembly_mac.cu", "block_render.cu")
    sources = _build._sources
    _build._sources = lambda: [p for p in sources()
                               if p.suffix == ".cuh" or p.name in keep]
    text = "".join((_build.CSRC / k).read_text() for k in keep)
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
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and "assembly_mac" in name:
            spills = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "assembly_mac" in name:
            print(json.dumps({"ptxas": name, "registers": int(m.group(1)),
                              "spill_stores_loads": spills}), flush=True)
            name = None


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
            build_mac_only()
    torch.backends.cuda.matmul.allow_tf32 = False
    tables = {taps: tt.TorchTable.from_hrir_table(
                  tt.load_hrir_set("synthetic", taps=taps), dev)
              for taps in ((128, 2048, 16384) if args.small
                           else (128, 2048, 16384, 44100))}
    if args.small:
        tables[44100] = tables[16384]
    items = kernel_items(dev, cut, tables)
    cores = [] if args.kernels else renders(dev, cut, tables)
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
            whole = seen.get("assembly_mac_kernel") == 10
            rec["device_ms"] = (by["assembly_mac_kernel"] / 10 if whole
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

#!/usr/bin/env python3
"""The cost of the port's spans, on one CUDA card, in one process: each
benchmark cell's entry call (``kemar128.trajectory``: `render_trajectory`
of 2^23 samples; ``kemar128.scene``: `render_scene` of 64 moving sources ×
2^17; ``kemar2048.batch``: `render_batch` of 64 × 2^17 at 2048 taps) on the
cell's own inputs, timed in interleaved blocks under three variants:

- ``parent``: another tree's `tinaural_torch` (``--parent <tree>``),
  loaded beside this one under another name, its spans (if it has any)
  off;
- ``off``: this tree, tracing off;
- ``on``: this tree inside `profiling.tracing()`, no profiler.

    python3 scripts/torch_tracing_cost.py --parent <tree> [--rounds R]
        [--calls K] [--small] [--out FILE]

Each round runs K calls of each variant, the order reversed every other
round. A call's host ms is from the entry call's start to its return (the
benchmark's ``host_ms.render``); its call ms ends after
`torch.cuda.synchronize()`. Printed, one JSON line per cell: each variant's
median and quartiles over all its calls, and the paired differences
(off − parent, on − off) of each round's medians, as a share of the
round's base, with their median and quartiles. Then, after every timing
(a profiler session slows the host-bound calls timed after it): the
registry's own µs a call, off and on (a root with six spans and five
counts, as a scene call has, with no work inside), then one line per cell
of its spans: self ms a call by span name (the root's: what no layer
covers), first over K calls inside `tracing()` and then over four calls
inside one `torch.profiler` session (the second and later calls; the first
pays for the session's set-up), with each counter's change a call.
``--small`` cuts the sizes so the CPU can rehearse it (times then are the
CPU's). The card's name and power limit come first; with ``--out`` the
lines are also appended to that file.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.harness import inputs, spec, system  # noqa: E402

import tinaural_torch  # noqa: E402
from tinaural_torch.utils import profiling  # noqa: E402

CELLS = ("kemar128.trajectory", "kemar128.scene", "kemar2048.batch")
SEED = 2**31 + 2207


def card_line() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def load_tree(tree: Path, alias: str):
    """``tree``'s `tinaural_torch` as package ``alias``, its library taken
    from this tree's build where the sources hash alike."""
    pkg = tree / "tinaural_torch"
    sp = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(sp)
    sys.modules[alias] = mod
    sp.loader.exec_module(mod)
    if torch.cuda.is_available():
        theirs = importlib.import_module(f"{alias}.ops._build")
        ours = importlib.import_module("tinaural_torch.ops._build")
        want, have = theirs.library_path(), ours.build()
        if not want.exists() and want.name == have.name:
            want.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(have, want)
    return mod


def renderer(pkg, cfg: dict, h: np.ndarray, device):
    """``pkg``'s renderer of the cell's table (the benchmark's own
    `system.program_table`, through ``pkg``'s modules)."""
    name = pkg.__name__
    grids = importlib.import_module(f"{name}.data.grids")
    table = importlib.import_module(f"{name}.data.table")
    g = cfg["grid"]
    grid = grids.SphericalGrid(elevs=np.asarray(g["elevs"], np.float64),
                               az_counts=np.asarray(g["az_counts"], np.int64))
    arrays = table.build_table(h, grid, cfg["sample_rate"], decompose=True)
    t = table.TorchTable.from_hrir_table(arrays, device)
    return pkg.BinauralRenderer(t, pkg.RenderConfig(
        sample_rate=cfg["sample_rate"], **cfg["render"]))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def quartiles(v) -> dict:
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return {"p25": q[0], "median": q[1], "p75": q[2], "n": len(v)}


def span_split(spans) -> dict:
    """Self ms a call by span name (a span's duration less the spans it
    holds; the root's is what no layer covers), over the calls whose roots
    ``spans`` holds."""
    roots = [s for s in spans if s.parent is None]
    ids = {r.id for r in roots}
    dur = {s.id: s.end_ns - s.start_ns for s in spans}
    inner = {}
    for s in spans:
        if s.parent is not None:
            inner[s.parent] = inner.get(s.parent, 0) + dur[s.id]
    by = {}
    for s in spans:
        if s.call in ids:
            by[s.name] = by.get(s.name, 0) + dur[s.id] - inner.get(s.id, 0)
    n = len(roots)
    out = {k: v / n / 1e6 for k, v in sorted(by.items())}
    out["root_ms"] = sum(dur[r.id] for r in roots) / n / 1e6
    out["calls"] = n
    counts = {}
    for r in roots:
        for k, v in r.counts.items():
            counts[k] = counts.get(k, 0) + v / n
    out["counts_a_call"] = dict(sorted(counts.items()))
    return out


def machinery(n: int = 20000) -> dict:
    """µs a call of the registry alone, as a scene call uses it: a root
    holding six spans (one nested) and five counts, off and inside
    `tracing()`."""
    span, count = profiling.span, profiling.count

    def one():
        with span("tt.render_scene"):
            with span("tt.dedupe"):
                pass
            with span("tt.blockify"):
                with span("tt.h2d"):
                    count("cost.bytes", 8)
                    count("cost.syncs")
            with span("tt.h2d"):
                count("cost.bytes", 8)
                count("cost.syncs")
            with span("tt.lookup"):
                pass
            with span("tt.route"):
                count("cost.syncs")

    def timed():
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        return 1e6 * (time.perf_counter() - t0) / n

    off = min(timed() for _ in range(3))
    with profiling.tracing():
        on = min(timed() for _ in range(3))
    profiling.clear()
    return {"off_us": off, "on_us": on}


def setup(name: str, parent, small: bool, device) -> dict:
    """The cell's inputs and each variant's bound entry call, warm."""
    cell = spec.cell(name)
    cfg, p = cell.config, cell.traffic
    S, N = p["sources"], p["samples"] >> (6 if small else 0)
    if small:
        S = min(S, 4)
    nb = -(-N // cfg["render"]["block_size"])
    h = system.raw_hrirs(cfg, SEED)
    xs = inputs.signals(SEED, 0, (S, N), p["rms"])
    dirs = inputs.sweeps(SEED, 0, S, nb, p["path"])
    args = ((xs[0], dirs[0]) if p["entry"] == "render_trajectory"
            else (xs, dirs))
    ours = getattr(renderer(tinaural_torch, cfg, h, device), p["entry"])
    theirs = getattr(renderer(parent, cfg, h, device), p["entry"])
    fns = {"parent": theirs, "off": ours, "on": ours}
    for fn in (theirs, ours):  # built and warm
        for _ in range(2):
            fn(*args)
        sync(device)
    return {"cell": name, "S": S, "N": N, "fns": fns, "args": args}


def timings(c: dict, rounds: int, calls: int, device) -> dict:
    """Interleaved blocks of ``calls`` calls a variant, ``rounds`` times."""
    fns, args = c["fns"], c["args"]
    host = {v: [] for v in fns}
    call = {v: [] for v in fns}
    rmed = {v: [] for v in fns}
    for r in range(rounds):
        for v in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            fn, got = fns[v], []
            for _ in range(calls):
                with (profiling.tracing() if v == "on"
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    y = fn(*args)
                    t1 = time.perf_counter()
                sync(device)
                t2 = time.perf_counter()
                del y
                got.append(1e3 * (t1 - t0))
                call[v].append(1e3 * (t2 - t0))
            host[v] += got
            rmed[v].append(statistics.median(got))
    pair = lambda a, b: [100.0 * (x - y) / y for x, y in zip(rmed[a], rmed[b])]
    return {"cell": c["cell"], "S": c["S"], "N": c["N"], "rounds": rounds,
            "calls_a_round": calls,
            "host_ms": {v: quartiles(x) for v, x in host.items()},
            "call_ms": {v: quartiles(x) for v, x in call.items()},
            "off_vs_parent_pct": quartiles(pair("off", "parent")),
            "on_vs_off_pct": quartiles(pair("on", "off"))}


def splits(c: dict, calls: int, device) -> dict:
    """The spans of ``calls`` calls inside `tracing()`, then of four in one
    profiler session (the first left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn, args = c["fns"]["on"], c["args"]
    profiling.clear()
    with profiling.tracing():
        for _ in range(calls):
            fn(*args)
            sync(device)
    plain = span_split(profiling.spans())
    profiling.clear()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts):
        for _ in range(4):
            fn(*args)
            sync(device)
    first = next(s for s in profiling.spans() if s.parent is None)
    profiled = span_split([s for s in profiling.spans()
                           if s.call != first.id])
    return {"cell": c["cell"], "spans_ms_tracing": plain,
            "spans_ms_profiled": profiled}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cpu" and not args.small:
        print("no CUDA device: only --small runs on the CPU", file=sys.stderr)
        return 2
    parent = load_tree(args.parent.resolve(), "tinaural_torch_parent")
    lines = [{"card": card_line(), "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    cells = [setup(name, parent, args.small, device) for name in CELLS]
    # every timing before the first profiler session, which slows the
    # host-bound calls timed after it
    for c in cells:
        lines.append(timings(c, args.rounds, args.calls, device))
        print(json.dumps(lines[-1]), flush=True)
    lines.append({"registry_us_a_call": machinery()})
    print(json.dumps(lines[-1]), flush=True)
    for c in cells:
        lines.append(splits(c, args.calls, device))
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

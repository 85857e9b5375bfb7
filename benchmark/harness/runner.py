"""One run of one cell: set-up, the measured window, with ``trace`` the
profiled calls, then the check against the reference and the result line.

The order is fixed: set-up (imports, the program's library, the table, the
inputs, a warm-up of the cell's own shapes) ends where the first timed call
starts. The window runs the cell's loop for ``seconds``. With ``trace``,
the window's calls carry the benchmark's host spans, and one short
`torch.profiler` window follows them (a profiler session slows host-bound
calls timed after it). Then the peak memory is read, the program's state
freed, and the reference renders what the window's kept outputs should be.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

from . import loops, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "tinaural"}


def process_start() -> float:
    """The epoch time this process started, from /proc; else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


@dataclasses.dataclass
class Record:
    """What a run hands every metric's reader."""

    cell: spec.Cell
    shapes: dict
    window: loops.Window
    work: list            # the work of each call: audio seconds
    setup_s: float
    profile: object = None  # harness.profile.Profile of a --trace 1 run


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> dict:
    """Run the cell and return the result line's object."""
    import torch

    from . import profile, system

    timings = {"import_s": time.time() - t_start}
    if device.type == "cuda":
        from tinaural_torch.ops import _build

        t = time.perf_counter()
        _build.library()
        timings["build_s"] = time.perf_counter() - t
    E = spec.entry(cell.entry).Entry(cell, seed, device)
    E.warm_up()
    timings.update(E.timings)
    loop = cell.traffic["loop"]
    if loop != "closed":
        raise ValueError(f"unknown loop {loop!r}")
    E.start(seconds)
    before = system.launches()
    t_first = time.time()
    window = loops.closed(E.issue, E.finish, seconds)
    setup_s = t_first - t_start
    n = len(window.calls)
    made = {k: v - before.get(k, 0) for k, v in system.launches().items()}
    per_call = {k: v / n for k, v in made.items() if v}
    log("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        + f", total {setup_s:.3f} s")
    log(f"route: launches a call {json.dumps(per_call, sort_keys=True)}; "
        f"expected {json.dumps(cell.route, sort_keys=True)}: "
        + ("as expected" if per_call == cell.route else "DIFFERS"))
    log(f"window: {n} calls in {window.seconds:.3f} s")
    if n:
        q = lambda a: ", ".join(f"{k} {np.percentile(a, p):.4f}" for k, p in
                                (("p50", 50), ("p95", 95), ("p99", 99),
                                 ("max", 100)))
        lat = np.array([c.latency_s for c in window.calls]) * 1e3
        host = np.array([c.host_s for c in window.calls]) * 1e3
        log(f"call ms from due to done: {q(lat)}; host ms in the entry: "
            f"{q(host)}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    prof = None
    if trace:
        calls = int(cell.traffic["profile_calls"])
        prof, short = profile.run(E.profile_call, calls, system.launches)
        if short:
            log("profile: records short of launches " + json.dumps(short))
    E.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = E.check(n)
    log(f"check: reference {time.perf_counter() - t:.3f} s")
    limits = cell.limits
    correct = n > 0 and all(checks[k] <= limits[k] for k in limits)
    rec = Record(cell=cell, shapes=E.shapes, window=window,
                 work=[E.work(i) for i in range(n)], setup_s=setup_s,
                 profile=prof)
    metrics = {}
    for m in spec.metrics(cell.name, trace):
        value = spec.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": n, "failed": 0,
           "metrics": metrics, "device": dev}
    if prof is not None:
        dev.update(busy_s=prof.busy_s, window_s=prof.window_s)
        top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                    key=lambda kv: -kv[1])[:10]]
        out["breakdown"] = {"device_ops": top(prof.by_name),
                            "idle_gaps": top(prof.idle_by_host)}
    out["check"] = {k: {"value": checks[k], "limit": limits[k]}
                    for k in limits}
    return out


def main(args) -> int:
    t_start = process_start()
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is "
              "false); no result", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        return 2
    from . import device as card
    from .work import PEAKS

    print(f"card: {card.card_line()}; {PEAKS}", flush=True)
    out = run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), t_start,
              log=lambda s: print(s, flush=True))
    print(f"card after: {card.card_line()}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0

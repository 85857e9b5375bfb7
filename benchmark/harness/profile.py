"""One short `torch.profiler` window over a few calls, and what the per-layer
metrics read from it.

The calls sit between runs of spin kernels (``torch.cuda._sleep``), so
that device records a trace loses at its edges are the spins' and not the
calls' (seen on an H100: up to 11 records lost at one edge). The window
is the host interval from the first call's start to the last call's end,
each call marked by a ``bench.call`` range; device time is the union of
every kernel, copy and set record inside it, spins left out. Kernel names
are cut to their function (``void ns::k<…>(…)`` → ``k``). No trace file is
written: the events are read in memory.
"""

from __future__ import annotations

import dataclasses

import torch

PAD, PAD_CYCLES = 32, 100_000  # spins of ~50 µs at 1.98 GHz each side
CALL = "bench.call"


def kernel_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").split("(")[0].split("<")[0]
    return name.split("::")[-1].strip()


@dataclasses.dataclass
class Profile:
    """A traced window: ``calls`` calls over ``window_s`` seconds, the
    device busy ``busy_s`` of them, device seconds and records by name, and
    the idle seconds by the host activity they fell in."""

    calls: int
    window_s: float
    busy_s: float
    by_name: dict
    count: dict
    idle_by_host: dict

    def per_call_s(self, kernel: str) -> float | None:
        """Device seconds a call of ``<kernel>_kernel``; None if absent."""
        t = self.by_name.get(f"{kernel}_kernel")
        return None if t is None else t / self.calls


def _union(intervals):
    """Total length of a union of (start, end) intervals, and the gaps
    between them as (start, end)."""
    total, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def reduce(events, calls: int) -> Profile:
    """The Profile of a finished torch.profiler session's ``events()``."""
    cuda = torch.autograd.DeviceType.CUDA
    marks = [e for e in events if e.name == CALL and e.device_type != cuda]
    if not marks:
        raise RuntimeError("the trace holds no call ranges")
    w0 = min(e.time_range.start for e in marks)
    w1 = max(e.time_range.end for e in marks)
    dev, by, count = [], {}, {}
    host = []
    for e in events:
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False):
                continue  # a range over kernels, not work of its own
            name = kernel_name(e.name)
            if name == "spin_kernel":
                continue
            s, t = e.time_range.start, e.time_range.end
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            dev.append((s, t))
            by[name] = by.get(name, 0.0) + (t - s) / 1e6
            count[name] = count.get(name, 0) + 1
        elif e.name != CALL:
            host.append(e)
    busy, gaps = _union(dev + [(w0, w0), (w1, w1)])
    idle = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = [e for e in host
                 if e.time_range.start <= mid <= e.time_range.end]
        name = (max(inner, key=lambda e: e.time_range.start).name
                if inner else "host, outside any op")
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    return Profile(calls=calls, window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                   by_name=by, count=count, idle_by_host=idle)


def run(fn, calls: int, launches) -> tuple[Profile, dict]:
    """Profile ``calls`` calls of fn(i) (each inside a ``bench.call``
    range) between spins. ``launches()`` gives the program's launch
    counters; a trace that holds fewer records of a kernel than the calls
    launched is taken again, up to three times, and the last is kept.
    → (Profile, {kernel: (records, launches)} of the kernels short in it)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    short = {}
    for _ in range(3):
        torch.cuda.synchronize()
        before = dict(launches())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD):
                torch.cuda._sleep(PAD_CYCLES)
            for i in range(calls):
                with record_function(CALL):
                    fn(i)
            for _ in range(PAD):
                torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        made = {k: v - before.get(k, 0) for k, v in launches().items()}
        p = reduce(prof.events(), calls)
        short = {k: (p.count.get(f"{k}_kernel", 0), n)
                 for k, n in made.items()
                 if n and p.count.get(f"{k}_kernel", 0) < n}
        if not short:
            break
    return p, short

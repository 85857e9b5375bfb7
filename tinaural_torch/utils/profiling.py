"""Tracing and timing utilities: a port of `tinaural.utils.profiling`,
and the port's spans and counters.

`trace` records a `torch.profiler` session into a chrome trace (view it in
Perfetto or chrome://tracing). `fence` waits for the device work behind a
result by reading one element of it back to the host; the timers close
each timed batch with one `fence`, so they time the work and not its
enqueue. On the card a CUDA launch returns before the kernel ends, which
is why a host clock needs the fence.

The registry: the entry points and the layers under them open a `span` at
each boundary (``tt.render_trajectory`` … ``tt.blockify``, ``tt.h2d``,
``tt.dedupe``, ``tt.lookup``, ``tt.route``, inside the natural-order
route ``tt.input_spectra``, ``tt.epilogue``, and inside the partitioned
route ``tt.frames``, ``tt.partitions``, ``tt.conv``; a span's self time is
its duration less the spans it holds) and add to named counters with
`count` (``h2d_bytes``, ``h2d_pinned_bytes``, ``blockify_host_bytes``,
``host_syncs``, ``mac_rows``, ``dedupe_rows_merged``, ``partition_rows``,
``conv_chunks``, ``direct_partition_rows``); the
kernel wrappers' ``launches`` dicts are `register`-ed here and read as
``launches.<kernel>``. Counters always count. Spans record only while
tracing is on: inside a `tracing()` block, or while a `torch.profiler`
session records (so a `trace`, or any profiler window, gets them too).
Off, a span costs two flag checks. On, it
records a `Span` into a ring of the last `RING_SPANS`; inside a profiler
session it also opens a `torch.profiler.record_function` range of its
name, which the session puts on its timeline beside the kernels and
copies. The spans of one call share its root's id (``call``); a root (the
outermost span) also keeps the change of every counter during its call.
`spans` reads the ring, `clear` empties it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

_TRACE_SEQ = itertools.count()  # one file name a trace within a process


def _last_tensor(x):
    """The last tensor leaf of a tensor, or of nested tuples, lists and
    dicts of them (a NamedTuple state included)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if not isinstance(x, (tuple, list)):
        return None
    for item in reversed(x):
        leaf = _last_tensor(item)
        if leaf is not None:
            return leaf
    return None


def fence(x) -> float:
    """Wait for the work that produced ``x``; return one element of it.

    Reads the last element of the last tensor leaf back to the host. A
    device-to-host read waits for the stream that wrote the tensor, and
    the device runs a stream in order, so fencing the last output of a
    batch fences the whole batch. A complex leaf returns its real part.
    On the CPU every op has ended when it returns, and the read is free.
    """
    leaf = _last_tensor(x)
    if leaf is None:
        raise TypeError("fence needs a tensor or a container of tensors")
    if leaf.is_complex():
        leaf = leaf.real
    return float(leaf.reshape(-1)[-1])


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block into a chrome trace written into ``log_dir``.

    Records CPU activity, and CUDA activity where a card is present;
    waits for the card before the session ends, so the last kernels land
    in the trace. Yields the directory; the trace is the file
    ``trace-<pid>-<n>.json`` in it."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{next(_TRACE_SEQ)}.json"))


RING_SPANS = 4096  # spans the ring keeps: tracing left on stays bounded

_tracing = 0  # open tracing() blocks
_ring: collections.deque = collections.deque(maxlen=RING_SPANS)
_local = threading.local()  # each thread's stack of open spans
_ids = itertools.count(1)  # span ids; a root's id is its call's id
_counters: dict[str, int] = {}
_launches: list[dict] = []  # the kernel wrappers' launch counts, kept there
_lock = threading.Lock()


class Span(NamedTuple):
    """A finished span. ``call`` is the id of its root (a root's own id),
    ``parent`` the id of the span it ran in (None for a root); times are
    `time.perf_counter_ns`. ``counts``: for a root, the change of each
    counter during the call (counters that did not change left out); {}
    for a child."""

    name: str
    id: int
    call: int
    parent: int | None
    start_ns: int
    end_ns: int
    counts: dict


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Open:
    """A span being recorded. Inside a profiler session its clock reads lie
    inside its `record_function` range; without one it opens none."""

    __slots__ = ("name", "id", "call", "parent", "before", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.call, self.before = top.id, top.call, None
        else:
            self.parent, self.call, self.before = None, self.id, _snapshot()
        stack.append(self)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        counts = {} if self.before is None else _changes(self.before)
        _ring.append(Span(self.name, self.id, self.call, self.parent,
                          self.start, end, counts))


def _snapshot() -> tuple:
    return dict(_counters), [dict(c) for c in _launches]


def _changes(before: tuple) -> dict:
    """The counters that changed since `_snapshot` gave ``before``."""
    own, kept = before
    out = {k: v - own.get(k, 0) for k, v in _counters.items()
           if v != own.get(k, 0)}
    for counts, was in zip(_launches, kept):
        out.update((f"launches.{k}", v - was.get(k, 0))
                   for k, v in counts.items() if v != was.get(k, 0))
    return out


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one layer's work, recorded while tracing
    is on (see the module's docstring); off, a shared no-op."""
    if _tracing or _autograd_profiler._is_profiler_enabled:
        return _Open(name)
    return _OFF


@contextlib.contextmanager
def tracing():
    """Record spans inside the block, with or without a profiler."""
    global _tracing
    with _lock:
        _tracing += 1
    try:
        yield
    finally:
        with _lock:
            _tracing -= 1


def count(name: str, n: int = 1) -> None:
    """Add n to the counter ``name`` (always on)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def register(launches: dict) -> None:
    """Read a kernel wrapper module's ``launches`` dict (it stays theirs)
    as counters ``launches.<kernel>``."""
    _launches.append(launches)


def counters() -> dict[str, int]:
    """Every counter by name, the registered ones included."""
    out = dict(_counters)
    for counts in _launches:
        out.update((f"launches.{k}", v) for k, v in counts.items())
    return out


def spans() -> list[Span]:
    """The ring's spans, oldest first, each after the spans it holds."""
    return list(_ring)


def clear() -> None:
    """Empty the ring (the counters keep counting)."""
    _ring.clear()


def enable_debug_checks(nans: bool = True, infs: bool = True) -> None:
    """Turn on autograd's anomaly mode: a backward op that fails names the
    forward op that made its input, and with ``nans`` a backward op that
    returns a NaN raises. Debugging aid, with a large slowdown.

    Narrower than the JAX package's checks: torch has no switch for
    infinities, so ``infs`` changes nothing, and the forward pass is not
    checked or re-run (the JAX package re-runs each jitted function
    un-jitted and checks every op)."""
    del infs  # kept for the JAX package's signature; torch has no switch
    torch.autograd.set_detect_anomaly(True, check_nan=nans)


def marginal_cost(call, k1: int = 2, k2: int = 12, reps: int = 5) -> float:
    """Marginal seconds a call of ``call()`` adds to a batch of calls.

    Times a batch of k1 calls and a batch of k2 calls, each closed by one
    `fence`, and takes (t2 − t1)/(k2 − k1), so that the fence's round trip
    and the last call's tail cancel. The median of the positive paired
    estimates; where fewer than two are positive (host jitter drowned
    them), the upper bound min(t2)/k2, which includes one fence and never
    flatters. On the card, calls that the host issues faster than the
    card runs them queue, and the estimate is the card's time a call;
    host-bound calls give the host's.

    ``call`` must return a tensor (or a container of them) that depends
    on the whole of its work. The single-leg case of `marginal_cost_ab`.
    """
    return marginal_cost_ab({"_": call}, k1=k1, k2=k2, reps=reps)["_"]


def marginal_cost_ab(calls: dict, k1: int = 2, k2: int = 12,
                     reps: int = 5) -> dict:
    """`marginal_cost` of several calls, interleaved: each rep times every
    call's (k1, k2) pair before the next rep starts, so that slow drift in
    the process (clocks, allocator) reaches every call alike. Returns
    {name: marginal seconds}, with `marginal_cost`'s estimator."""

    def batch(call, k):
        t0 = time.perf_counter()
        y = None
        for _ in range(k):
            y = call()
        fence(y)
        return time.perf_counter() - t0

    for c in calls.values():  # warm up and settle, each call
        batch(c, 1), batch(c, 1), batch(c, k1), batch(c, k2)
    ests = {n: [] for n in calls}
    t2s = {n: [] for n in calls}
    for _ in range(reps):
        for n, c in calls.items():
            t1 = batch(c, k1)
            t2 = batch(c, k2)
            ests[n].append((t2 - t1) / (k2 - k1))
            t2s[n].append(t2)
    out = {}
    for n in calls:
        pos = [e for e in ests[n] if e > 0]
        out[n] = (float(np.median(pos)) if len(pos) >= 2
                  else float(min(t2s[n])) / k2)
    return out

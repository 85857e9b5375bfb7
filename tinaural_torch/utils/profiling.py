"""Tracing and timing utilities: a port of `tinaural.utils.profiling`.

`trace` records a `torch.profiler` session into a chrome trace (view it in
Perfetto or chrome://tracing). `fence` waits for the device work behind a
result by reading one element of it back to the host; the timers close
each timed batch with one `fence`, so they time the work and not its
enqueue. On the card a CUDA launch returns before the kernel ends, which
is why a host clock needs the fence.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import numpy as np
import torch

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


def timeit(fn, iters: int = 5, warmup: int = 1) -> float:
    """Best-of wall seconds for fn() (fn must fence its own work)."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


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

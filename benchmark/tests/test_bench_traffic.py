"""The general generator is a function of the seed alone, every seed does
the same work, and the rate and host-span arithmetic move when a stall is
put into a window."""

import time

import numpy as np
import pytest

from benchmark.harness import inputs, loops, spec
from benchmark.harness.runner import Record

SEED = 2**31 + 11
SWEEP = spec.load_json(spec.BENCH / "traffic" / "trajectory.json")["path"]


def test_signals_deterministic():
    a = inputs.signals(SEED, 2, (3, 1000), 0.1)
    assert np.array_equal(a, inputs.signals(SEED, 2, (3, 1000), 0.1))
    assert not np.array_equal(a, inputs.signals(SEED + 1, 2, (3, 1000), 0.1))
    assert not np.array_equal(a, inputs.signals(SEED, 3, (3, 1000), 0.1))
    assert a.dtype == np.float32 and abs(a.std() - 0.1) < 0.01


def test_paths_deterministic_and_in_range():
    a = inputs.sweeps(SEED, 0, 5, 300, SWEEP)
    assert np.array_equal(a, inputs.sweeps(SEED, 0, 5, 300, SWEEP))
    assert not np.array_equal(a, inputs.sweeps(SEED + 1, 0, 5, 300, SWEEP))
    assert a.shape == (5, 300, 2) and a.dtype == np.float32
    assert (a[..., 0] >= 0).all() and (a[..., 0] < 360).all()
    lo, hi = SWEEP["el_range"]
    assert (a[..., 1] >= lo - 1e-3).all() and (a[..., 1] <= hi + 1e-3).all()


@pytest.mark.parametrize("name", ["trajectory", "scene64"])
def test_every_seed_same_work(name):
    """The sizes come from the mix: two seeds give arrays of one shape."""
    t = spec.load_json(spec.BENCH / "traffic" / f"{name}.json")
    nb = -(-t["samples"] // 1024)
    a = inputs.sweeps(1, 0, t["sources"], nb, t["path"])
    b = inputs.sweeps(2, 0, t["sources"], nb, t["path"])
    assert a.shape == b.shape


def _record(window, loop, work=1.0):
    cell = spec.Cell("x", 1, "c", {}, {"loop": loop}, {}, {})
    return Record(cell=cell, shapes={}, window=window,
                  work=[work] * len(window.calls), setup_s=1.0)


def _stalled(i, stall_at, stall_s):
    if i == stall_at:
        time.sleep(stall_s)


def test_closed_loop_rate_moves_with_a_stall():
    rate = spec.reader("audio_s_per_s")
    quick = loops.closed(lambda i: time.sleep(0.002), lambda i, h: None, 0.1)
    slow = loops.closed(lambda i: (time.sleep(0.002), _stalled(i, 3, 0.05)),
                        lambda i, h: None, 0.1)
    r_quick = rate.read(_record(quick, "closed"))
    r_slow = rate.read(_record(slow, "closed"))
    assert r_quick == pytest.approx(len(quick.calls) / quick.seconds)
    assert r_slow < 0.85 * r_quick


def test_host_span_moves_with_a_stall():
    """A stall inside the entry call lifts host_ms.render by its share of
    the calls; a stall in the wait after it does not."""
    host = spec.reader("host_ms.render")
    calm = loops.closed(lambda i: None, lambda i, h: None, 0.05)
    in_call = loops.closed(lambda i: _stalled(i, 0, 0.03),
                           lambda i, h: None, 0.05)
    in_wait = loops.closed(lambda i: None,
                           lambda i, h: _stalled(i, 0, 0.03), 0.05)
    n = len(in_call.calls)
    assert host.read(_record(in_call, "closed")) >= 30.0 / n
    assert host.read(_record(in_wait, "closed")) < 1.0
    assert host.read(_record(calm, "closed")) < 1.0

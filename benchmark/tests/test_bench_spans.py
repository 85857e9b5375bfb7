"""The readers of the program's spans and counters (`harness/spans.py`) on
a cell cut to a CPU size: its profiled calls run under a CPU profiler
session, as a ``--trace 1`` run's do on the card, and each reader gives a
finite value of the right sign from a record whose profile holds those
calls, and nothing once the program's ring is empty."""

import math

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import loops, spec
from benchmark.harness.profile import Profile
from benchmark.harness.runner import Record
from benchmark.tests.bench_tiny import CPU, TINY, tiny
from tinaural_torch.utils import profiling

SEED = 2**31 + 33
BENCH = spec.benchmark()
READERS = [m for m in BENCH["per_layer"]
           if m["source"] in ("program_span", "program_counter")]
PAIRS = [(cell, m["name"]) for m in READERS for cell in m["workloads"]
         if cell in TINY]
NONNEGATIVE = {"host_syncs.render"}  # 0 off the card


@pytest.fixture(scope="module")
def entries():
    made = {}

    def get(name):
        if name not in made:
            cell = tiny(name)
            e = spec.entry(cell.entry).Entry(cell, SEED, CPU)
            e.warm_up()
            made[name] = (cell, e)
        return made[name]

    return get


def _profiled(cell, entry) -> Record:
    """The cell's profiled calls under a CPU profiler session, and a record
    whose profile counts them."""
    calls = int(cell.traffic["profile_calls"])
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(calls):
            entry.profile_call(i)
    prof = Profile(calls=calls, window_s=1.0, busy_s=0.0, by_name={},
                   count={}, idle_by_host={})
    return Record(cell=cell, shapes=entry.shapes,
                  window=loops.Window([], 0.0, 1.0), work=[], setup_s=0.0,
                  profile=prof)


def test_every_span_reader_is_tested():
    assert {m["name"] for m in READERS} == {n for _, n in PAIRS}
    assert len(READERS) == 6


@pytest.mark.parametrize("cell,metric", PAIRS)
def test_span_reader_reads_the_profiled_calls(entries, cell, metric):
    c, e = entries(cell)
    rec = _profiled(c, e)
    value = spec.reader(metric).read(rec)
    assert value is not None and math.isfinite(value), (metric, value)
    assert value >= 0 if metric in NONNEGATIVE else value > 0, value
    profiling.clear()
    assert spec.reader(metric).read(rec) is None


@pytest.mark.parametrize("cell", sorted(TINY))
def test_span_readers_read_nothing_without_a_profile(entries, cell):
    c, e = entries(cell)
    rec = _profiled(c, e)
    rec.profile = None
    for m in READERS:
        assert spec.reader(m["name"]).read(rec) is None, m["name"]


def test_dedupe_reads_nothing_on_a_trajectory(entries):
    c, e = entries("kemar128.trajectory")
    rec = _profiled(c, e)
    assert spec.reader("host_ms.blockify").read(rec) > 0
    assert spec.reader("host_ms.dedupe").read(rec) is None


def test_span_readers_read_nothing_from_a_program_without_spans(
        entries, monkeypatch):
    """A checkout whose program has no span registry (the benchmark's files
    laid over an older program) reports none of these metrics."""
    c, e = entries("kemar128.scene")
    rec = _profiled(c, e)
    monkeypatch.delattr(profiling, "spans")
    for m in READERS:
        assert spec.reader(m["name"]).read(rec) is None, m["name"]

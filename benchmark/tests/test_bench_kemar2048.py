"""The kemar2048 configuration and its cell kemar2048.batch: the files load
by name, `harness/work_natural.py` counts by hand at a tiny shape, the
entry's reference is `fast.render` of each source alone, and the cell,
cut to a CPU size, runs as the others do in `test_bench_faults.py` and
`test_bench_spans.py`: sound, it comes out correct; with the control, or
the program broken underneath, it does not; its counter reader reads the
profiled calls, and nothing where the program counts no rows."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import spec, system, work, work_natural
from benchmark.harness.compare import NUMBERS
from benchmark.harness.profile import Profile
from benchmark.harness.runner import Record, run
from benchmark.reference import fast
from benchmark.tests import bench_tiny
from benchmark.tests.test_bench_faults import _altered
from benchmark.tests.test_bench_spans import _profiled
from benchmark.tools.readings import control
from tinaural_torch.models import renderer
from tinaural_torch.utils import profiling

CELL = "kemar2048.batch"
CPU = torch.device("cpu")
SEED = 2**31 + 41
BENCH = spec.benchmark()


def tiny() -> spec.Cell:
    """The cell at 3 sources of 8 blocks: the same table, route and
    checks."""
    c = spec.cell(CELL)
    return dataclasses.replace(
        c, traffic={**c.traffic, "samples": 1 << 13, "sources": 3})


def tiny_run(seed=SEED) -> dict:
    return run(tiny(), seed, 0.3, False, CPU, 0.0, log=lambda line: None)


def test_files_load_by_name():
    c = spec.cell(CELL, BENCH)
    conf = next(x for x in BENCH["configs"] if x["name"] == "kemar2048")
    w = next(x for x in BENCH["workloads"] if x["name"] == CELL)
    base = spec.load_json(spec.BENCH / "configs" / "kemar128.json")
    assert c.entry == "render_batch" and c.chips == 1
    assert hasattr(spec.entry(c.entry), "Entry")
    assert c.route == {"assembly_mac": 1, "spectra_inverse": 1,
                       "overlap_add": 1}
    assert set(c.limits) == set(NUMBERS)
    assert set(c.config) == set(base)
    assert c.config["taps"] == 2048 and c.config["sample_rate"] == 44100
    assert c.config["grid"] == {"elevs": [0.0], "az_counts": [360]}
    assert c.config["render"] == base["render"]
    assert c.config["hrir"] == base["hrir"]
    assert c.config["source"] == conf["source"] and len(conf["source"]) <= 200
    assert conf["reduced"] == [] and len(c.config["assumed"]) == 3
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert c.traffic["sources"] * c.traffic["samples"] == 64 * 131072
    assert c.traffic["path"]["el_range"] == [0.0, 0.0]
    for name in ("assembly_mac_roofline", "spectra_inverse_roofline",
                 "mac_rows.render"):
        m = next(x for x in BENCH["per_layer"] if x["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "audio_s_per_s"
        assert callable(spec.reader(name).read)


@pytest.mark.parametrize("crossfade, dir_rate", [(True, 1), (False, 1),
                                                 (True, 2)])
def test_work_natural_by_hand(crossfade, dir_rate):
    """2 sources × 3 blocks of 4 at n_fft 8 (F 5), 2 taps (L 128: a
    filter 10064 operations, `test_bench_work.py`), 5 table rows used."""
    rows = 2 * -(-3 // dir_rate)
    s = dict(S=2, nb=3, B=4, n_fft=8, rows=rows, taps=2, table_rows=5,
             crossfade=crossfade)
    x_reads = 2 if crossfade else 1
    nbytes, flops = work_natural.assembly_mac(s)
    assert nbytes == rows * 32 + 5 * 32 + 6 * 5 * 8 * x_reads + 6 * 2 * 5 * 8
    mac = 14 if crossfade else 6
    assert flops == rows * (10064 + 2 * 60) + 6 * 2 * 5 * mac
    nbytes, flops = work_natural.spectra_inverse(s)
    assert nbytes == 6 * 2 * 5 * 8 + 6 * 2 * 8 * 4
    assert flops == 6 * 2 * 60


def test_work_natural_at_the_cell_shapes():
    """Both stages are bound by their bytes at 8192 rows × n_fft 4096:
    0.162 ms and 0.160 ms (PERF.md §6 rows 9 and 2 give chip_smoke's
    counts, 0.1639 and 0.1603)."""
    s = dict(S=64, nb=128, B=1024, n_fft=4096, rows=8192, taps=2048,
             table_rows=360, crossfade=True)
    for stage, want in ((work_natural.assembly_mac, 0.1622e-3),
                        (work_natural.spectra_inverse, 0.1603e-3)):
        nbytes, flops = stage(s)
        assert nbytes / work.HBM_BYTES_PER_S > flops / work.FP32_FLOPS_PER_S
        assert work.least_seconds(nbytes, flops) == pytest.approx(want,
                                                                  rel=1e-3)


def test_reference_is_each_source_alone():
    cell = tiny()
    E = spec.entry(cell.entry).Entry(cell, SEED, CPU)
    E.free_program()
    E.kept = {0: None}
    (k, ref), = E.reference_outputs()
    xs, dirs = E.inputs[0]
    S, N = xs.shape
    assert k == 0 and ref.shape == (S, 2, N + 2048 + 63)
    tab = fast.device_table(system.reference_table(cell.config, E.h), CPU)
    rcfg = fast.Config(block_size=1024)
    for s in range(S):
        assert torch.equal(ref[s], fast.render(tab, xs[s:s + 1],
                                               dirs[s:s + 1], rcfg))
    mixed = fast.render(tab, xs, dirs, rcfg)
    assert (ref.sum(0) - mixed).abs().max() <= 1e-12 * mixed.abs().max()


def test_sound_run_is_correct():
    out = tiny_run()
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"]
                                   for m in spec.metrics(CELL, False)}


def test_control_fails_the_limit():
    got = control(tiny(), SEED + 1, CPU)
    limits = spec.cell(CELL).limits
    assert any(got[k] > 3 * limits[k] for k in limits), got


def _sources_swapped(core):
    """Each source's output handed to its neighbour."""
    def broken(*a, **k):
        return core(*a, **k).roll(1, dims=0)
    return broken


def _mixed_down(core):
    """Every output the mixdown of all sources, over S."""
    def broken(*a, **k):
        y = core(*a, **k)
        return y.mean(0, keepdim=True).expand_as(y)
    return broken


@pytest.mark.parametrize("fault", [_altered, _sources_swapped,
                                   _mixed_down], ids=lambda f: f.__name__)
def test_fault_is_caught(monkeypatch, fault):
    monkeypatch.setattr(renderer, "_batch_core",
                        fault(renderer._batch_core))
    out = tiny_run()
    assert not out["correct"], out["check"]


def test_mac_rows_reader():
    cell = tiny()
    E = spec.entry(cell.entry).Entry(cell, SEED, CPU)
    E.warm_up()
    rec = _profiled(cell, E)
    read = spec.reader("mac_rows.render").read
    assert read(rec) == E.shapes["S"] * E.shapes["nb"] == 24
    rec.profile = None
    assert read(rec) is None
    rec = _profiled(cell, E)
    profiling.clear()
    assert read(rec) is None


def test_mac_rows_reads_nothing_without_the_counter():
    """A route that runs no natural-order kernel (kemar128's B1) counts
    no rows: nothing, as from a program without the counter."""
    cell = bench_tiny.tiny("kemar128.trajectory")
    E = spec.entry(cell.entry).Entry(cell, SEED, CPU)
    E.warm_up()
    rec = _profiled(cell, E)
    assert spec.reader("host_ms.lookup").read(rec) > 0
    assert spec.reader("mac_rows.render").read(rec) is None
    profiling.clear()


@pytest.mark.parametrize("metric, kernel, stage", [
    ("assembly_mac_roofline", "assembly_mac", work_natural.assembly_mac),
    ("spectra_inverse_roofline", "spectra_inverse",
     work_natural.spectra_inverse)])
def test_roofline_readers(metric, kernel, stage):
    shapes = dict(S=64, nb=128, B=1024, n_fft=4096, rows=8192, taps=2048,
                  table_rows=360, crossfade=True)
    least = work.least_seconds(*stage(shapes))
    prof = Profile(calls=4, window_s=1.0, busy_s=0.5,
                   by_name={f"{kernel}_kernel": 4 * 4 * least}, count={},
                   idle_by_host={})
    rec = Record(cell=None, shapes=shapes, window=None, work=[],
                 setup_s=0.0, profile=prof)
    read = spec.reader(metric).read
    assert read(rec) == pytest.approx(25.0)
    rec.profile = dataclasses.replace(prof, by_name={})
    assert read(rec) is None
    rec.profile = None
    assert read(rec) is None


@pytest.mark.gpu
def test_traced_run_on_the_card():
    """On a card: the tiny cell with --trace 1 takes B9 and reads its
    three metrics, each share at most 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run(tiny(), 5, 0.5, True, torch.device("cuda", 0), 0.0,
              log=lambda line: None)
    assert out["correct"], out["check"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["mac_rows.render"] == 24
    for k in ("assembly_mac_roofline", "spectra_inverse_roofline"):
        assert 0 < m[k] <= 100, m
    assert np.isfinite(list(m.values())).all()

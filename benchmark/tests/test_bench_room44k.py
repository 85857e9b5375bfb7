"""The room44k configuration and its cell room44k.streamed: the files load
by name, `harness/work_partitioned.py` counts by hand at a tiny shape and
at the cell's, the entry's reference is the streamed map over a raw room
table, and the cell, cut to a CPU size (4096 taps, 32 blocks of 512),
runs as the others do in `test_bench_faults.py` and `test_bench_spans.py`:
sound, it comes out correct; with the control, or the program broken
underneath, it does not; its span and counter readers read the profiled
calls, and nothing without a profile, or where the program records no
partitioned route."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import spec, system, work, work_partitioned
from benchmark.harness.compare import NUMBERS
from benchmark.harness.profile import Profile
from benchmark.harness.runner import Record, run
from benchmark.reference import fast, room, streamed
from benchmark.tests import bench_tiny
from benchmark.tests.test_bench_faults import _altered
from benchmark.tests.test_bench_spans import _profiled
from benchmark.tools.readings import control
from tinaural_torch.models import renderer
from tinaural_torch.utils import profiling

CELL = "room44k.streamed"
CPU = torch.device("cpu")
SEED = 2**40 + 44
BENCH = spec.benchmark()
METRICS = ("assemble_partitions_roofline", "partitioned_conv_roofline",
           "frame_spectra_roofline", "partition_rows.render",
           "host_ms.partitioned")
CELL_SHAPES = work_partitioned.shapes(44100, 512, 4096, 1, True, 360.0)


def tiny() -> spec.Cell:
    """The cell at 4096 taps and 32 blocks of 512 (P 9): the same ring,
    room, route and checks."""
    c = spec.cell(CELL)
    return dataclasses.replace(c, traffic={**c.traffic, "samples": 1 << 14},
                               config={**c.config, "taps": 4096})


def tiny_run(seed=SEED) -> dict:
    return run(tiny(), seed, 0.3, False, CPU, 0.0, log=lambda line: None)


@pytest.fixture(scope="module")
def entry():
    cell = tiny()
    e = spec.entry(cell.entry).Entry(cell, SEED, CPU)
    e.warm_up()
    return cell, e


def test_files_load_by_name():
    c = spec.cell(CELL, BENCH)
    conf = next(x for x in BENCH["configs"] if x["name"] == "room44k")
    w = next(x for x in BENCH["workloads"] if x["name"] == CELL)
    base = spec.load_json(spec.BENCH / "configs" / "kemar2048.json")
    assert c.entry == "render_streamed" and c.chips == 1
    assert hasattr(spec.entry(c.entry), "Entry")
    assert c.route == {"frame_spectra": 1, "assemble_partitions": 11,
                       "partitioned_conv": 11}
    assert set(c.limits) == set(NUMBERS)
    assert set(c.config) == set(base)
    assert c.config["taps"] == 44100 and c.config["sample_rate"] == 44100
    assert c.config["grid"] == {"elevs": [0.0], "az_counts": [360]}
    r = c.config["render"]
    assert r["block_size"] == r["stream_block"] == 512
    assert r["dir_rate"] == 1 and r["crossfade"] and r["interp"] == "bilinear"
    assert c.config["hrir"]["room"] == {"rt60_s": 1.0, "drr_db": 0.0,
                                        "predelay_ms": 5.0}
    assert c.config["source"] == conf["source"] and len(conf["source"]) <= 200
    assert conf["reduced"] == [] and c.config["assumed"]
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert c.traffic["sources"] == 1 and c.traffic["samples"] == 1 << 21
    assert c.traffic["path"]["turns"] == [0.5, 2.0]
    for name in METRICS:
        m = next(x for x in BENCH["per_layer"] if x["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "audio_s_per_s"
        assert callable(spec.reader(name).read)


@pytest.mark.parametrize("crossfade, dir_rate", [(True, 1), (False, 1),
                                                 (True, 2)])
def test_work_partitioned_by_hand(crossfade, dir_rate):
    """3 blocks of 4 (F2 5), 2 taps: T 66, P 17, L 128; 5 table rows used;
    a filter's gather and lerp 16·2 + 32 = 64 operations, a partition's
    transform at 8 points of 4 samples 2.5·8·log2 8 = 60."""
    s = work_partitioned.shapes(2, 4, 3, dir_rate, crossfade, 5)
    R = -(-3 // dir_rate)
    assert (s["P"], s["L"], s["F2"], s["rows"]) == (17, 128, 5, R)
    planes = R * 17 * 2 * 5 * 8
    nbytes, flops = work_partitioned.assemble_partitions(s)
    assert nbytes == R * 32 + 5 * 32 + planes
    assert flops == R * (64 + 2 * 17 * 60)
    nbytes, flops = work_partitioned.frame_spectra(s)
    assert (nbytes, flops) == (3 * 4 * 4 + 3 * 5 * 8, 3 * 60)
    nbytes, flops = work_partitioned.partitioned_conv(s)
    assert nbytes == planes + 3 * 5 * 8 + 2 * 3 * 4 * 4
    twice = 2 if crossfade else 1
    assert flops == 3 * twice * 2 * (17 * 5 * 8 + 60) \
        + (3 * 2 * 4 * 3 if crossfade else 0)


def test_work_partitioned_at_the_cell_shapes():
    """4096 filters of 87 partitions (2.93 GB of planes): the assembly and
    the convolution are bound by their bytes, 0.911 and 0.883 ms; the
    frames by theirs, 7.5 µs."""
    s = CELL_SHAPES
    assert (s["P"], s["L"], s["F2"], s["rows"]) == (87, 65536, 513, 4096)
    for stage, want in ((work_partitioned.assemble_partitions, 0.9111e-3),
                        (work_partitioned.partitioned_conv, 0.8831e-3),
                        (work_partitioned.frame_spectra, 7.522e-6)):
        nbytes, flops = stage(s)
        assert nbytes / work.HBM_BYTES_PER_S > flops / work.FP32_FLOPS_PER_S
        assert work.least_seconds(nbytes, flops) == pytest.approx(want,
                                                                  rel=1e-3)


def test_program_chunks_at_the_cell_shapes():
    """The program cuts a call's 4096 filters into 11 chunks of at most
    375 rows (2^28 bytes of planes), as the cell's route expects."""
    mod = spec.entry("render_streamed")
    assert mod.chunks(CELL_SHAPES, 1) == 11


def test_entry_table_is_the_raw_room(entry):
    """The program's table holds the room responses whole, and the
    reference's is `room.raw_table` of the same array."""
    cell, e = entry
    tab = e.renderer.table
    assert not tab.decomposed and tab.taps == 4096
    assert torch.equal(tab.h.cpu(),
                       torch.from_numpy(e.h.astype(np.float32)))
    again = spec.entry(cell.entry).room_hrirs(cell.config, SEED)
    assert np.array_equal(again, e.h)
    assert e.shapes["P"] == 9 and e.shapes["rows"] == 32
    assert e.shapes["chunks"] == 1 and e.shapes["nb"] == 32


def test_reference_is_the_streamed_map(entry):
    cell, e = entry
    e.kept = {1: None}
    (k, ref), = e.reference_outputs()
    xs, dirs = e.inputs[1]
    tab = fast.device_table(room.raw_table(e.h, system.grid(cell.config),
                                           44100), CPU)
    assert k == 1 and ref.shape == (2, 1 << 14)
    assert torch.equal(ref, streamed.render(tab, xs[0], dirs[0],
                                            system.reference_config(
                                                cell.config)))


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


def _late(core):
    """Every output block one block late."""
    def broken(table, xb, dirs, config, render=None):
        return core(table, xb, dirs, config, render).roll(xb.shape[1], -1)
    return broken


def _no_crossfade(core):
    """Each block under its own filter alone."""
    def broken(table, xb, dirs, config, render=None):
        return core(table, xb, dirs,
                    dataclasses.replace(config, crossfade=False), render)
    return broken


def _mirrored(core):
    """The head turned the other way: each azimuth negated."""
    def broken(table, xb, dirs, config, render=None):
        return core(table, xb, dirs * torch.tensor([-1.0, 1.0]).to(dirs),
                    config, render)
    return broken


@pytest.mark.parametrize("fault", [_altered, _late, _no_crossfade,
                                   _mirrored], ids=lambda f: f.__name__)
def test_fault_is_caught(monkeypatch, fault):
    monkeypatch.setattr(renderer, "_partitioned_core",
                        fault(renderer._partitioned_core))
    out = tiny_run()
    assert not out["correct"], out["check"]


def test_span_and_counter_readers(entry):
    """On the CPU's plain route: ``partition_rows`` is rows·P (32 × 9) a
    call, the three spans' host time positive; nothing without a profile,
    or once the program's ring is empty."""
    cell, e = entry
    rec = _profiled(cell, e)
    rows = spec.reader("partition_rows.render").read
    host = spec.reader("host_ms.partitioned").read
    assert rows(rec) == 32 * 9
    assert host(rec) > 0
    profiling.clear()
    assert rows(rec) is None and host(rec) is None
    rec = _profiled(cell, e)
    rec.profile = None
    assert rows(rec) is None and host(rec) is None
    profiling.clear()


def test_readers_read_nothing_on_another_route():
    """A render that takes no partitioned route (kemar128's B1) counts no
    partitions and records none of the three spans: nothing, as from a
    program without them."""
    cell = bench_tiny.tiny("kemar128.trajectory")
    E = spec.entry(cell.entry).Entry(cell, SEED, CPU)
    E.warm_up()
    rec = _profiled(cell, E)
    assert spec.reader("host_ms.lookup").read(rec) > 0
    for name in ("partition_rows.render", "host_ms.partitioned"):
        assert spec.reader(name).read(rec) is None, name
    profiling.clear()


@pytest.mark.parametrize("metric, kernel, stage", [
    ("assemble_partitions_roofline", "assemble_partitions",
     work_partitioned.assemble_partitions),
    ("partitioned_conv_roofline", "partitioned_conv",
     work_partitioned.partitioned_conv),
    ("frame_spectra_roofline", "frame_spectra",
     work_partitioned.frame_spectra)])
def test_roofline_readers(metric, kernel, stage):
    least = work.least_seconds(*stage(CELL_SHAPES))
    prof = Profile(calls=4, window_s=1.0, busy_s=0.5,
                   by_name={f"{kernel}_kernel": 4 * 4 * least}, count={},
                   idle_by_host={})
    rec = Record(cell=None, shapes=CELL_SHAPES, window=None, work=[],
                 setup_s=0.0, profile=prof)
    read = spec.reader(metric).read
    assert read(rec) == pytest.approx(25.0)
    rec.profile = dataclasses.replace(prof, by_name={})
    assert read(rec) is None
    rec.profile = None
    assert read(rec) is None


@pytest.mark.gpu
def test_traced_run_on_the_card():
    """On a card: the tiny cell with --trace 1 takes the partitioned route
    (one chunk) and reads its five metrics, each share at most 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run(tiny(), 5, 0.5, True, torch.device("cuda", 0), 0.0,
              log=lambda line: None)
    assert out["correct"], out["check"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == set(METRICS)
    assert m["partition_rows.render"] == 32 * 9 and m["host_ms.partitioned"] > 0
    for k in METRICS[:3]:
        assert 0 < m[k] <= 100, m

"""The QU_KEMAR 2048-tap horizontal-plane configuration
(`benchmark/configs/kemar2048.json`: one ring of 360 azimuths, 2048 taps)
through `render_batch`'s natural-order route on the CPU, at a small size.

Seeded random HRIRs (a fractional onset per azimuth and ear, then decaying
noise; not the head model) are decomposed by the port and by the
benchmark's float64 reference (`benchmark/reference/`); blocks of 256 make
n_fft 4096, so `render_batch` takes `assembly_mac_render`. Each source's
output is held to `fast.render` of that source alone, the map
`render_batch` promises; the single ring's lookup (wrap, clamp, slot
positions) to the reference's float64 weights; and the route's spans and
its ``mac_rows`` counter are checked under `tracing()`."""

import numpy as np
import pytest
import torch

import tinaural_torch as tt
from benchmark.reference import fast
from benchmark.reference import grids as rgrids
from benchmark.reference import table as rtable
from tinaural_torch.data.grids import SphericalGrid
from tinaural_torch.data.table import TorchTable, build_table
from tinaural_torch.models import renderer as rd
from tinaural_torch.ops.interp import direction_weights
from tinaural_torch.utils import profiling

torch.set_num_threads(1)

TAPS, RING, B, S, NB = 2048, 360, 256, 3, 6
SEED = 2**31 + 24
# The port in float32 against the float64 reference: FFTs of 4096 points
# over 2048-tap filters leave ≤ 1e-5 of the peak (9.0e-6 at the worst of
# the seeds tried); 1e-4 keeps 10× room, and the bfloat16 control reads
# 0.08–0.23, three orders above it.
TOL = 1e-4


@pytest.fixture(scope="module")
def tables():
    """(the port's TorchTable, the reference's float64 Table) of one set of
    random HRIRs on a ring of 360 azimuths."""
    rng = np.random.default_rng(SEED)
    n = np.arange(TAPS)
    onset = rng.uniform(10.0, 40.0, (1, RING, 2, 1))
    h = (0.03 * rng.standard_normal((1, RING, 2, TAPS))
         * np.exp(-np.maximum(n - onset, 0.0) / 150.0) * (n >= onset)
         + np.sinc(n - onset) * np.exp(-np.abs(n - onset) / 20.0))
    elevs, counts = np.array([0.0]), np.array([RING])
    port = TorchTable.from_hrir_table(
        build_table(h, SphericalGrid(elevs, counts), 44100, decompose=True),
        "cpu")
    ref = rtable.build(h, rgrids.SphericalGrid(elevs, counts), 44100)
    return port, ref


def _inputs(seed=SEED + 1):
    """S sources of NB blocks, each sweeping its own arc of azimuth with
    elevations off the ring (clamped to it)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, NB * B)).astype(np.float32)
    dirs = np.stack([np.stack([
        np.remainder(rng.uniform(0, 360)
                     + np.linspace(0, rng.uniform(-200, 200), NB), 360.0),
        rng.uniform(-5.0, 5.0, NB)], -1) for _ in range(S)])
    return x, dirs.astype(np.float32)


def _per_source(ref, x, dirs, crossfade, prec=fast.FLOAT64):
    """The reference's renders of each source alone → (S, 2, out_len)."""
    dt = fast.device_table(ref, "cpu", prec)
    cfg = fast.Config(block_size=B, crossfade=crossfade)
    return torch.stack([fast.render(dt, x[s:s + 1], dirs[s:s + 1], cfg)
                        for s in range(x.shape[0])])


def _err(y, ref):
    """Each source's worst sample error over its reference's peak."""
    e = (y.double() - ref.double()).abs().amax(dim=(1, 2))
    return (e / ref.abs().amax(dim=(1, 2))).tolist()


@pytest.mark.parametrize("crossfade", [True, False])
def test_render_batch_matches_the_reference_per_source(tables, crossfade):
    port, ref = tables
    x, dirs = _inputs()
    r = tt.BinauralRenderer(port, tt.RenderConfig(block_size=B,
                                                  crossfade=crossfade))
    y = r.render_batch(x, dirs)
    want = _per_source(ref, x, dirs, crossfade)
    assert y.shape == want.shape == (S, 2, NB * B + TAPS + 63)
    assert max(_err(y, want)) <= TOL, _err(y, want)


@pytest.mark.parametrize("crossfade", [True, False])
def test_bfloat16_control_fails_the_tolerance(tables, crossfade):
    """The reference computed in the next precision below float32 (every
    stored stage rounded to bfloat16) is far outside TOL."""
    _, ref = tables
    x, dirs = _inputs()
    want = _per_source(ref, x, dirs, crossfade)
    ctl = _per_source(ref, x, dirs, crossfade, fast.BFLOAT16)
    assert min(_err(ctl, want)) > 100 * TOL, _err(ctl, want)


def test_render_batch_takes_the_natural_order_route(tables, monkeypatch):
    port, _ = tables
    assert rd._n_fft(port, B) == 4096
    assert rd.route("batch", S, NB, 4096, 132) is rd.assembly_mac_render
    calls = []

    def spy(xbs, *a, **k):
        calls.append(tuple(xbs.shape))
        return real(xbs, *a, **k)

    real = rd.assembly_mac_render
    monkeypatch.setattr(rd, "assembly_mac_render", spy)
    x, dirs = _inputs()
    tt.BinauralRenderer(port, tt.RenderConfig(block_size=B)).render_batch(
        x, dirs)
    assert calls == [(S, NB, B)]


def test_single_ring_lookup_wraps_and_clamps(tables):
    """On one ring: 359.5° lies halfway between the last slot and slot 0,
    whatever turn it is given in; an elevation off the ring is clamped to
    it; the rows and weights are the reference's."""
    port, ref = tables
    az = torch.tensor([359.5, -0.5, 719.5, 359.5, 359.5, 0.0, 180.25])
    el = torch.tensor([0.0, 0.0, 0.0, 25.0, -30.0, 90.0, -90.0])
    e, a, w = direction_weights(port.elevs, port.az_counts, az, el,
                                "bilinear")
    assert (e == 0).all()
    assert a[:5].tolist() == [[359, 0, 359, 0]] * 5
    assert w[:5].tolist() == [[0.5, 0.5, 0.0, 0.0]] * 5
    assert a[5].tolist() == [0, 1, 0, 1] and w[5, 0] == 1.0
    assert a[6].tolist() == [180, 181, 180, 181] and w[6, 1] == 0.25
    rows, wr = fast.weights(fast.device_table(ref, "cpu"),
                            torch.stack([az, el], -1))
    assert torch.equal(rows, (e * port.a_max + a).long())
    assert torch.equal(wr.float(), w)


def test_single_ring_weights_are_the_float64_positions(tables):
    """The slot position az·360/360 in float32 rounds the product to 1/128
    (1.1e-5 of a slot); the port's weights are the float64 ones rounded
    once to float32."""
    port, ref = tables
    rng = np.random.default_rng(SEED + 2)
    az = torch.from_numpy(rng.uniform(-400, 800, 2000).astype(np.float32))
    el = torch.from_numpy(rng.uniform(-90, 90, 2000).astype(np.float32))
    _, _, w = direction_weights(port.elevs, port.az_counts, az, el,
                                "bilinear")
    _, wr = fast.weights(fast.device_table(ref, "cpu"),
                         torch.stack([az, el], -1))
    assert (w.double() - wr).abs().max() <= 6e-8


def test_render_batch_clamps_elevation_to_the_ring(tables):
    port, _ = tables
    x, dirs = _inputs()
    r = tt.BinauralRenderer(port, tt.RenderConfig(block_size=B))
    off = dirs.copy()
    off[..., 1] = np.array([40.0, -60.0, 0.0], np.float32)[:, None]
    on = dirs.copy()
    on[..., 1] = 0.0
    assert torch.equal(r.render_batch(x, off), r.render_batch(x, on))


@pytest.mark.parametrize("dir_rate", [1, 2])
def test_route_spans_and_mac_rows(tables, dir_rate):
    """Spans ``tt.input_spectra`` and ``tt.epilogue`` nest under
    ``tt.route`` in the call's root, and ``mac_rows`` counts S·nb rows at
    every dir_rate (the kernel assembles a filter for each block), with
    tracing on or off."""
    port, _ = tables
    x, dirs = _inputs()
    r = tt.BinauralRenderer(port, tt.RenderConfig(block_size=B,
                                                  dir_rate=dir_rate))
    before = profiling.counters().get("mac_rows", 0)
    r.render_batch(x, dirs)
    assert profiling.counters()["mac_rows"] - before == S * NB
    profiling.clear()
    with profiling.tracing():
        r.render_batch(x, dirs)
    spans = profiling.spans()
    root, = [s for s in spans if s.parent is None]
    assert root.name == "tt.render_batch"
    assert root.counts["mac_rows"] == S * NB
    route, = [s for s in spans if s.name == "tt.route"]
    for name in ("tt.input_spectra", "tt.epilogue"):
        span, = [s for s in spans if s.name == name]
        assert span.parent == route.id and span.call == root.id
        assert route.start_ns <= span.start_ns <= span.end_ns <= route.end_ns
    profiling.clear()

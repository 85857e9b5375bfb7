"""The head-tracked room configuration (`benchmark/configs/room44k.json`:
one ring of 360 azimuths, 1 s BRIRs kept whole) through `render_streamed`'s
partitioned route on the CPU, at a small size.

The head model's responses at 4096 taps plus the seeded diffuse tail of
`benchmark/reference/room.py` make the table; blocks of 64 make P = 65
partitions. The port's render is held to the benchmark's float64 streamed
map (`benchmark/reference/streamed.py`), that map to the port's float64
`GoldenStream` block by block, the tail to its stated decay and level,
and the partitioned route's spans and counters are checked under
`tracing()`. One test at the cell's own widths runs on the card only."""

import math

import numpy as np
import pytest
import torch

import tinaural_torch as tt
from benchmark.reference import fast, room, streamed, synthetic
from benchmark.reference.grids import SphericalGrid as RefGrid
from tinaural_torch.data.grids import SphericalGrid
from tinaural_torch.data.table import TorchTable, build_table
from tinaural_torch.models import renderer as rd
from tinaural_torch.ops import partitioned_conv as pc
from tinaural_torch.reference.golden import GoldenStream
from tinaural_torch.utils import profiling

torch.set_num_threads(1)

TAPS, RING, B, NB = 4096, 360, 64, 40
SEED = 2**33 + 29
ROOM = {"rt60_s": 1.0, "drr_db": 0.0, "predelay_ms": 5.0}
# The port in float32 against the float64 map: 65 partitions of 64-sample
# frames over a 4096-tap room response leave ≤ 3e-7 of the peak (2.96e-7
# at the worst of 24 renders over 3 seeded tables); 1e-5 keeps 30× room,
# and the bfloat16 control reads 3.6e-3–5.0e-3, 360× above it.
TOL = 1e-5


def config(taps=TAPS, ring=RING, room_block=ROOM):
    return {"taps": taps, "sample_rate": 44100,
            "grid": {"elevs": [0.0], "az_counts": [ring]},
            "hrir": {"head_radius_m": 0.0875, "noise": 1e-4,
                     "room": room_block}}


def room_responses(cfg, seed=SEED):
    """(E, A, 2, taps) head-model responses with the room's tail, and the
    reference's grid."""
    g = RefGrid(elevs=np.array(cfg["grid"]["elevs"]),
                az_counts=np.array(cfg["grid"]["az_counts"]))
    h, _ = synthetic.synthesize_hrirs(g, taps=cfg["taps"], noise=1e-4,
                                      seed=seed)
    valid = g.validity_mask().astype(np.float64)
    return room.with_tail(h, valid, cfg, seed), g


@pytest.fixture(scope="module")
def tables():
    """(the port's raw TorchTable, the reference's float64 raw Table) of
    one room set; the responses are rounded to float32 first, as the
    port stores them, so the two hold the same values."""
    h, g = room_responses(config())
    h = h.astype(np.float32).astype(np.float64)
    pg = SphericalGrid(np.array([0.0]), np.array([RING]))
    arrays = build_table(h, pg, 44100, decompose=False)
    return (TorchTable.from_hrir_table(arrays, "cpu"),
            room.raw_table(h, g, 44100), arrays)


def _inputs(seed=SEED + 1, nb=NB, block=B):
    """A noise signal and a head turning through an arc with a wobble."""
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal(nb * block)).astype(np.float32)
    t = np.arange(nb) / nb
    az = (rng.uniform(0, 360) + rng.uniform(-300, 300) * t
          + 20.0 * np.sin(2 * np.pi * 3 * t))
    dirs = np.stack([np.remainder(az, 360.0), np.zeros(nb)], -1)
    return x, dirs.astype(np.float32)


def _err(y, ref):
    """The worst sample's error over the reference's peak."""
    return float((y.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("crossfade", [True, False])
@pytest.mark.parametrize("dir_rate", [1, 2])
def test_render_streamed_matches_the_streamed_map(tables, crossfade,
                                                  dir_rate):
    port, ref, _ = tables
    x, dirs = _inputs()
    cfg = tt.RenderConfig(block_size=B, stream_block=B, crossfade=crossfade,
                          dir_rate=dir_rate, apply_itd=False,
                          apply_ild=False)
    y = tt.BinauralRenderer(port, cfg).render_streamed(x, dirs)
    want = streamed.render(fast.device_table(ref, "cpu"), x, dirs,
                           fast.Config(block_size=B, crossfade=crossfade,
                                       dir_rate=dir_rate))
    assert y.shape == want.shape == (2, NB * B)
    assert _err(y, want) <= TOL, _err(y, want)


def test_bfloat16_control_fails_the_tolerance(tables):
    """The map computed in the next precision below float32 (every stored
    stage rounded to bfloat16) is far outside TOL."""
    _, ref, _ = tables
    x, dirs = _inputs()
    rcfg = fast.Config(block_size=B)
    want = streamed.render(fast.device_table(ref, "cpu"), x, dirs, rcfg)
    ctl = streamed.render(fast.device_table(ref, "cpu", fast.BFLOAT16), x,
                          dirs, rcfg)
    assert _err(ctl, want) > 100 * TOL, _err(ctl, want)


@pytest.mark.parametrize("crossfade", [True, False])
def test_streamed_map_is_golden_stream(tables, crossfade):
    """In float64 the benchmark's map is `GoldenStream.push` block by block
    (whole-filter windows against the partitioned delay line)."""
    _, ref, arrays = tables
    x, dirs = _inputs(nb=12)
    want = streamed.render(fast.device_table(ref, "cpu"),
                           x, dirs, fast.Config(block_size=B,
                                                crossfade=crossfade))
    gs = GoldenStream(arrays, tt.RenderConfig(stream_block=B,
                                              crossfade=crossfade))
    gold = np.concatenate([gs.push(x[b * B:(b + 1) * B], *dirs[b])
                           for b in range(12)], -1)
    assert np.abs(want.numpy() - gold).max() <= 1e-12 * np.abs(gold).max()


def test_streamed_map_refuses_a_partial_block(tables):
    _, ref, _ = tables
    x, dirs = _inputs()
    with pytest.raises(ValueError, match="whole blocks"):
        streamed.render(fast.device_table(ref, "cpu"), x[:-1], dirs,
                        fast.Config(block_size=B))


def test_room_tail_same_bits_for_the_same_seed():
    cfg = config()
    a, _ = room_responses(cfg)
    b, _ = room_responses(cfg)
    c, _ = room_responses(cfg, SEED + 1)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def _tail(cfg, seed=SEED):
    g = RefGrid(elevs=np.array([0.0]), az_counts=np.array([36]))
    h, _ = synthetic.synthesize_hrirs(g, taps=cfg["taps"], noise=0.0)
    valid = g.validity_mask().astype(np.float64)
    return room.tail(h, valid, cfg, seed), h, valid


@pytest.mark.parametrize("rt60", [1.0, 0.4])
def test_room_tail_decays_at_rt60(rt60):
    """Schroeder's backward integral of each ear's tail, fitted over −5 …
    −35 dB (ISO 3382-1's T30), gives T60 within 3% (over 20 seeds the
    fit read 0.985–1.012 of it: the seeded noise's own fluctuation)."""
    cfg = config(taps=44100, room_block={**ROOM, "rt60_s": rt60})
    tl, _, _ = _tail(cfg)
    assert (tl[:, :room.onset(cfg)] == 0).all() and room.onset(cfg) == 240
    for ear in tl:
        edc = 10 * np.log10(np.cumsum(ear[::-1] ** 2)[::-1] / (ear ** 2).sum())
        sel = (edc <= -5) & (edc >= -35)
        slope = np.polyfit(np.arange(ear.size)[sel] / 44100, edc[sel], 1)[0]
        assert -60.0 / slope == pytest.approx(rt60, rel=0.03)


@pytest.mark.parametrize("drr", [0.0, 6.0])
def test_room_tail_level_is_drr(drr):
    """Each ear's mean direct energy over the tail's is drr_db, and the
    one tail is shared by every direction."""
    cfg = config(taps=8192, room_block={**ROOM, "drr_db": drr})
    tl, h, valid = _tail(cfg)
    direct = (h ** 2).sum(-1).reshape(-1, 2).mean(0)
    got = 10 * np.log10(direct / (tl ** 2).sum(-1))
    assert got == pytest.approx([drr, drr], abs=1e-9)
    added = room.with_tail(h, valid, cfg, SEED) - h  # one rounding of h + tail
    assert np.abs(added - tl).max() <= 1e-15 * np.abs(h).max()


def test_partitioned_spans_and_counters_on_a_chunked_render(tables,
                                                            monkeypatch):
    """`chunked_render` with the plain versions and chunks of 12 blocks:
    ``tt.frames`` once, ``tt.partitions`` and ``tt.conv`` once a chunk in
    turn; ``partition_rows`` the rows each chunk assembles (its
    predecessor row included) × P, and ``conv_chunks`` the chunks, with
    tracing on or off."""
    port, _, _ = tables
    x, dirs = _inputs()
    xb = torch.from_numpy(x).reshape(NB, B)
    cfg = tt.RenderConfig(stream_block=B)
    idx, w = rd._neighbours(port, torch.from_numpy(dirs), cfg)
    P = pc.n_parts(TAPS, B)
    row_bytes = P * 2 * (B + 1) * 8
    monkeypatch.setattr(pc, "CHUNK_BYTES", 12 * row_bytes)
    chunks = pc.render_chunks(NB, 1, 12)
    assert len(chunks) == 4
    kw = dict(crossfade=True, apply_itd=False, apply_ild=False, dir_rate=1,
              frames=lambda xb, P: pc.frame_spectra_reference(xb, 0, NB))

    def render():
        return pc.chunked_render(pc.assemble_partitions_reference,
                                 pc.partitioned_conv_reference, xb, idx, w,
                                 port, **kw)

    rows = sum(r1 - r0 for _, _, r0, r1 in chunks)
    assert rows == NB + 3
    before = profiling.counters()
    y = render()
    after = profiling.counters()
    assert after["partition_rows"] - before.get("partition_rows", 0) == rows * P
    assert after["conv_chunks"] - before.get("conv_chunks", 0) == 4
    profiling.clear()
    with profiling.tracing(), profiling.span("tt.call"):
        assert torch.equal(render(), y)
    spans = profiling.spans()
    root, = [s for s in spans if s.parent is None]
    assert root.counts == {"partition_rows": rows * P, "conv_chunks": 4}
    kids = [s.name for s in sorted(spans, key=lambda s: s.start_ns)
            if s.parent == root.id]
    assert kids == ["tt.frames"] + ["tt.partitions", "tt.conv"] * 4
    profiling.clear()


@pytest.mark.parametrize("dir_rate", [1, 2])
def test_render_streamed_spans_under_the_route(tables, dir_rate):
    """Through the public entry point (the plain route, one pass): the
    three spans under ``tt.route``, ``partition_rows`` = ⌈nb/k⌉·P, no
    chunks counted."""
    port, _, _ = tables
    x, dirs = _inputs()
    r = tt.BinauralRenderer(port, tt.RenderConfig(stream_block=B,
                                                  dir_rate=dir_rate))
    profiling.clear()
    with profiling.tracing():
        r.render_streamed(x, dirs)
    spans = profiling.spans()
    root, = [s for s in spans if s.parent is None]
    assert root.name == "tt.render_streamed"
    assert root.counts["partition_rows"] == -(-NB // dir_rate) * 65
    assert "conv_chunks" not in root.counts
    route, = [s for s in spans if s.name == "tt.route"]
    for name in ("tt.frames", "tt.partitions", "tt.conv"):
        span, = [s for s in spans if s.name == name]
        assert span.parent == route.id and span.call == root.id
    profiling.clear()


@pytest.mark.gpu
def test_cell_widths_on_the_card():
    """The cell's widths on the card: 360 azimuths of 44,100-tap room
    responses, blocks of 512 (P 87, L 65536), 4096 blocks in 11 chunks
    of `assemble_partitions` and `partitioned_conv`, held to the float64
    streamed map within the cell's limit (`benchmark/workloads/
    room44k.streamed.json`: the card read 3.3e-7–3.8e-7 of the peak over
    7 seeds, the bfloat16 control 5.9e-3–7.0e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = config(taps=44100)
    h, g = room_responses(cfg)
    pg = SphericalGrid(np.array([0.0]), np.array([RING]))
    dev = torch.device("cuda", 0)
    port = TorchTable.from_hrir_table(build_table(h, pg, 44100,
                                                  decompose=False), dev)
    x, dirs = _inputs(nb=4096, block=512)
    rcfg = tt.RenderConfig(block_size=512, stream_block=512, apply_itd=False,
                           apply_ild=False)
    before = dict(pc.launches)
    y = tt.BinauralRenderer(port, rcfg).render_streamed(x, dirs)
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in pc.launches.items()}
    assert made == {"assemble_partitions": 11, "stream_conv": 0,
                    "frame_spectra": 1, "partitioned_conv": 11}
    want = streamed.render(fast.device_table(room.raw_table(h, g, 44100),
                                             dev), x, dirs,
                           fast.Config(block_size=512))
    assert y.shape == want.shape == (2, 4096 * 512)
    assert _err(y, want) <= 1e-4 and math.isfinite(_err(y, want))

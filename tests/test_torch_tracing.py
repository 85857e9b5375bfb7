"""The span and counter registry of `tinaural_torch.utils.profiling` on the
CPU: spans record only inside `tracing()` or a profiler session, nest under
one root a call with one call id (the blocks' ``tt.h2d`` inside
``tt.blockify``), lie on the profiler's timeline with the same nesting and
durations, and the counters (``h2d_bytes``, the kernel wrappers'
``launches``) count whether tracing is on or not; a CPU table counts no
``h2d_pinned_bytes``, and its `_to_device` copies are fresh tensors."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tinaural_torch as tt
from tinaural_torch.ops import assembly_mac as am
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops import block_step as bs
from tinaural_torch.ops import partitioned_conv as pc
from tinaural_torch.utils import profiling

torch.set_num_threads(1)

B, NB, S = 256, 16, 3
CHILDREN = {"render_trajectory": {"tt.blockify", "tt.h2d", "tt.lookup",
                                  "tt.route"},
            "render_scene": {"tt.dedupe", "tt.blockify", "tt.h2d",
                             "tt.lookup", "tt.route"}}
# The profiler's range opens before the span's first clock read and
# closes after its last: its duration is the record's, plus the cost of a
# range's ends, which stays under this on a loaded CPU.
RANGE_SLACK_US = 1000.0


@pytest.fixture(scope="module")
def renderer():
    t = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), "cpu")
    return tt.BinauralRenderer(t, tt.RenderConfig(block_size=B))


def _calls(renderer):
    """{entry point: (a call of it, the bytes it copies to the device)}."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal(NB * B).astype(np.float32)
    dirs = np.stack([np.linspace(0, 300, NB), np.linspace(-30, 60, NB)],
                    1).astype(np.float32)
    xs = rng.standard_normal((S, NB * B)).astype(np.float32)
    sdirs = np.stack([dirs, dirs[::-1], dirs + 5.0])  # three distinct tracks
    return {
        "render_trajectory": (lambda: renderer.render_trajectory(x, dirs),
                              NB * B * 4 + NB * 2 * 4),
        "render_scene": (lambda: renderer.render_scene(xs, sdirs),
                         S * NB * B * 4 + S * NB * 2 * 4),
        "render": (lambda: renderer.render(x, 30.0, 10.0),
                   NB * B * 4 + 2 * 4),
        "render_batch": (lambda: renderer.render_batch(xs, sdirs),
                         S * NB * B * 4 + S * NB * 2 * 4),
        "render_streamed": (lambda: renderer.render_streamed(
            x, np.repeat(dirs, B // renderer.config.stream_block, 0)),
            NB * B * 4 + NB * B // renderer.config.stream_block * 2 * 4),
    }


def _roots(spans):
    return [s for s in spans if s.parent is None]


def test_span_off_is_one_shared_no_op():
    assert profiling.span("tt.a") is profiling.span("tt.b")
    with profiling.tracing():
        assert profiling.span("tt.a") is not profiling.span("tt.a")
    assert profiling.span("tt.a") is profiling.span("tt.b")


@pytest.mark.parametrize("entry", sorted(CHILDREN))
def test_tracing_off_records_no_span_and_counters_count(renderer, entry):
    call, nbytes = _calls(renderer)[entry]
    profiling.clear()
    before = profiling.counters().get("h2d_bytes", 0)
    call()
    assert profiling.spans() == []
    assert profiling.counters()["h2d_bytes"] - before == nbytes


@pytest.mark.parametrize("entry", sorted(CHILDREN))
def test_tracing_nests_the_layers_under_one_root(renderer, entry):
    call, nbytes = _calls(renderer)[entry]
    profiling.clear()
    with profiling.tracing():
        call()
    spans = profiling.spans()
    (root,) = _roots(spans)
    assert root.name == f"tt.{entry}" and root.call == root.id
    kids = sorted((s for s in spans if s.parent == root.id),
                  key=lambda s: s.start_ns)
    assert {s.name for s in kids} == CHILDREN[entry]
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    for s in kids:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    # the blocks' copy lies inside tt.blockify; the directions' is a child
    (blocks,) = [s for s in kids if s.name == "tt.blockify"]
    (inner,) = [s for s in spans if s.parent not in (None, root.id)]
    assert inner.name == "tt.h2d" and inner.parent == blocks.id
    assert blocks.start_ns <= inner.start_ns <= inner.end_ns <= blocks.end_ns
    assert [s.name for s in kids].count("tt.h2d") == 1
    assert all(s.call == root.id and not s.counts for s in spans
               if s is not root)
    assert root.counts == {"h2d_bytes": nbytes}  # no launches, no sync


@pytest.mark.parametrize("entry,layout", [
    ("render_trajectory", "reversed"), ("render_trajectory", "strided"),
    ("render_scene", "reversed"), ("render_scene", "fortran")])
def test_non_contiguous_input_counts_its_host_copy(renderer, entry, layout):
    """The one host copy `_blockify` makes, of an input that is not
    C-contiguous, counts its float32 bytes as ``blockify_host_bytes``."""
    rng = np.random.default_rng(23)
    lead = () if entry == "render_trajectory" else (S,)
    if layout == "strided":
        x = rng.standard_normal((*lead, 2 * NB * B)).astype(np.float32)
        x = x[..., ::2]
    else:
        x = rng.standard_normal((*lead, NB * B)).astype(np.float32)
        x = x[..., ::-1] if layout == "reversed" else np.asfortranarray(x)
    assert not x.flags.c_contiguous
    dirs = np.stack([np.linspace(0, 300, NB), np.linspace(-30, 60, NB)],
                    1).astype(np.float32)
    if entry == "render_trajectory":
        call, nbytes = lambda: renderer.render_trajectory(x, dirs), NB * 2 * 4
    else:
        sdirs = np.stack([dirs, dirs[::-1], dirs + 5.0])
        call = lambda: renderer.render_scene(x, sdirs)  # noqa: E731
        nbytes = S * NB * 2 * 4
    profiling.clear()
    with profiling.tracing():
        call()
    (root,) = _roots(profiling.spans())
    host = x.size * 4
    assert root.counts == {"h2d_bytes": host + nbytes,
                           "blockify_host_bytes": host}


@pytest.mark.parametrize("entry", ["render", "render_batch",
                                   "render_streamed"])
def test_every_entry_point_has_its_root(renderer, entry):
    call, nbytes = _calls(renderer)[entry]
    profiling.clear()
    with profiling.tracing():
        call()
    spans = profiling.spans()
    (root,) = _roots(spans)
    want = {"h2d_bytes": nbytes}
    if entry == "render_streamed":  # and the partitions it assembles
        sb = renderer.config.stream_block
        want["partition_rows"] = NB * B // sb * pc.n_parts(
            renderer.table.taps, sb)
    assert root.name == f"tt.{entry}" and root.counts == want
    names = {s.name for s in spans if s is not root}
    assert {"tt.h2d", "tt.lookup", "tt.route"} <= names
    assert all(s.call == root.id for s in spans)


@pytest.mark.parametrize("entry", ["render", "render_batch", "render_scene",
                                   "render_streamed", "render_trajectory"])
def test_cpu_table_counts_no_pinned_bytes(renderer, entry):
    """Only a card's copies go through page-locked memory: a CPU table's
    entry points count their bytes in ``h2d_bytes`` and none in
    ``h2d_pinned_bytes``."""
    call, nbytes = _calls(renderer)[entry]
    before = profiling.counters()
    call()
    after = profiling.counters()
    assert after["h2d_bytes"] - before.get("h2d_bytes", 0) == nbytes
    assert after.get("h2d_pinned_bytes", 0) == before.get("h2d_pinned_bytes",
                                                          0)


@pytest.mark.parametrize("shape", [(7,), (3, 5)], ids=str)
@pytest.mark.parametrize("layout", ["contiguous", "reversed"])
def test_to_device_on_the_cpu_is_a_fresh_tensor(renderer, shape, layout):
    a = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    if layout == "reversed":
        a = a[..., ::-1]
    kept = a.copy()
    t = renderer._to_device(a)
    assert t.device.type == "cpu" and np.array_equal(t.numpy(), kept)
    a[...] = -1.0  # the caller's array changes, the tensor does not
    assert np.array_equal(t.numpy(), kept)
    t.add_(1.0)  # nor do the tensor's changes reach the caller's array
    assert np.all(a == -1.0)


@pytest.mark.parametrize("entry", sorted(CHILDREN))
def test_profiler_session_records_the_spans_on_its_timeline(renderer, entry):
    """Two calls in a session; the second is compared (a session's first
    range pays for its set-up)."""
    call, _ = _calls(renderer)[entry]
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
        call()
    roots = _roots(profiling.spans())
    assert [r.name for r in roots] == [f"tt.{entry}"] * 2
    spans = sorted((s for s in profiling.spans() if s.call == roots[1].id),
                   key=lambda s: s.start_ns)
    assert {s.name for s in spans[1:]} == CHILDREN[entry]
    assert len(spans) == len(CHILDREN[entry]) + 2  # the root; h2d twice
    events = sorted((e for e in prof.events() if e.name.startswith("tt.")),
                    key=lambda e: e.time_range.start)
    assert len(events) == 2 * len(spans)
    events = events[len(spans):]
    assert [e.name for e in events] == [s.name for s in spans]
    top = events[0]
    for e in events[1:]:
        assert top.time_range.start <= e.time_range.start
        assert e.time_range.end <= top.time_range.end
    for e, s in zip(events, spans):
        ours = (s.end_ns - s.start_ns) / 1e3
        theirs = e.time_range.end - e.time_range.start
        assert ours <= theirs + 5.0, (s.name, ours, theirs)
        assert theirs - ours < RANGE_SLACK_US, (s.name, ours, theirs)


def test_ring_stays_at_its_bound():
    profiling.clear()
    extra = 100
    with profiling.tracing():
        for _ in range(profiling.RING_SPANS + extra):
            with profiling.span("tt.test"):
                pass
    spans = profiling.spans()
    assert len(spans) == profiling.RING_SPANS
    assert spans[-1].id - spans[0].id == profiling.RING_SPANS - 1
    profiling.clear()
    assert profiling.spans() == []


def test_counters_hold_every_launches_entry():
    got = profiling.counters()
    for mod in (br, bs, am, pc):
        for kernel, n in mod.launches.items():
            assert got[f"launches.{kernel}"] == n
    n = br.launches["overlap_add"]
    profiling.clear()
    try:
        with profiling.tracing(), profiling.span("tt.test"):
            br.launches["overlap_add"] += 2
            profiling.count("test.counter", 3)
    finally:
        br.launches["overlap_add"] = n
    (root,) = profiling.spans()
    assert root.counts == {"launches.overlap_add": 2, "test.counter": 3}
    assert profiling.counters()["launches.overlap_add"] == n

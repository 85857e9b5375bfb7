"""The ``dir_rate`` unique-filter path: one filter per group of k blocks,
block b under row ⌊b/k⌋ and, crossfading, row ⌊(b−1)/k⌋.

Each plain k-path of the port is held against the JAX package's Pallas
kernel at the same ``dir_rate`` in interpret mode (`fused_block_render`
in its gather mode, `fused_block_step`, `fused_partitioned_assembled`) on
the same snapped directions, and against the port's own k = 1 path with
every block's row of the snapped track; the renderer's cores are spied on
for the rows and the ``dir_rate`` they hand their route; the crossfade is
checked at and inside a group; `partitioned_render`'s chunks and row map
against a numpy model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from conftest import snr_db
from tinaural.ops.interp import interpolate
from tinaural.ops.pallas_kernels import (fused_block_render, fused_block_step,
                                         fused_partitioned_assembled,
                                         gather_tables, scramble_spectra)
from tinaural.reference import golden
from tinaural_torch.data import TorchTable
from tinaural_torch.models import renderer as rd
from tinaural_torch.ops import assembly_mac as am
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops import block_step as bs
from tinaural_torch.ops import partitioned_conv as pc

torch.set_num_threads(1)

FLAGS = dict(apply_itd=True, apply_ild=True)


@pytest.fixture(scope="module")
def tables():
    arrays = tinaural.load_hrir_set("synthetic")
    return arrays, TorchTable.from_hrir_table(arrays, "cpu")


def _track(rng, shape):
    """Random (az, el) per block: (*shape, 2) f32."""
    return np.stack([rng.uniform(0, 360, shape), rng.uniform(-40, 90, shape)],
                    -1).astype(np.float32)


def _group_rows(t, dirs: np.ndarray, k: int):
    """Table rows and weights of each group's direction: rows [::k] of the
    snapped track, (..., ⌈nb/k⌉, 4)."""
    return rd._neighbours(t, rd._group_dirs(torch.from_numpy(dirs), k),
                          tinaural_torch.RenderConfig())


def _per_block(z: torch.Tensor, nb: int, k: int) -> torch.Tensor:
    """Group rows (..., ⌈nb/k⌉, 4) → every block's row (..., nb, 4): the
    snapped track's rows at dir_rate 1."""
    return z[..., torch.arange(nb) // k, :].contiguous()


def _cplanes(Y: torch.Tensor, n_fft: int):
    """Natural-order (..., 2, F) spectra → the JAX package's scrambled
    planes (real, imag)."""
    Rr, Ri = scramble_spectra(jnp.asarray(Y.numpy()), n_fft)
    return np.asarray(Rr), np.asarray(Ri)


# --------------------------------------------- against the JAX kernels' k-path


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("crossfade", [True, False])
def test_block_render_reference_matches_pallas_dir_rate(tables, k, crossfade):
    """B1: `block_render_reference` at dir_rate k against
    `fused_block_render(dir_rate=k)` in its gather mode (chunk 32, so
    chunk/k ≥ 8), two sources of 10 blocks (no multiple of 4)."""
    arrays, t = tables
    S, nb, B = 2, 10, 256
    rng = np.random.default_rng(40 + k + crossfade)
    xbs = rng.standard_normal((S, nb, B)).astype(np.float32)
    dirs = _track(rng, (S, nb))
    idx, w = _group_rows(t, dirs, k)
    assert idx.shape == (S, -(-nb // k), 4)
    n_fft = rd._n_fft(t, B)
    kw = dict(crossfade=crossfade, **FLAGS)
    ours = br.block_render_reference(torch.from_numpy(xbs), idx, w, t, n_fft,
                                     dir_rate=k, **kw).numpy()
    ht, dg = gather_tables(jnp.asarray(arrays.h), jnp.asarray(arrays.delays),
                           jnp.asarray(arrays.gains), t.taps, n_fft)
    # the JAX wrapper takes every block's row of the snapped track and
    # slices rows [::k] itself
    theirs = np.asarray(fused_block_render(
        None, None, None, jnp.asarray(xbs), t.taps, n_fft,
        idx=jnp.asarray(_per_block(idx, nb, k).numpy().astype(np.float32)),
        w=jnp.asarray(_per_block(w, nb, k).numpy()), ht=ht, dg=dg,
        interpret=True, chunk=32, dir_rate=k, **kw))
    assert ours.shape == theirs.shape == (2, (nb - 1) * B + n_fft)
    assert snr_db(theirs, ours) >= 90


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("crossfade", [True, False])
def test_block_spectra_reference_matches_pallas_dir_rate(tables, k,
                                                         crossfade):
    """B3: the plain `assemble_filters` on the ⌈nb/k⌉ group rows, then the
    plain `block_spectra` at dir_rate k, against `fused_block_step(
    dir_rate=k)` in interpret mode (chunk 8k, the least it takes), read
    back through the JAX package's scrambled-half layout; 10 blocks (no
    multiple of 4)."""
    arrays, t = tables
    nb, B = 10, 256
    rng = np.random.default_rng(50 + k + crossfade)
    xb = rng.standard_normal((nb, B)).astype(np.float32)
    dirs = _track(rng, nb)
    snapped = jnp.asarray(golden.snap_dirs(dirs, k))
    jcfg = tinaural.RenderConfig(block_size=B)
    tbl = jax.device_put(arrays)
    h, d, g = jax.vmap(lambda a, e: interpolate(tbl, a, e, jcfg))(
        snapped[:, 0], snapped[:, 1])
    n_fft = rd._n_fft(t, B)
    Ysr, Ysi = fused_block_step(h, d, g, jnp.asarray(xb),
                                jnp.zeros((nb,), jnp.float32), t.taps, n_fft,
                                crossfade=crossfade, interpret=True,
                                chunk=8 * k, dir_rate=k)
    idx, w = _group_rows(t, dirs, k)
    H = br.assemble_filters_reference(idx[None], w[None], t, n_fft, **FLAGS)
    Y = bs.block_spectra_reference(torch.from_numpy(xb)[None], H, n_fft,
                                   crossfade=crossfade, dir_rate=k)[0]
    Rr, Ri = _cplanes(Y, n_fft)
    assert snr_db(np.asarray(Ysr), Rr) >= 90
    assert snr_db(np.asarray(Ysi), Ri) >= 90


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("crossfade", [True, False])
def test_partitioned_reference_matches_pallas_dir_rate(tables, k, crossfade):
    """B6: `partitioned_render_reference` at dir_rate k against
    `fused_partitioned_assembled(dir_rate=k)` in interpret mode (chunk
    8k, so two grid steps at k = 2), fed the same group rows (h, d, g of
    the snapped track's rows [::k]); P = 2."""
    arrays, t = tables
    nb, B = 16, 128  # the JAX kernel needs k | nb
    rng = np.random.default_rng(60 + k + crossfade)
    xb = rng.standard_normal((nb, B)).astype(np.float32)
    dirs = _track(rng, nb)
    groups = jnp.asarray(golden.snap_dirs(dirs, k)[::k])
    jcfg = tinaural.RenderConfig(stream_block=B)
    tbl = jax.device_put(arrays)
    h, d, g = jax.vmap(lambda a, e: interpolate(tbl, a, e, jcfg))(
        groups[:, 0], groups[:, 1])
    P = -(-(t.taps + 64) // B)
    theirs = np.asarray(fused_partitioned_assembled(
        jnp.asarray(xb), h, d, g, jnp.zeros((nb,), jnp.float32), t.taps, B,
        P, crossfade=crossfade, interpret=True, chunk=8 * k, dir_rate=k))
    idx, w = _group_rows(t, dirs, k)
    ours = pc.partitioned_render_reference(torch.from_numpy(xb), idx, w, t,
                                           crossfade=crossfade, dir_rate=k,
                                           **FLAGS).numpy()
    assert ours.shape == (2, nb * B)
    assert snr_db(theirs[:, :nb * B], ours) >= 90


# ------------------------------------------- against the port's own k = 1 path


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("crossfade", [True, False])
@pytest.mark.parametrize("nb", [8, 11])
def test_k_paths_equal_every_block_on_the_snapped_track(tables, k, crossfade,
                                                        nb):
    """Every plain k-path — B1, B3, the scene mixdown (B4), B9's route and
    the partitioned render (B6) — in float64 equals its k = 1 path fed
    every block's row of the snapped track, at nb a multiple of k and
    not."""
    _, t = tables
    S, B = 3, 256
    rng = np.random.default_rng(70 + 10 * k + nb + crossfade)
    xbs = torch.from_numpy(rng.standard_normal((S, nb, B)))
    idx, w = _group_rows(t, _track(rng, (S, nb)), k)
    every = (_per_block(idx, nb, k), _per_block(w, nb, k))
    kw = dict(crossfade=crossfade, **FLAGS)
    n_fft = rd._n_fft(t, B)
    for plain in (br.block_render_reference, bs.block_step_render_reference,
                  bs.scene_step_render_reference,
                  am.assembly_mac_render_reference):
        y = plain(xbs, idx, w, t, n_fft, dir_rate=k, **kw)
        y1 = plain(xbs, *every, t, n_fft, **kw)
        assert snr_db(y1.numpy(), y.numpy()) >= 130, plain.__name__
    y = pc.partitioned_render_reference(xbs[0], idx[0], w[0], t, dir_rate=k,
                                        **kw)
    y1 = pc.partitioned_render_reference(xbs[0], every[0][0], every[1][0], t,
                                         **kw)
    assert snr_db(y1.numpy(), y.numpy()) >= 130


def test_one_filter_per_source_is_dir_rate_nb(tables):
    """A static source (one row, dir_rate ≥ nb) through every route's plain
    version equals that row on every block at dir_rate 1."""
    _, t = tables
    S, nb, B = 2, 6, 256
    rng = np.random.default_rng(80)
    xbs = torch.from_numpy(rng.standard_normal((S, nb, B)))
    idx, w = _group_rows(t, _track(rng, (S, 1)), 1)
    kw = dict(crossfade=True, **FLAGS)
    n_fft = rd._n_fft(t, B)
    for plain in (br.block_render_reference, bs.block_step_render_reference,
                  am.assembly_mac_render_reference):
        y1 = plain(xbs, idx.expand(S, nb, 4), w.expand(S, nb, 4), t, n_fft,
                   **kw)
        for k in (nb, 8 * nb):
            y = plain(xbs, idx, w, t, n_fft, dir_rate=k, **kw)
            assert snr_db(y1.numpy(), y.numpy()) >= 130, plain.__name__


# ---------------------------------------------------------------- the cores


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_cores_hand_the_route_group_rows(tables, k):
    """`_trajectory_core`, `_scene_core`, `_batch_core` and
    `_partitioned_core` look up ⌈nb/k⌉ directions a source, the snapped
    track's rows [::k], and pass them with dir_rate=k to the route; the
    output equals the k = 1 core on the snapped track."""
    _, t = tables
    S, nb, B = 2, 11, 256
    rng = np.random.default_rng(90 + k)
    xbs = torch.from_numpy(rng.standard_normal((S, nb, B)).astype(np.float32))
    dirs = torch.from_numpy(_track(rng, (S, nb)))
    snapped = torch.from_numpy(np.stack([golden.snap_dirs(d, k)
                                         for d in dirs.numpy()]))
    cfg = tinaural_torch.RenderConfig(block_size=B, stream_block=B,
                                      dir_rate=k)
    calls = []

    def spy(route):
        def call(xbs, idx, w, *args, dir_rate, **kw):
            calls.append((tuple(idx.shape), tuple(w.shape), dir_rate, idx))
            return route(xbs, idx, w, *args, dir_rate=dir_rate, **kw)
        return call

    rows = -(-nb // k)
    for core, x, d, route, lead in (
            (rd._trajectory_core, xbs[0], dirs[0], br.block_render, (1,)),
            (rd._trajectory_core, xbs[0], dirs[0], am.assembly_mac_render,
             (1,)),
            (rd._scene_core, xbs, dirs, bs.scene_step_render, (S,)),
            (rd._scene_core, xbs, dirs, br.block_render, (S,)),
            (rd._batch_core, xbs, dirs, bs.block_step_render, (S,)),
            (rd._partitioned_core, xbs[0], dirs[0], pc.partitioned_render,
             ())):
        y = core(t, x, d, cfg, render=spy(route))
        shape, wshape, rate, idx = calls[-1]
        assert shape == wshape == (*lead, rows, 4) and rate == k
        sn = snapped[0] if d.dim() == 2 else snapped
        want, _ = rd._neighbours(t, sn[..., ::k, :], cfg)
        assert torch.equal(idx.reshape(want.shape), want)
        y1 = core(t, x, sn, cfg.replace(dir_rate=1), render=route)
        assert snr_db(y1.numpy(), y.numpy()) >= 130, core.__name__


def test_static_cores_keep_one_filter_per_source(tables):
    """`_static_block_core` and `_scene_static_core` hand their route one
    row per source and dir_rate nb, whatever the config's dir_rate."""
    _, t = tables
    S, nb, B = 2, 9, 256
    rng = np.random.default_rng(95)
    xbs = torch.from_numpy(rng.standard_normal((S, nb, B)).astype(np.float32))
    dirs = torch.from_numpy(_track(rng, S))
    cfg = tinaural_torch.RenderConfig(block_size=B, dir_rate=4)
    calls = []

    def spy(route):
        def call(xbs, idx, w, *args, dir_rate, **kw):
            calls.append((tuple(idx.shape), dir_rate))
            return route(xbs, idx, w, *args, dir_rate=dir_rate, **kw)
        return call

    rd._static_block_core(t, xbs[0], dirs[0], cfg,
                          render=spy(bs.block_step_render))
    assert calls[-1] == ((1, 1, 4), nb)
    for route in (bs.scene_step_render, br.block_render):
        rd._scene_static_core(t, xbs, dirs, cfg, render=spy(route))
        assert calls[-1] == ((S, 1, 4), nb)


def test_public_renders_at_dir_rate_equal_the_snapped_track(tables):
    """`render_trajectory`, `render_scene`, `render_batch` and
    `render_streamed` at dir_rate 4 equal the same renders at dir_rate 1
    of the snapped track."""
    _, t = tables
    B, nb, S = 256, 10, 3
    rng = np.random.default_rng(97)
    x = rng.standard_normal(nb * B).astype(np.float32)
    xs = rng.standard_normal((S, nb * B)).astype(np.float32)
    dirs, sdirs = _track(rng, nb), _track(rng, (S, nb))
    snap = lambda d: golden.snap_dirs(d, 4)
    ssnapped = np.stack([snap(d) for d in sdirs])
    r4, r1 = (tinaural_torch.BinauralRenderer(t, tinaural_torch.RenderConfig(
        block_size=B, stream_block=B, dir_rate=k)) for k in (4, 1))
    for call, args4, args1 in (
            ("render_trajectory", (x, dirs), (x, snap(dirs))),
            ("render_streamed", (x, dirs), (x, snap(dirs))),
            ("render_scene", (xs, sdirs), (xs, ssnapped)),
            ("render_batch", (xs, sdirs), (xs, ssnapped))):
        y4 = getattr(r4, call)(*args4).numpy()
        y1 = getattr(r1, call)(*args1).numpy()
        assert snr_db(y1, y4) >= 130, call


# -------------------------------------------------- the crossfade at a group


@pytest.mark.parametrize("k", [2, 4])
def test_crossfade_at_a_group_boundary(tables, k):
    """Crossfading, a block that starts a group (b > 0, b % k = 0) blends
    its group's filter with the previous group's; a block inside a group
    has the same filter on both sides, so its output equals the render
    without crossfade there; block 0 takes its own filter. Checked on the
    block spectra (B1, B3, B4) and on the partitioned render's blocks
    (B6)."""
    _, t = tables
    nb, B = 9, 256
    rng = np.random.default_rng(99 + k)
    xb = torch.from_numpy(rng.standard_normal((1, nb, B)))
    idx, w = _group_rows(t, _track(rng, (1, nb)), k)
    n_fft = rd._n_fft(t, B)
    H = br.assemble_filters_reference(idx, w.double(), t, n_fft, **FLAGS)
    Yx = bs.block_spectra_reference(xb, H, n_fft, crossfade=True, dir_rate=k)
    Y0 = bs.block_spectra_reference(xb, H, n_fft, crossfade=False, dir_rate=k)
    u = (torch.arange(B, dtype=xb.dtype) + 0.5) / B
    Xu = torch.fft.rfft(xb[0] * u, n=n_fft)[:, None]
    Xd = torch.fft.rfft(xb[0] * (1 - u), n=n_fft)[:, None]
    re = lambda z: torch.view_as_real(z).numpy()
    for b in range(nb):
        if b % k or b == 0:  # one filter on both sides
            assert snr_db(re(Y0[0, b]), re(Yx[0, b])) >= 130, b
        else:
            want = Xu[b] * H[0, b // k] + Xd[b] * H[0, b // k - 1]
            assert snr_db(re(want), re(Yx[0, b])) >= 130, b
            assert snr_db(re(Y0[0, b]), re(Yx[0, b])) < 60, b
    yx = pc.partitioned_render_reference(xb[0], idx[0], w[0], t,
                                         crossfade=True, dir_rate=k, **FLAGS)
    y0 = pc.partitioned_render_reference(xb[0], idx[0], w[0], t,
                                         crossfade=False, dir_rate=k, **FLAGS)
    for b in range(nb):
        cut = slice(b * B, (b + 1) * B)
        s = snr_db(y0[:, cut].numpy(), yx[:, cut].numpy())
        assert (s >= 130) if (b % k or b == 0) else (s < 60), b


# ------------------------------------------- the partitioned render's chunks


@pytest.mark.parametrize("nb", [1, 7, 16, 37])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("chunk", [1, 3, 5, 16, 1000])
def test_render_chunks_and_row_map_match_a_numpy_model(nb, k, chunk):
    """`render_chunks` and `conv_rows` against a numpy model: the chunks
    cover blocks 0 … nb − 1 in order, start on a group, hold at most
    max(k, chunk) blocks; block b reads global row ⌊b/k⌋ and, as its
    previous filter, ⌊max(b − 1, 0)/k⌋, both inside the chunk's rows
    r0 … r1 − 1, of which it uses every one."""
    chunks = pc.render_chunks(nb, k, chunk)
    covered = np.concatenate([np.arange(b0, b1) for b0, b1, _, _ in chunks])
    assert np.array_equal(covered, np.arange(nb))
    for b0, b1, r0, r1 in chunks:
        blocks = np.arange(b0, b1)
        assert b0 % k == 0 and 0 < b1 - b0 <= max(k, chunk)
        row, prow = (r.numpy() for r in pc.conv_rows(b0, b1, k))
        assert np.array_equal(r0 + row, blocks // k)
        assert np.array_equal(r0 + prow, np.maximum(blocks - 1, 0) // k)
        assert set(row) | set(prow) == set(range(r1 - r0))
        assert 0 <= r0 < r1 <= -(-nb // k)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("crossfade", [True, False])
def test_chunked_render_equals_one_chunk(tables, monkeypatch, k, crossfade):
    """The CUDA route's chunking, run with the kernels' plain versions:
    chunks of 1 … 3 groups, the last group partial, equal the unchunked
    plain render, and the plain `partitioned_conv` refuses rows that do not
    cover its blocks."""
    _, t = tables
    nb, B = 11, 256
    rng = np.random.default_rng(110 + k)
    xb = torch.from_numpy(rng.standard_normal((nb, B)))
    idx, w = _group_rows(t, _track(rng, nb), k)
    kw = dict(crossfade=crossfade, dir_rate=k, **FLAGS)
    whole = pc.partitioned_render_reference(xb, idx, w, t, **kw)
    row_bytes = pc.n_parts(t.taps, B) * 2 * (B + 1) * 8
    for groups in (1, 2, 3):
        monkeypatch.setattr(pc, "CHUNK_BYTES", groups * row_bytes)
        y = pc.chunked_render(pc.assemble_partitions_reference,
                              pc.partitioned_conv_reference, xb, idx, w, t,
                              **kw)
        assert snr_db(whole.numpy(), y.numpy()) >= 130, groups
    hr, hi = pc.assemble_partitions_reference(idx, w, t, B, **FLAGS)
    if k > 1:
        with pytest.raises(ValueError):  # a start inside a group
            pc.partitioned_conv_reference(xb, hr, hi, crossfade=True,
                                          start=1, dir_rate=k)
    with pytest.raises(ValueError):  # one row short
        pc.partitioned_conv_reference(xb, hr[:-1], hi[:-1], crossfade=True,
                                      stop=nb, dir_rate=k)
    with pytest.raises(ValueError):  # one row short, at the route
        pc.partitioned_render(xb, idx[:-1], w[:-1], t, **kw)

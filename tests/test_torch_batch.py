"""tinaural_torch's static `render` and `render_batch`, and the plain
versions of their kernels, against tinaural (its plain jnp route, and its
Pallas kernels `fused_block_step` and `fused_epilogue` in interpret mode)
and the float64 golden oracle, on the same numpy inputs from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from conftest import snr_db
from tinaural.models.renderer import BinauralRenderer as JaxRenderer
from tinaural.reference import golden
from tinaural_torch.data import TorchTable
from tinaural_torch.models.renderer import _n_fft, _neighbours
from tinaural_torch.ops import _layout
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops import block_step as bs
from tinaural_torch.ops.ola import overlap_add

torch.set_num_threads(1)

B = 256


@pytest.fixture(scope="module")
def tables():
    arrays = tinaural.load_hrir_set("synthetic")
    return arrays, TorchTable.from_hrir_table(arrays, "cpu")


def _configs(**kw):
    return (tinaural_torch.RenderConfig(block_size=B, **kw),
            tinaural.RenderConfig(block_size=B, use_pallas=False, **kw))


def _requests(rng, S, N, static):
    nb = -(-N // B)
    shape = (S,) if static else (S, nb)
    dirs = np.stack([rng.uniform(0, 360, shape), rng.uniform(-40, 90, shape)],
                    -1)
    return rng.standard_normal((S, N)), dirs


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dir_rate,out_length", [(1, "full"), (4, "same")])
def test_render_batch(tables, static, dir_rate, out_length):
    arrays, t = tables
    cfg, jcfg = _configs(dir_rate=dir_rate, out_length=out_length)
    S, N = 3, 1700
    xs, dirs = _requests(np.random.default_rng(dir_rate + 2 * static), S, N,
                         static)
    y = tinaural_torch.BinauralRenderer(t, cfg).render_batch(xs, dirs).numpy()
    out = N + (t.taps + 63 if out_length == "full" else 0)
    assert y.shape == (S, 2, out) and np.isfinite(y).all()
    theirs = np.asarray(JaxRenderer(arrays, jcfg).render_batch(xs, dirs))
    assert snr_db(theirs, y) >= 90
    nb = -(-N // B)
    for s in range(S):  # each request on its own: no tail crosses requests
        track = np.broadcast_to(dirs[s], (nb, 2)) if static else dirs[s]
        gold = golden.render_trajectory(arrays, xs[s], track, jcfg)
        assert snr_db(gold, y[s]) >= 80


def test_render_batch_single_block_requests(tables):
    """nb = 1: every request's block 0 takes its own filter as previous."""
    arrays, t = tables
    cfg, jcfg = _configs()
    xs, dirs = _requests(np.random.default_rng(5), 4, 200, False)
    y = tinaural_torch.BinauralRenderer(t, cfg).render_batch(xs, dirs).numpy()
    for s in range(4):
        gold = golden.render_trajectory(arrays, xs[s], dirs[s], jcfg)
        assert snr_db(gold, y[s]) >= 80


@pytest.mark.parametrize("N,out_length", [(1500, "full"), (1500, "same"),
                                          (5000, "full"), (5000, "same")])
def test_static_render(tables, N, out_length):
    """Below 8 blocks the direct FFT route, from 8 blocks the block route."""
    arrays, t = tables
    cfg, jcfg = _configs(out_length=out_length)
    x = np.random.default_rng(N).standard_normal(N)
    y = tinaural_torch.render(t, x, 123.4, 5.6, cfg).numpy()
    assert y.shape == (2, N + (t.taps + 63 if out_length == "full" else 0))
    assert np.isfinite(y).all()
    assert snr_db(np.asarray(JaxRenderer(arrays, jcfg).render(x, 123.4, 5.6)),
                  y) >= 90
    assert snr_db(golden.render_static(arrays, x, 123.4, 5.6, jcfg), y) >= 80


def test_static_routes_agree(tables):
    """The block route at 8 blocks equals the direct route one sample
    shorter, which stays below the threshold."""
    _, t = tables
    r = tinaural_torch.BinauralRenderer(t, tinaural_torch.RenderConfig(
        block_size=B, out_length="same"))
    x = np.random.default_rng(0).standard_normal(8 * B).astype(np.float32)
    x[-1] = 0.0
    blocks = r.render(x, 40.0, 10.0).numpy()
    direct = r.render(x[:-1], 40.0, 10.0).numpy()
    assert snr_db(blocks[:, :-1], direct) >= 100


@pytest.mark.parametrize("crossfade", [True, False])
def test_block_spectra_reference_matches_pallas_kernel(tables, crossfade):
    """The plain `block_spectra` (after the plain `assemble_filters`)
    against `fused_block_step` in interpret mode, read back through the
    JAX package's scrambled-half layout, across source boundaries."""
    from tinaural.models.renderer import _trajectory_spectra_scrambled
    from tinaural.ops.pallas_kernels import scramble_spectra

    arrays, t = tables
    jcfg = tinaural.RenderConfig(block_size=B, use_pallas=True,
                                 pallas_interpret=True, crossfade=crossfade)
    rng = np.random.default_rng(10 + crossfade)
    S, nb = 2, 5
    xbs = rng.standard_normal((S, nb, B)).astype(np.float32)
    dirs = rng.uniform(0, 360, (S, nb, 2)).astype(np.float32)
    Ysr, Ysi = _trajectory_spectra_scrambled(
        jax.device_put(arrays), jnp.asarray(xbs), jnp.asarray(dirs), jcfg)
    n_fft = _n_fft(t, B)
    idx, w = _neighbours(t, torch.from_numpy(dirs), tinaural_torch.RenderConfig())
    H = br.assemble_filters_reference(idx, w, t, n_fft, apply_itd=True,
                                      apply_ild=True)
    Y = bs.block_spectra_reference(torch.from_numpy(xbs), H, n_fft,
                                   crossfade=crossfade)
    assert Y.shape == (S, nb, 2, n_fft // 2 + 1)
    Rr, Ri = scramble_spectra(jnp.asarray(Y.numpy()), n_fft)
    assert snr_db(np.asarray(Ysr), np.asarray(Rr)) >= 90
    assert snr_db(np.asarray(Ysi), np.asarray(Ri)) >= 90


@pytest.mark.parametrize("S,nb", [(5, 7), (3, 1)])
def test_inverse_and_ola_match_fused_epilogue(S, nb):
    """`spectra_inverse` + the per-source `overlap_add`, plain, against
    `fused_epilogue` in interpret mode over flattened sources (its `first`
    masks): no OLA tail crosses a source."""
    from tinaural.models.renderer import _fused_ola_ears

    n_fft = 1024
    F = n_fft // 2 + 1
    rng = np.random.default_rng(S * 10 + nb)
    Y = (rng.standard_normal((S, nb, 2, F))
         + 1j * rng.standard_normal((S, nb, 2, F))).astype(np.complex64)
    Y[..., 0] = Y[..., 0].real  # valid rfft spectra: real endpoint bins
    Y[..., -1] = Y[..., -1].real
    theirs = np.asarray(_fused_ola_ears(
        jnp.asarray(Y), n_fft, B,
        tinaural.RenderConfig(block_size=B, use_pallas=True,
                              pallas_interpret=True)))
    frames = bs.spectra_inverse_reference(torch.from_numpy(Y), n_fft)
    ours = overlap_add(frames.transpose(1, 2), B).numpy()
    assert ours.shape == theirs.shape == (S, 2, (nb - 1) * B + n_fft)
    assert snr_db(theirs, ours) >= 100


def test_block_step_render_on_cpu_is_the_reference(tables):
    _, t = tables
    rng = np.random.default_rng(3)
    S, nb = 2, 4
    xbs = torch.from_numpy(rng.standard_normal((S, nb, B)).astype(np.float32))
    dirs = torch.from_numpy(rng.uniform(0, 90, (S, nb, 2)).astype(np.float32))
    idx, w = _neighbours(t, dirs, tinaural_torch.RenderConfig())
    flags = dict(crossfade=True, apply_itd=True, apply_ild=True)
    before = dict(bs.launches), dict(br.launches)
    y = bs.block_step_render(xbs, idx, w, t, 512, **flags)
    assert torch.equal(y, bs.block_step_render_reference(xbs, idx, w, t, 512,
                                                         **flags))
    assert (dict(bs.launches), dict(br.launches)) == before
    # one filter per source: the same as that filter on every block
    one = bs.block_step_render(xbs, idx[:, :1], w[:, :1], t, 512, **flags)
    every = bs.block_step_render(xbs, idx[:, :1].expand(S, nb, 4).contiguous(),
                                 w[:, :1].expand(S, nb, 4).contiguous(), t,
                                 512, **flags)
    assert snr_db(every.numpy(), one.numpy()) >= 110


def test_block_step_render_rejects_bad_inputs(tables):
    _, t = tables
    xbs = torch.zeros((2, 4, B))
    idx, w = _neighbours(t, torch.zeros((2, 4, 2)), tinaural_torch.RenderConfig())
    flags = dict(crossfade=True, apply_itd=True, apply_ild=True)
    with pytest.raises(ValueError):
        bs.block_step_render(xbs, idx[:, :2], w[:, :2], t, 512, **flags)
    with pytest.raises(TypeError):
        bs.block_step_render(xbs, idx.long(), w, t, 512, **flags)
    with pytest.raises(ValueError):
        bs.block_step_render(xbs, idx, w, t, 256, **flags)  # too short
    with pytest.raises(ValueError):
        bs.block_step_render(xbs.to("meta"), idx, w, t, 512, **flags)


@pytest.mark.parametrize("call", [
    lambda r: r.render_batch(np.zeros(600), np.zeros((1, 2))),
    lambda r: r.render_batch(np.zeros((2, 600)), np.zeros((2, 4, 2))),
    lambda r: r.render_batch(np.zeros((2, 600)), np.zeros((3, 2))),
    lambda r: r.render_batch(np.zeros((2, 600)), np.zeros((2, 3, 3))),
    lambda r: r.render(np.zeros((2, 600)), 0.0, 0.0),
])
def test_shape_errors_match_jax(tables, call):
    arrays, t = tables
    cfg, jcfg = _configs()
    with pytest.raises(ValueError):
        call(JaxRenderer(arrays, jcfg))
    with pytest.raises(ValueError):
        call(tinaural_torch.BinauralRenderer(t, cfg))


def test_render_batch_broadcasts_one_static_direction(tables):
    """A (1, 2) static direction serves every request, as in the JAX
    package."""
    _, t = tables
    r = tinaural_torch.BinauralRenderer(t, tinaural_torch.RenderConfig(block_size=B))
    xs = np.random.default_rng(4).standard_normal((3, 700))
    one = r.render_batch(xs, np.array([[30.0, 10.0]]))
    each = r.render_batch(xs, np.tile([[30.0, 10.0]], (3, 1)))
    assert torch.equal(one, each)


def test_buffer_mode_follows_the_shapes():
    """Shared memory up to the H100's 227 KB per block, the split mode
    above; the issue's large shapes all split, the main path's do not."""
    limit = 232448
    # assemble_filters at 128 taps, B = 1024 (n_fft 2048, L 256)
    assert _layout.split_work(1024 + 2048 + 512, 2048, limit) == 0
    # assemble_filters at 16,384 taps, B = 1024 (n_fft = L = 32768)
    assert _layout.split_work(16384 + 32768 + 65536, 32768,
                              limit) == _layout.SPLIT_WORK
    # assemble_partitions at 44,100 taps, B = 512 (L = 65536)
    assert _layout.split_work(32768 + 131072 + 1024, 65536,
                              limit) == _layout.SPLIT_WORK
    # partitioned_conv at stream_block 4096: (9·B + 4) complex64; 2048 fits
    assert _layout.split_work(9 * 4096 + 4, 8192, limit) == _layout.SPLIT_WORK
    assert _layout.split_work(9 * 2048 + 4, 4096, limit) == 0
    with pytest.raises(ValueError):
        _layout.split_work(1 << 26, 1 << 25, limit)


def test_forced_split_work(monkeypatch):
    monkeypatch.setattr(_layout, "force_work", 64)
    assert _layout.split_work(100, 4096, 232448) == 64
    with pytest.raises(ValueError):
        _layout.split_work(100, 8192, 232448)

"""tinaural_torch's scene-mixdown route — the plain `block_spectra_mix` and
`scene_step_render`, and the scene cores on it — against tinaural (its
plain jnp spectra and renders) and the float64 golden oracle, on the same
numpy inputs from a seed."""

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
from tinaural_torch.models.renderer import (_n_fft, _neighbours,
                                            _scene_core, _scene_mixes,
                                            _scene_static_core)
from tinaural_torch.ops import _layout
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops import block_step as bs

torch.set_num_threads(1)

B = 256


@pytest.fixture(scope="module")
def tables():
    arrays = tinaural.load_hrir_set("synthetic")
    return arrays, TorchTable.from_hrir_table(arrays, "cpu")


def _cplanes(z):
    z = np.asarray(z)
    return np.stack([z.real, z.imag])


@pytest.mark.parametrize("crossfade,chunk", [(True, 2), (False, 3)])
def test_block_spectra_mix_reference_matches_jax_spectra(tables, crossfade,
                                                         chunk):
    """Σ over the partials == Σ_s of the JAX package's per-source block
    spectra (`_trajectory_spectra_xla`, use_pallas=False), S = 3, nb = 5."""
    from tinaural.models.renderer import _trajectory_spectra_xla

    arrays, t = tables
    S, nb = 3, 5
    rng = np.random.default_rng(20 + chunk)
    xbs = rng.standard_normal((S, nb, B)).astype(np.float32)
    dirs = np.stack([rng.uniform(0, 360, (S, nb)),
                     rng.uniform(-40, 90, (S, nb))], -1).astype(np.float32)
    jcfg = tinaural.RenderConfig(block_size=B, use_pallas=False,
                                 crossfade=crossfade)
    tbl = jax.device_put(arrays)
    theirs = np.asarray(jax.jit(jax.vmap(
        lambda x, d: _trajectory_spectra_xla(tbl, x, d, jcfg)))(
            jnp.asarray(xbs), jnp.asarray(dirs))).sum(0)
    n_fft = _n_fft(t, B)
    idx, w = _neighbours(t, torch.from_numpy(dirs),
                         tinaural_torch.RenderConfig())
    H = br.assemble_filters_reference(idx, w, t, n_fft, apply_itd=True,
                                      apply_ild=True)
    P = bs.block_spectra_mix_reference(torch.from_numpy(xbs), H, n_fft,
                                       crossfade=crossfade, chunk=chunk)
    assert P.shape == (-(-S // chunk), nb, 2, n_fft // 2 + 1)
    assert snr_db(_cplanes(theirs), _cplanes(P.sum(0).numpy())) >= 100


def test_block_spectra_mix_reference_one_filter_per_source(tables):
    """One filter per source (the static scene) == Σ_s of the JAX
    package's `_static_block_spectra`."""
    from tinaural.models.renderer import _static_block_spectra

    arrays, t = tables
    S, nb = 3, 5
    rng = np.random.default_rng(31)
    xbs = rng.standard_normal((S, nb, B)).astype(np.float32)
    dirs = np.stack([rng.uniform(0, 360, S), rng.uniform(-40, 90, S)],
                    -1).astype(np.float32)
    jcfg = tinaural.RenderConfig(block_size=B, use_pallas=False)
    tbl = jax.device_put(arrays)
    theirs = np.asarray(jax.jit(jax.vmap(
        lambda x, d: _static_block_spectra(tbl, x, d, jcfg)))(
            jnp.asarray(xbs), jnp.asarray(dirs))).sum(0)
    n_fft = _n_fft(t, B)
    idx, w = _neighbours(t, torch.from_numpy(dirs[:, None]),
                         tinaural_torch.RenderConfig())
    assert idx.shape == (S, 1, 4)
    H = br.assemble_filters_reference(idx, w, t, n_fft, apply_itd=True,
                                      apply_ild=True)
    P = bs.block_spectra_mix_reference(torch.from_numpy(xbs), H, n_fft,
                                       crossfade=False, chunk=2)
    assert snr_db(_cplanes(theirs), _cplanes(P.sum(0).numpy())) >= 100


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("crossfade", [True, False])
def test_scene_cores_on_the_mix_route(tables, static, crossfade):
    """The scene cores through the mixdown route's plain version against
    B1's plain route, the JAX package's `render_scene` (use_pallas=False)
    and golden `render_scene`."""
    arrays, t = tables
    cfg = tinaural_torch.RenderConfig(block_size=B, crossfade=crossfade)
    jcfg = tinaural.RenderConfig(block_size=B, use_pallas=False,
                                 crossfade=crossfade)
    rng = np.random.default_rng(40 + 2 * static + crossfade)
    S, N = 4, 1500
    nb = -(-N // B)
    shape = (S,) if static else (S, nb)
    dirs = np.stack([rng.uniform(0, 360, shape), rng.uniform(-40, 90, shape)],
                    -1).astype(np.float32)
    xs = rng.standard_normal((S, N)).astype(np.float32)
    xbs = torch.from_numpy(np.pad(xs, [(0, 0), (0, nb * B - N)]).reshape(
        S, nb, B))
    core = _scene_static_core if static else _scene_core
    ours = core(t, xbs, torch.from_numpy(dirs), cfg,
                render=bs.scene_step_render)[:, : N + t.taps + 63].numpy()
    b1 = core(t, xbs, torch.from_numpy(dirs), cfg,
              render=br.block_render)[:, : N + t.taps + 63].numpy()
    assert snr_db(b1, ours) >= 110
    theirs = np.asarray(JaxRenderer(arrays, jcfg).render_scene(
        xs, dirs, dedupe=False))
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    assert snr_db(theirs, ours) >= 90
    assert snr_db(golden.render_scene(arrays, xs, dirs, jcfg), ours) >= 80


def test_render_scene_takes_the_mix_route(tables):
    """Through the public entry point: a static scene on the CPU runs the
    mixdown route's plain version and launches nothing."""
    arrays, t = tables
    cfg = tinaural_torch.RenderConfig(block_size=B)
    rng = np.random.default_rng(50)
    xs = rng.standard_normal((5, 900))
    dirs = np.stack([rng.uniform(0, 360, 5), rng.uniform(-40, 90, 5)], -1)
    before = dict(bs.launches), dict(br.launches)
    y = tinaural_torch.render_scene(t, xs, dirs, cfg, dedupe=False).numpy()
    assert (dict(bs.launches), dict(br.launches)) == before
    assert snr_db(golden.render_scene(arrays, xs, dirs, tinaural.RenderConfig(
        block_size=B)), y) >= 80


def test_scene_step_render_on_cpu_is_the_reference(tables):
    _, t = tables
    rng = np.random.default_rng(3)
    xbs = torch.from_numpy(rng.standard_normal((3, 4, B)).astype(np.float32))
    idx, w = _neighbours(t, torch.from_numpy(rng.uniform(
        0, 90, (3, 4, 2)).astype(np.float32)), tinaural_torch.RenderConfig())
    kw = dict(crossfade=True, apply_itd=True, apply_ild=True)
    assert torch.equal(bs.scene_step_render(xbs, idx, w, t, 512, **kw),
                       bs.scene_step_render_reference(xbs, idx, w, t, 512,
                                                      **kw))
    with pytest.raises(ValueError):
        bs.scene_step_render(xbs, idx[:, :2], w[:, :2], t, 512, **kw)
    with pytest.raises(ValueError):
        bs.scene_step_render(xbs, idx, w, t, 256, **kw)  # too short
    with pytest.raises(ValueError):
        bs.scene_step_render(xbs.to("meta"), idx, w, t, 512, **kw)


def test_scene_route_rule():
    """Static scenes always mix (one filter per source); moving scenes of
    several sources mix below the SM count; off the card (0 SMs) moving
    scenes take B1."""
    sms = 132
    assert _scene_mixes(64, 128, False, sms)        # (b): 128 blocks < 132
    assert not _scene_mixes(16, 1024, False, sms)   # (m): 1024 blocks
    assert not _scene_mixes(64, 132, False, sms)
    assert not _scene_mixes(1, 8, False, sms)       # one source: a trajectory
    assert _scene_mixes(64, 128, True, sms)         # (c)
    assert _scene_mixes(1, 4096, True, sms)
    assert not _scene_mixes(64, 128, False, 0)
    assert _scene_mixes(64, 128, True, 0)


def test_mix_chunk_rule():
    """Enough chunks of sources that the (chunk, block) grid holds
    MIX_BLOCKS_PER_SM CUDA blocks per SM, sources spread evenly."""
    assert bs.MIX_BLOCKS_PER_SM == 8
    assert bs.mix_chunk(64, 128, 132) == 8     # (b), (c): 8 chunks, 1024 blocks
    assert bs.mix_chunk(64, 16, 132) == 1      # 64 chunks of one source
    assert bs.mix_chunk(3, 5, 132) == 1
    assert bs.mix_chunk(64, 4096, 132) == 64   # one chunk: 4096 blocks
    assert bs.mix_chunk(10, 300, 132) == 3     # 4 chunks (3, 3, 3, 1)
    assert bs.mix_chunk(64, 128, 0) == 64


def test_mix_buffer_mode():
    """block_spectra_mix holds the twiddles, the FFT buffer and two ears'
    accumulators (n_fft/2 + n_fft + 2F complex64): shared memory up to
    n_fft 8192, the split mode above."""
    limit = 232448

    def shared(n_fft):
        return n_fft // 2 + n_fft + 2 * (n_fft // 2 + 1)

    assert _layout.split_work(shared(2048), 2048, limit) == 0
    assert _layout.split_work(shared(8192), 8192, limit) == 0
    assert _layout.split_work(shared(16384), 16384,
                              limit) == _layout.SPLIT_WORK

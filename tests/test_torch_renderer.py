"""tinaural_torch's renderers against tinaural's (plain jnp route) and the
float64 golden oracle, on the same table, signals and directions."""

import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from conftest import snr_db
from tinaural.models.renderer import BinauralRenderer as JaxRenderer
from tinaural.reference import golden
from tinaural_torch.data import TorchTable

torch.set_num_threads(1)

B = 256


@pytest.fixture(scope="module")
def tables():
    arrays = tinaural.load_hrir_set("synthetic")
    return arrays, TorchTable.from_hrir_table(arrays, "cpu")


def _configs(**kw):
    return (tinaural_torch.RenderConfig(block_size=B, **kw),
            tinaural.RenderConfig(block_size=B, use_pallas=False, **kw))


def _check(ours, jax_out, gold):
    ours = ours.numpy()
    assert ours.shape == np.asarray(jax_out).shape == gold.shape
    assert np.isfinite(ours).all()
    assert snr_db(jax_out, ours) >= 90
    assert snr_db(gold, ours) >= 80


@pytest.mark.parametrize("dir_rate,out_length,crossfade", [
    (1, "full", True), (4, "full", True), (1, "same", True), (4, "same", False)])
def test_trajectory(tables, dir_rate, out_length, crossfade):
    arrays, t = tables
    cfg, jcfg = _configs(dir_rate=dir_rate, out_length=out_length,
                         crossfade=crossfade)
    rng = np.random.default_rng(dir_rate)
    N = 3000
    x = rng.standard_normal(N)
    nb = -(-N // B)
    dirs = np.stack([np.linspace(0, 300, nb), np.linspace(-30, 60, nb)], 1)
    y = tinaural_torch.render_trajectory(t, x, dirs, cfg)
    assert y.shape == (2, N + (t.taps + 64 - 1 if out_length == "full" else 0))
    _check(y, JaxRenderer(arrays, jcfg).render_trajectory(x, dirs),
           golden.render_trajectory(arrays, x, dirs, jcfg))


def _scene(rng, S, N, n_tracks, static):
    nb = -(-N // B)
    shape = (n_tracks,) if static else (n_tracks, nb)
    tracks = np.stack([rng.uniform(0, 360, shape),
                       rng.uniform(-40, 90, shape)], -1)
    dirs = tracks[np.arange(S) % n_tracks]  # sources share tracks
    return rng.standard_normal((S, N)), dirs


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dedupe", [True, False])
def test_scene(tables, static, dedupe):
    arrays, t = tables
    dir_rate = 1 if static else 4
    cfg, jcfg = _configs(dir_rate=dir_rate, scene_chunk=2)
    xs, dirs = _scene(np.random.default_rng(7), 6, 1500, 2, static)
    r = tinaural_torch.BinauralRenderer(t, cfg)
    y = r.render_scene(xs, dirs, dedupe=dedupe)
    _check(y, JaxRenderer(arrays, jcfg).render_scene(xs, dirs, dedupe=dedupe),
           golden.render_scene(arrays, xs, dirs, jcfg))


def test_scene_distinct_moving_sources(tables):
    arrays, t = tables
    cfg, jcfg = _configs()
    xs, dirs = _scene(np.random.default_rng(8), 5, 2000, 5, False)
    y = tinaural_torch.render_scene(t, xs, dirs, cfg)
    _check(y, JaxRenderer(arrays, jcfg).render_scene(xs, dirs),
           golden.render_scene(arrays, xs, dirs, jcfg))


def test_scene_equals_sum_of_trajectories(tables):
    _, t = tables
    cfg = tinaural_torch.RenderConfig(block_size=B)
    xs, dirs = _scene(np.random.default_rng(9), 3, 1200, 3, False)
    r = tinaural_torch.BinauralRenderer(t, cfg)
    mix = r.render_scene(xs, dirs).numpy()
    parts = sum(r.render_trajectory(x, d).numpy() for x, d in zip(xs, dirs))
    assert snr_db(parts, mix) >= 110


def test_raw_table_nearest(tables):
    raw = tinaural.load_hrir_set("synthetic", decompose=False)
    cfg, jcfg = _configs(interp="nearest")
    rng = np.random.default_rng(11)
    x = rng.standard_normal(2000)
    dirs = np.stack([rng.uniform(0, 360, 8), rng.uniform(-40, 90, 8)], 1)
    y = tinaural_torch.render_trajectory(
        TorchTable.from_hrir_table(raw, "cpu"), x, dirs, cfg)
    _check(y, JaxRenderer(raw, jcfg).render_trajectory(x, dirs),
           golden.render_trajectory(raw, x, dirs, jcfg))


def test_renderer_rejects_bad_shapes(tables):
    arrays, t = tables
    r = tinaural_torch.BinauralRenderer(t, tinaural_torch.RenderConfig(block_size=B))
    with pytest.raises(ValueError):
        r.render_trajectory(np.zeros((2, 512)), np.zeros((2, 2)))
    with pytest.raises(ValueError):
        r.render_trajectory(np.zeros(600), np.zeros((2, 2)))  # needs 3 blocks
    with pytest.raises(ValueError):
        r.render_scene(np.zeros((3, 512)), np.zeros((2, 2)))
    with pytest.raises(TypeError):
        tinaural_torch.BinauralRenderer(arrays)

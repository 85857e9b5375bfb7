"""tinaural_torch.reference.golden, the numpy copy that the CLI's
``--cpu-golden`` renders with, equal in bits to tinaural.reference.golden
on every function the CLI calls."""

import numpy as np
import pytest

import tinaural
import tinaural_torch
from tinaural.config import RenderConfig as JaxConfig
from tinaural.reference import golden as jax_golden
from tinaural_torch.reference import golden

CONFIGS = {
    "default": {},
    "nearest_no_itd": dict(interp="nearest", apply_itd=False),
    "no_ild_same_length": dict(apply_ild=False, out_length="same"),
    "dir_rate_2_no_crossfade": dict(dir_rate=2, crossfade=False),
}


@pytest.fixture(scope="module")
def tables():
    return {dec: (tinaural_torch.load_hrir_set("synthetic", decompose=dec),
                  tinaural.load_hrir_set("synthetic", decompose=dec))
            for dec in (True, False)}


def _configs(name, **extra):
    kw = {**CONFIGS[name], "block_size": 256, "stream_block": 128, **extra}
    return tinaural_torch.RenderConfig(**kw), JaxConfig(**kw)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("decompose", [True, False])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_static_bit_equal(tables, name, decompose):
    ours, theirs = tables[decompose]
    cfg, jcfg = _configs(name)
    x = np.random.default_rng(1).standard_normal(1500)
    _same(golden.render_static(ours, x, 123.4, 5.6, cfg),
          jax_golden.render_static(theirs, x, 123.4, 5.6, jcfg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_trajectory_bit_equal(tables, name):
    ours, theirs = tables[True]
    cfg, jcfg = _configs(name)
    x = np.random.default_rng(2).standard_normal(1500)
    nb = -(-1500 // 256)
    dirs = np.stack([np.linspace(300, 420, nb) % 360,
                     np.linspace(-30, 60, nb)], 1)
    _same(golden.render_trajectory(ours, x, dirs, cfg),
          jax_golden.render_trajectory(theirs, x, dirs, jcfg))


@pytest.mark.parametrize("moving", [False, True])
def test_render_scene_bit_equal(tables, moving):
    ours, theirs = tables[True]
    cfg, jcfg = _configs("default")
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2, 700))
    shape = (2, 3, 2) if moving else (2, 2)
    dirs = np.stack([rng.uniform(0, 360, shape[:-1]),
                     rng.uniform(-40, 90, shape[:-1])], -1)
    _same(golden.render_scene(ours, xs, dirs, cfg),
          jax_golden.render_scene(theirs, xs, dirs, jcfg))


@pytest.mark.parametrize("update_rate", [1, 4])
@pytest.mark.parametrize("name", ["default", "nearest_no_itd"])
def test_golden_stream_bit_equal(tables, name, update_rate):
    """The CLI's stream loop: push at multiples of the update rate,
    push_held between."""
    ours, theirs = tables[True]
    cfg, jcfg = _configs(name)
    a, b = golden.GoldenStream(ours, cfg), jax_golden.GoldenStream(theirs, jcfg)
    x = np.random.default_rng(4).standard_normal((10, 128))
    for i, xb in enumerate(x):
        if i % update_rate == 0:
            az = 300.0 + 12.5 * i
            _same(a.push(xb, az, 10.0), b.push(xb, az, 10.0))
        else:
            _same(a.push_held(xb), b.push_held(xb))
    _same(a.fdl, b.fdl)
    with pytest.raises(ValueError, match="push_held before any push"):
        golden.GoldenStream(ours, cfg).push_held(x[0])

"""The benchmark's frozen reference against the program's own copies at
small sizes: the head model, the grid and the decomposition equal in bits,
and the vectorised maps of `reference/fast.py` within float64 rounding of
`tinaural_torch.reference.golden`. Only this test imports both; a run's
reference imports nothing of the program."""

import numpy as np
import pytest
import torch

from benchmark.reference import fast, synthetic
from benchmark.reference import table as rtable
from tinaural_torch import RenderConfig
from tinaural_torch.data import grids as pgrids
from tinaural_torch.data import synthetic as psynthetic
from tinaural_torch.data import table as ptable
from tinaural_torch.reference import golden as pgolden

TAPS = 96


@pytest.fixture(scope="module")
def raw():
    h, grid = synthetic.synthesize_hrirs(taps=TAPS, seed=2**31 + 3)
    return h, grid


@pytest.fixture(scope="module")
def tab(raw):
    return rtable.build(raw[0], raw[1], 44100)


def test_grid_and_head_model_equal(raw):
    h, grid = raw
    ph, pgrid = psynthetic.synthesize_hrirs(taps=TAPS, seed=2**31 + 3)
    assert np.array_equal(h, ph)
    assert np.array_equal(grid.validity_mask(), pgrids.kemar_grid().validity_mask())
    assert np.array_equal(grid.elevs, pgrid.elevs)


def test_decomposition_equal(raw, tab):
    h, grid = raw
    prog = ptable.build_table(h, pgrids.kemar_grid(), 44100)
    assert np.array_equal(tab.h.astype(np.float32), prog.h)
    assert np.array_equal(tab.delays.astype(np.float32), prog.delays)
    assert np.array_equal(tab.gains.astype(np.float32), prog.gains)
    shift = np.linspace(-3.3, 40.7, 7)
    assert np.array_equal(rtable.delay_ramp(256, shift),
                          ptable.delay_ramp(256, shift))


def _dirs(rng, n):
    return np.stack([rng.uniform(0, 360, n), rng.uniform(-45, 95, n)], -1)


@pytest.mark.parametrize("crossfade, dir_rate", [(True, 1), (False, 2)])
def test_fast_render_equals_golden(tab, crossfade, dir_rate):
    rng = np.random.default_rng(1)
    B, N = 128, 128 * 9 + 5
    nb = -(-N // B)
    cfg = fast.Config(block_size=B, crossfade=crossfade, dir_rate=dir_rate)
    pcfg = RenderConfig(block_size=B, crossfade=crossfade, dir_rate=dir_rate)
    x = rng.standard_normal((3, N))
    d = np.stack([_dirs(rng, nb) for _ in range(3)])
    g = pgolden.render_trajectory(tab, x[0], d[0], pcfg)
    s = pgolden.render_scene(tab, x, d, pcfg)
    dt = fast.device_table(tab, "cpu")
    f = fast.render(dt, x, d, cfg).numpy()
    assert f.shape == s.shape
    assert np.abs(f - s).max() <= 1e-12 * np.abs(s).max()
    f1 = fast.render(dt, x[:1], d[:1], cfg).numpy()
    assert np.abs(f1 - g).max() <= 1e-12 * np.abs(g).max()


def test_weights_equal_golden(tab):
    rng = np.random.default_rng(3)
    d = np.concatenate([_dirs(rng, 200), [[0.0, 90.0], [359.999, -40.0],
                                          [360.0, 0.0], [-10.0, 95.0]]])
    rows, w = fast.weights(fast.device_table(tab, "cpu"), torch.from_numpy(d))
    A = tab.h.shape[1]
    for k, (az, el) in enumerate(d):
        idx, wg = pgolden.grid_weights(tab.elevs, tab.az_counts, az, el,
                                       "bilinear")
        assert np.array_equal(rows[k].numpy(), idx[:, 0] * A + idx[:, 1])
        assert np.allclose(w[k].numpy(), wg, rtol=0, atol=1e-15)


def test_control_is_coarser(tab):
    """The control rounds every stage to bfloat16: far off the float64
    map, and its stages hold bfloat16 values."""
    rng = np.random.default_rng(4)
    B, N = 128, 128 * 6
    cfg = fast.Config(block_size=B)
    x = rng.standard_normal((1, N))
    d = _dirs(rng, 6)[None]
    ref = fast.render(fast.device_table(tab, "cpu"), x, d, cfg)
    ctl = fast.render(fast.device_table(tab, "cpu", fast.BFLOAT16), x, d, cfg)
    assert ctl.dtype == torch.float32
    assert torch.equal(ctl, ctl.to(torch.bfloat16).to(torch.float32))
    err = float((ctl.double() - ref).abs().max() / ref.abs().max())
    assert err > 1e-3

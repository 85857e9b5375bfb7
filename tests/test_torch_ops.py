"""tinaural_torch's ops against their JAX counterparts on shared inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from conftest import snr_db
from tinaural.ops import filters as jf
from tinaural.ops import interp as ji
from tinaural.ops import ola as jo
from tinaural.reference import golden
from tinaural_torch.data import TorchTable
from tinaural_torch.ops import filters as tf
from tinaural_torch.ops import interp as ti
from tinaural_torch.ops import ola as to

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    """The JAX package's table (for its functions and the golden oracle)
    and the same table carried across to torch."""
    arrays = tinaural.load_hrir_set("synthetic")
    return arrays, TorchTable.from_hrir_table(arrays, "cpu")


def _directions(rng, n):
    """Random directions plus the 0/360 seam, ring edges and both poles."""
    az = rng.uniform(-400, 800, n)
    el = rng.uniform(-60, 100, n)
    edge_az = np.array([0.0, 360.0, -1e-4, 359.9999, 720.0, 5.0, 355.0, 180.0])
    edge_el = np.array([90.0, 89.9, -40.0, -45.0, 95.0, 80.0, 0.0, 10.0])
    return (np.concatenate([az, edge_az]).astype(np.float32),
            np.concatenate([el, edge_el]).astype(np.float32))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_direction_weights_match_jax(tables, mode):
    """The rows are the JAX package's. The weights are the golden map's
    float64 ones within float32 rounding: the port takes the slot position
    az·c/360 in float64, where the JAX package's float32 product misses by
    up to 5e-6 at these directions."""
    arrays, t = tables
    az, el = _directions(np.random.default_rng(0), 400)
    je, ja, jw = jax.vmap(lambda a, e: ji.direction_weights(
        jnp.asarray(arrays.elevs), jnp.asarray(arrays.az_counts), a, e,
        mode))(jnp.asarray(az), jnp.asarray(el))
    te, ta, tw = ti.direction_weights(t.elevs, t.az_counts,
                                      torch.from_numpy(az),
                                      torch.from_numpy(el), mode)
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    gw = np.array([golden.grid_weights(
        np.asarray(arrays.elevs, np.float64), arrays.az_counts, float(a),
        float(e), mode)[1] for a, e in zip(az, el)])
    np.testing.assert_allclose(tw.numpy(), gw, rtol=0, atol=2e-7)
    np.testing.assert_allclose(tw.numpy().sum(-1), 1.0, atol=1e-6)


def test_direction_weights_single_ring():
    elevs = torch.tensor([0.0])
    counts = torch.tensor([8], dtype=torch.int32)
    az = torch.tensor([0.0, 22.5, 359.0, -10.0])
    el = torch.tensor([0.0, 30.0, -30.0, 0.0])
    je, ja, jw = jax.vmap(lambda a, e: ji.direction_weights(
        jnp.asarray(elevs.numpy()), jnp.asarray(counts.numpy()), a, e,
        "bilinear"))(jnp.asarray(az.numpy()), jnp.asarray(el.numpy()))
    te, ta, tw = ti.direction_weights(elevs, counts, az, el, "bilinear")
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_interpolate_matches_golden(tables, interp):
    arrays, t = tables
    cfg = tinaural_torch.RenderConfig(interp=interp)
    az, el = _directions(np.random.default_rng(1), 50)
    h, d, g = ti.interpolate(t, torch.from_numpy(az), torch.from_numpy(el), cfg)
    for i in range(len(az)):
        hr, dr, gr = golden.interpolate(arrays, az[i], el[i], cfg)
        np.testing.assert_allclose(h[i].numpy(), hr, atol=1e-6)
        np.testing.assert_allclose(d[i].numpy(), dr, atol=1e-4)
        np.testing.assert_allclose(g[i].numpy(), gr, atol=1e-6)


def test_delay_ramp_matches_jax():
    # Shifts span the render clip [-8, 48]. Both sides evaluate the same
    # float32 phase θ·⌊d⌋ + … with another operation order (XLA contracts
    # into fused multiply-adds), so they may differ by two ulps of the
    # phase: the tolerance is 1e-5, or that where it is larger (phases
    # above 64 rad). Exact half-integer fractions sit on the Nyquist bin's
    # sign flip and are left out.
    d = np.random.default_rng(2).uniform(-8, 48, 500).astype(np.float32)
    d = np.concatenate([d, np.arange(-8, 49, dtype=np.float32)])
    for n in (256, 512, 2048):
        ours = tf.delay_ramp(n, torch.from_numpy(d)).numpy()
        theirs = np.asarray(jf.delay_ramp(n, jnp.asarray(d)))
        fnorm = np.arange(n // 2 + 1) / n
        phase = (2 * np.pi * fnorm * np.abs(np.floor(d))[:, None] + np.pi)
        tol = np.maximum(1e-5, 2 * np.spacing(phase.astype(np.float32)))
        assert np.all(np.abs(ours - theirs) <= tol)


def _gathered(t, n, seed):
    rng = np.random.default_rng(seed)
    az = torch.from_numpy(rng.uniform(0, 360, n).astype(np.float32))
    el = torch.from_numpy(rng.uniform(-40, 90, n).astype(np.float32))
    cfg = tinaural_torch.RenderConfig()
    return az, el, ti.interpolate(t, az, el, cfg)


@pytest.mark.parametrize("n_fft", [512, 2048])
def test_filter_spectrum_mm_matches_golden(tables, n_fft):
    arrays, t = tables
    az, el, (h, d, g) = _gathered(t, 40, 3)
    ri = lambda z: np.stack([z.real, z.imag])
    H = tf.filter_spectrum_mm(h, d, g, t.taps, n_fft).numpy()
    ref = np.stack([np.fft.rfft(golden.direction_filter(
        arrays, float(a), float(e), tinaural.RenderConfig()), n_fft)
        for a, e in zip(az, el)])
    assert snr_db(ri(ref), ri(H)) >= 100
    H64 = tf.filter_spectrum_mm(h.double(), d.double(), g.double(), t.taps,
                                n_fft).numpy()
    assert snr_db(ri(ref), ri(H64)) >= 100


def test_effective_filter_matches_golden(tables):
    arrays, t = tables
    az, el, (h, d, g) = _gathered(t, 40, 4)
    ours = tf.effective_filter(h, d, g, t.taps).numpy()
    ref = np.stack([golden.direction_filter(arrays, float(a), float(e),
                                            tinaural.RenderConfig())
                    for a, e in zip(az, el)])
    assert ours.shape == ref.shape
    assert snr_db(ref, ours) >= 100


@pytest.mark.parametrize("nb,hop,n_fft", [(7, 256, 512), (5, 128, 512),
                                          (3, 512, 512)])
def test_overlap_add_exact(nb, hop, n_fft):
    blocks = np.random.default_rng(5).standard_normal((2, nb, n_fft)).astype(np.float32)
    ours = to.overlap_add(torch.from_numpy(blocks), hop).numpy()
    theirs = np.asarray(jo.overlap_add(jnp.asarray(blocks), hop))
    assert ours.shape == theirs.shape == (2, (nb - 1) * hop + n_fft)
    assert np.array_equal(ours, theirs)

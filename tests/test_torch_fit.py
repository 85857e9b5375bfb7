"""tinaural_torch.models.fit against tinaural.models.fit (JAX on the CPU).

The same seeded inputs go through both packages' personalization, loss,
gradients and Adam loop; the JAX package's parameters carry across with
`FitParams.from_numpy`. Block 256, two sources of 768 samples.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch as tt
from tinaural.config import RenderConfig as JaxConfig
from tinaural.models import BinauralRenderer as JaxRenderer
from tinaural.models import fit as jfit
from tinaural.ops import filters as jfilters
from tinaural_torch.data.table import TAPER_HI, TAPER_LO
from tinaural_torch.models import fit as tfit
from tinaural_torch.ops import filters as tfilters

from conftest import snr_db

torch.set_num_threads(1)

B = 256
JCFG = JaxConfig(block_size=B)
TCFG = tt.RenderConfig(block_size=B)


@pytest.fixture(scope="module")
def tables():
    jt = tinaural.load_hrir_set("synthetic")
    return jax.device_put(jt), tt.TorchTable.from_hrir_table(jt, "cpu")


def _scene(seed, S=2, N=768):
    """xs (S, N), static dirs (S, 2), and the blocked xbs (S, nb, B) and
    per-block dirs (S, nb, 2) the loss takes."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((S, N)).astype(np.float32)
    dirs = np.stack([rng.uniform(0, 360, S), rng.uniform(-40, 90, S)], axis=1)
    nb = -(-N // B)
    xbs = np.pad(xs, [(0, 0), (0, nb * B - N)]).reshape(S, nb, B)
    dirs_b = np.ascontiguousarray(np.broadcast_to(
        dirs[:, None, :], (S, nb, 2)).astype(np.float32))
    return xs, dirs, xbs, dirs_b


def _random_params(seed):
    rng = np.random.default_rng(seed)
    return jfit.FitParams(
        ear_eq_log=jnp.asarray(rng.normal(0, 0.3, (2, 8)), jnp.float32),
        itd_scale_log=jnp.float32(rng.normal(0, 0.2)),
        ild_scale_log=jnp.float32(rng.normal(0, 0.2)),
        gain_log=jnp.float32(rng.normal(0, 0.2)))


PARAMS = {"identity": lambda: jfit.init_params(),
          "random": lambda: _random_params(5)}


def _target(jt, xs, dirs):
    """The JAX render of a table perturbed in every parameter."""
    true = jfit.init_params()._replace(
        itd_scale_log=jnp.float32(0.2), ild_scale_log=jnp.float32(0.3),
        gain_log=jnp.float32(0.1))
    ttab = jax.tree.map(np.asarray, jfit.personalize_table(jt, true))
    return np.array(JaxRenderer(ttab, JCFG).render_scene(xs, dirs),
                    np.float32)


def _leaves(params):
    return tfit.FitParams(*(p.requires_grad_() for p in params))


@pytest.mark.parametrize("which", sorted(PARAMS))
def test_personalize_table_matches_jax(tables, which):
    jt, t = tables
    jp = PARAMS[which]()
    want = jfit.personalize_table(jt, jp)
    got = tfit.personalize_table(t, tfit.FitParams.from_numpy(jp, "cpu"))
    assert isinstance(got, tt.TorchTable) and got is not t
    assert snr_db(np.asarray(want.h), got.h.numpy()) >= 100
    np.testing.assert_allclose(got.delays.numpy(), np.asarray(want.delays),
                               rtol=1e-5)
    np.testing.assert_allclose(got.gains.numpy(), np.asarray(want.gains),
                               rtol=1e-5)
    for f in ("elevs", "az_counts", "valid"):  # carried unchanged
        assert getattr(got, f) is getattr(t, f)


@pytest.mark.parametrize("which", sorted(PARAMS))
def test_scene_loss_and_gradients_match_jax(tables, which):
    """The loss to rtol 1e-5, and every leaf of its gradient, each
    non-zero, to a relative L2 error ≤ 1e-3 of `jax.grad`'s."""
    jt, t = tables
    xs, dirs, xbs, dirs_b = _scene(7)
    target = _target(jt, xs, dirs)
    jp = PARAMS[which]()
    lj, gj = jax.value_and_grad(jfit.scene_loss)(
        jp, jt, jnp.asarray(xbs), jnp.asarray(dirs_b), jnp.asarray(target),
        JCFG)
    tp = _leaves(tfit.FitParams.from_numpy(jp, "cpu"))
    lt = tfit.scene_loss(tp, t, torch.from_numpy(xbs), torch.from_numpy(dirs_b),
                         torch.from_numpy(target), TCFG)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for name, want, p in zip(tfit.FitParams._fields, gj, tp):
        want = np.asarray(want, np.float64)
        got = p.grad.numpy().astype(np.float64)
        assert np.all(np.isfinite(got)) and np.any(got != 0), name
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 1e-3, (name, err)


def _ramp_before_straight_through(n_fft, shift):
    """delay_ramp's value as the port computed it before it had a
    gradient: the exact phase, in the delay's dtype."""
    d = shift[..., None]
    di = torch.floor(d)
    frac = d - di
    fnorm = torch.arange(n_fft // 2 + 1, dtype=d.dtype) / n_fft
    t = torch.clamp((fnorm - TAPER_LO) / (TAPER_HI - TAPER_LO), 0.0, 1.0)
    w = 0.5 * (1.0 + torch.cos(math.pi * t))
    theta = -2.0 * math.pi * fnorm
    psi = torch.atan2(frac * torch.sin(theta),
                      (1.0 - frac) + frac * torch.cos(theta))
    phase = theta * di + w * theta * frac + (1.0 - w) * psi
    return torch.polar(torch.ones_like(phase), phase)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_delay_ramp_value_unchanged_and_gradient_matches_jax(dtype):
    """The value is equal in bits with and without a gradient; the
    gradient is JAX's straight-through θ·w slope."""
    rng = np.random.default_rng(11)
    n_fft = 256
    d_np = rng.uniform(-8, 48, (3, 2)).astype(np.float32)
    c_np = (rng.standard_normal((3, 2, n_fft // 2 + 1))
            + 1j * rng.standard_normal((3, 2, n_fft // 2 + 1))
            ).astype(np.complex64)
    d = torch.tensor(d_np, dtype=dtype)
    want = _ramp_before_straight_through(n_fft, d)
    assert torch.equal(tfilters.delay_ramp(n_fft, d), want)
    leaf = d.clone().requires_grad_()
    got = tfilters.delay_ramp(n_fft, leaf)
    assert torch.equal(got.detach(), want)
    (got * torch.tensor(c_np).to(got.dtype)).real.sum().backward()

    def loss(dd):
        return jnp.sum(jnp.real(jfilters.delay_ramp(n_fft, dd)
                                * jnp.asarray(c_np)))

    gj = np.asarray(jax.grad(loss)(jnp.asarray(d_np)), np.float64)
    np.testing.assert_allclose(leaf.grad.numpy().astype(np.float64), gj,
                               rtol=1e-4, atol=1e-3)


def test_fit_hrtf_first_losses_match_jax(tables):
    """The first 5 Adam steps of both loops, from the same start."""
    jt, t = tables
    xs, dirs, _, _ = _scene(7)
    target = _target(jt, xs, dirs)
    _, lj = jfit.fit_hrtf(jt, xs, dirs, target, steps=5, config=JCFG)
    params, lt = tfit.fit_hrtf(t, xs, dirs, target, steps=5, config=TCFG)
    assert len(lt) == 5 and all(isinstance(v, float) for v in lt)
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    assert all(p.device.type == "cpu" and p.requires_grad for p in params)


def test_train_step_returns_the_loss_before_the_step(tables):
    _, t = tables
    xs, dirs, xbs, dirs_b = _scene(3)
    xbs, dirs_b = torch.from_numpy(xbs), torch.from_numpy(dirs_b)
    target = torch.zeros(2, xs.shape[1])
    params = _leaves(tfit.init_params(device="cpu"))
    before = tfit.scene_loss(params, t, xbs, dirs_b, target, TCFG).item()
    opt = torch.optim.Adam(params, lr=3e-2)
    loss = tfit.train_step(params, opt, t, xbs, dirs_b, target, TCFG)
    assert not loss.requires_grad and loss.item() == pytest.approx(before)
    assert all(bool((p != 0).any()) for p in params)  # every leaf moved


def test_fit_recovers_global_gain(tables):
    """Target rendered 6 dB hot by the port; the fitted render matches it
    (the assertion is on the render: gain and EQ are over-complete)."""
    _, t = tables
    xs, dirs, _, _ = _scene(7)
    true = tfit.init_params(device="cpu")._replace(
        gain_log=torch.tensor(np.log(2.0), dtype=torch.float32))
    ttab = tfit.personalize_table(t, true)
    target = tt.BinauralRenderer(ttab, TCFG).render_scene(xs, dirs).numpy()
    params, losses = tfit.fit_hrtf(t, xs, dirs, target, steps=60, lr=5e-2,
                                   config=TCFG)
    assert losses[-1] < losses[0] * 1e-2
    with torch.no_grad():
        fitted = tfit.personalize_table(t, params)
    y = tt.BinauralRenderer(fitted, TCFG).render_scene(xs, dirs).numpy()
    assert snr_db(target, y) > 25


def test_init_params_defaults_to_the_card():
    """The card unless the caller passes the CPU; no card, no fallback."""
    if torch.cuda.is_available():
        assert all(p.device.type == "cuda" for p in tfit.init_params())
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            tfit.init_params()
    assert all(p.device.type == "cpu" for p in tfit.init_params(device="cpu"))


def test_params_bridge_round_trip():
    p = _random_params(9)
    tp = tfit.FitParams.from_numpy(p, "cpu")
    assert all(v.dtype == torch.float32 for v in tp)
    back = tp.to_numpy()
    for f in tfit.FitParams._fields:
        assert np.array_equal(getattr(back, f), np.asarray(getattr(p, f)))

"""tinaural_torch's partition spectra and the plain versions of its
partitioned-convolution kernels, against the JAX package (both branches of
`filter_partitions`; the Pallas kernels in interpret mode, as
`tests/test_pallas.py` runs them) and the float64 golden oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from conftest import snr_db
from tinaural.ops import filters as jfilters
from tinaural.ops import vmem
from tinaural.ops.interp import interpolate
from tinaural.ops.pallas_kernels import (fused_partitioned_assembled,
                                         fused_stream_hold, fused_stream_step)
from tinaural.reference import golden
from tinaural_torch.data import TorchTable
from tinaural_torch.models.renderer import _neighbours
from tinaural_torch.models.streaming import init_state
from tinaural_torch.ops import filters, partitioned_conv as pc

torch.set_num_threads(1)

FLAGS = dict(apply_itd=True, apply_ild=True)


def _hdg(rng, n, taps):
    return (rng.standard_normal((n, 2, taps)) / np.sqrt(taps),
            rng.uniform(-4.0, 60.0, (n, 2)), rng.uniform(0.5, 2.0, (n, 2)))


@pytest.mark.parametrize("taps,B,P", [(128, 256, 1), (512, 128, 5),
                                      (512, 64, 9)])
def test_filter_partitions(taps, B, P):
    """Both JAX branches (zoom matmul and FFT chain) and golden's
    partition_filter(effective_filter) on the same (h, d, g)."""
    h, d, g = _hdg(np.random.default_rng(taps + B), 3, taps)
    assert filters.n_parts(taps, B) == P
    H = filters.filter_partitions(torch.from_numpy(h), torch.from_numpy(d),
                                  torch.from_numpy(g), taps, B)
    assert H.shape == (3, P, 2, B + 1) and H.dtype == torch.complex128
    H32 = filters.filter_partitions(*(torch.from_numpy(a).float()
                                      for a in (h, d, g)), taps, B).numpy()

    def planes(z):
        z = np.asarray(z)
        return np.stack([z.real, z.imag])

    for use_mm in (True, False):
        ref = jax.vmap(lambda a, b, c: jfilters.filter_partitions(
            a, b, c, taps, B, use_matmul=use_mm))(
                *(jnp.asarray(a, jnp.float32) for a in (h, d, g)))
        assert snr_db(planes(ref), planes(H32)) >= 90, use_mm
    gold = np.stack([golden.partition_filter(
        golden.effective_filter(h[i], d[i], g[i], taps), B) for i in range(3)])
    assert snr_db(planes(gold), planes(H.numpy())) >= 200
    assert snr_db(planes(gold), planes(H32)) >= 80


@pytest.fixture(scope="module")
def table128():
    arrays = tinaural.load_hrir_set("synthetic")
    return jax.device_put(arrays), TorchTable.from_hrir_table(arrays, "cpu")


def test_stream_kernels_match_pallas(table128):
    """assemble_partitions + stream_conv (update) and the hold step against
    `fused_stream_step` / `fused_stream_hold` in interpret mode: S = 2,
    three chained pushes (two updates, one hold), the first taking its own
    filter as previous."""
    jt, t = table128
    B, S = 256, 2
    jcfg = tinaural.RenderConfig(stream_block=B)
    taps = t.taps
    st = init_state(t, tinaural_torch.RenderConfig(stream_block=B), S)
    jst = [jnp.asarray(a.numpy()) for a in st]
    rng = np.random.default_rng(3)
    for i, update in enumerate((True, True, False)):
        xb = rng.standard_normal((S, B)).astype(np.float32)
        azs = np.array([30.0 + 40 * i, 200.0 - 25 * i], np.float32)
        els = np.array([5.0 * i, -20.0 + 10 * i], np.float32)
        args = (torch.from_numpy(xb), *st[:5], st.started)
        if update:
            idx, w = _neighbours(t, torch.from_numpy(np.stack([azs, els], -1)),
                                 tinaural_torch.RenderConfig())
            y, pin, fr, fi, hr, hi = pc.stream_step_reference(
                t, idx, w, *args, crossfade=True, **FLAGS)
            h, d, g = jax.vmap(lambda a, e: interpolate(jt, a, e, jcfg))(
                jnp.asarray(azs), jnp.asarray(els))
            jy, jfr, jfi, jhr, jhi = fused_stream_step(
                h, d, g, jnp.asarray(xb), *jst, taps, B, interpret=True)
            assert snr_db(jhr, hr.numpy()) >= 90 and snr_db(jhi, hi.numpy()) >= 90
        else:
            y, pin, fr, fi = pc.stream_hold_reference(*args)
            hr, hi = st.prev_h_re, st.prev_h_im
            jy, jfr, jfi = fused_stream_hold(jnp.asarray(xb), *jst[:5], B,
                                             interpret=True)
            jhr, jhi = jst[3], jst[4]
        assert snr_db(jy, y.numpy()) >= 90, i
        assert snr_db(jfr, fr.numpy()) >= 90 and snr_db(jfi, fi.numpy()) >= 90
        assert torch.equal(pin, args[0])
        st = st._replace(prev_in=pin, fdl_re=fr, fdl_im=fi, prev_h_re=hr,
                         prev_h_im=hi, started=torch.ones(S))
        jst = [jnp.asarray(xb), jfr, jfi, jhr, jhi, jnp.ones(S, jnp.float32)]


def test_partitioned_conv_matches_pallas():
    """partitioned_conv's plain version (fed assemble_partitions' plain
    version) against `fused_partitioned_assembled` in interpret mode, at a
    tiny shape its VMEM gate admits (192 taps, B = 128, P = 2)."""
    taps, B, nb = 192, 128, 8
    P = filters.n_parts(taps, B)
    assert vmem.fits_partitioned_asm(taps, B, P)
    arrays = tinaural.load_hrir_set("synthetic", taps=taps)
    jt, t = jax.device_put(arrays), TorchTable.from_hrir_table(arrays, "cpu")
    rng = np.random.default_rng(5)
    xb = rng.standard_normal((nb, B)).astype(np.float32)
    dirs = np.stack([np.linspace(0, 300, nb), np.linspace(-30, 50, nb)],
                    1).astype(np.float32)
    idx, w = _neighbours(t, torch.from_numpy(dirs),
                         tinaural_torch.RenderConfig())
    jcfg = tinaural.RenderConfig(stream_block=B)
    h, d, g = jax.vmap(lambda a, e: interpolate(jt, a, e, jcfg))(
        jnp.asarray(dirs[:, 0]), jnp.asarray(dirs[:, 1]))
    first = jnp.zeros((nb,), jnp.float32).at[0].set(1.0)
    for crossfade in (True, False):
        hr, hi = pc.assemble_partitions_reference(idx, w, t, B, **FLAGS)
        y = pc.partitioned_conv_reference(torch.from_numpy(xb), hr, hi,
                                          crossfade=crossfade)
        ref = fused_partitioned_assembled(jnp.asarray(xb), h, d, g, first,
                                          taps, B, P, crossfade=crossfade,
                                          interpret=True)
        assert y.shape == (2, nb * B)
        assert snr_db(ref, y.numpy()) >= 90, crossfade
        assert torch.allclose(pc.partitioned_render_reference(
            torch.from_numpy(xb), idx, w, t, crossfade=crossfade, **FLAGS),
            y, atol=1e-5)

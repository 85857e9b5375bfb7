"""block_render's plain version against the JAX package's Pallas kernel
(`fused_block_render` in its in-kernel gather mode, run in interpret
mode), and the CUDA kernels against the plain version on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from conftest import snr_db
from tinaural.ops.pallas_kernels import fused_block_render, gather_tables
from tinaural_torch.data import TorchTable
from tinaural_torch.models.renderer import _n_fft, _neighbours
from tinaural_torch.ops import block_render as br

torch.set_num_threads(1)

S, NB, B = 2, 6, 256


def _inputs(t: TorchTable, seed: int, S=S, nb=NB, B=B):
    rng = np.random.default_rng(seed)
    xbs = rng.standard_normal((S, nb, B)).astype(np.float32)
    dirs = np.stack([rng.uniform(0, 360, (S, nb)),
                     rng.uniform(-40, 90, (S, nb))], -1).astype(np.float32)
    idx, w = _neighbours(t, torch.from_numpy(dirs).to(t.device),
                         tinaural_torch.RenderConfig())
    return torch.from_numpy(xbs).to(t.device), idx, w


@pytest.mark.parametrize("decompose,crossfade", [(True, True), (True, False),
                                                 (False, True)])
def test_reference_matches_pallas_kernel(decompose, crossfade):
    arrays = tinaural.load_hrir_set("synthetic", decompose=decompose)
    t = TorchTable.from_hrir_table(arrays, "cpu")
    xbs, idx, w = _inputs(t, seed=10 + crossfade)
    n_fft = _n_fft(t, B)
    assert n_fft == 512
    flags = dict(crossfade=crossfade, apply_itd=decompose, apply_ild=decompose)
    ours = br.block_render_reference(xbs, idx, w, t, n_fft, **flags).numpy()
    ht, dg = gather_tables(jnp.asarray(arrays.h), jnp.asarray(arrays.delays),
                           jnp.asarray(arrays.gains), t.taps, n_fft)
    theirs = np.asarray(fused_block_render(
        None, None, None, jnp.asarray(xbs.numpy()), t.taps, n_fft,
        idx=jnp.asarray(idx.numpy().astype(np.float32)),
        w=jnp.asarray(w.numpy()), ht=ht, dg=dg, interpret=True, **flags))
    assert ours.shape == theirs.shape == (2, (NB - 1) * B + n_fft)
    assert snr_db(theirs, ours) >= 90


def test_block_render_on_cpu_is_the_reference():
    t = TorchTable.from_hrir_table(tinaural_torch.load_hrir_set("synthetic"), "cpu")
    xbs, idx, w = _inputs(t, seed=3)
    flags = dict(crossfade=True, apply_itd=True, apply_ild=True)
    before = dict(br.launches)
    y = br.block_render(xbs, idx, w, t, 512, **flags)
    assert torch.equal(y, br.block_render_reference(xbs, idx, w, t, 512, **flags))
    assert br.launches == before  # no kernel counted on the CPU route
    y64 = br.block_render_reference(xbs.double(), idx, w, t, 512, **flags)
    assert y64.dtype == torch.float64 and snr_db(y64.numpy(), y.numpy()) >= 100


def test_block_render_rejects_bad_inputs():
    t = TorchTable.from_hrir_table(tinaural_torch.load_hrir_set("synthetic"), "cpu")
    xbs, idx, w = _inputs(t, seed=4)
    flags = dict(crossfade=True, apply_itd=True, apply_ild=True)
    with pytest.raises(ValueError):
        br.block_render(xbs[0], idx, w, t, 512, **flags)
    with pytest.raises(TypeError):
        br.block_render(xbs, idx.long(), w, t, 512, **flags)
    with pytest.raises(ValueError):
        br.block_render(xbs, idx, w, t, 384, **flags)  # not a power of two
    with pytest.raises(ValueError):
        br.block_render(xbs, idx, w, t, 256, **flags)  # too short
    with pytest.raises(ValueError):
        br.block_render(xbs.to("meta"), idx, w, t, 512, **flags)

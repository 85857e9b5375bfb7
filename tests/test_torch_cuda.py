"""The CUDA kernels against their plain versions, on a card.

This file imports neither the JAX package nor the shared conftest (which
does), so it also runs where `tinaural` cannot be imported, as on a
machine without flax:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

import tinaural_torch
from tinaural_torch.data import TorchTable
from tinaural_torch.models.renderer import _n_fft, _neighbours
from tinaural_torch.ops import block_render as br

torch.set_num_threads(1)

B = 1024


def _snr_db(ref: torch.Tensor, test: torch.Tensor) -> float:
    if ref.is_complex():
        ref, test = torch.view_as_real(ref), torch.view_as_real(test)
    ref, test = ref.double().cpu(), test.double().cpu()
    return float(10 * torch.log10(ref.pow(2).sum() / (ref - test).pow(2).sum()))


@pytest.fixture
def table():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return TorchTable.from_hrir_table(tinaural_torch.load_hrir_set("synthetic"),
                                      torch.device("cuda"))


def _inputs(t, S, nb, seed):
    rng = np.random.default_rng(seed)
    dirs = np.stack([rng.uniform(0, 360, (S, nb)),
                     rng.uniform(-40, 90, (S, nb))], -1).astype(np.float32)
    idx, w = _neighbours(t, torch.from_numpy(dirs).to(t.device),
                         tinaural_torch.RenderConfig())
    xbs = torch.from_numpy(rng.standard_normal((S, nb, B)).astype(np.float32))
    return xbs.to(t.device), idx, w


@pytest.mark.gpu
@pytest.mark.parametrize("S,nb,crossfade", [(1, 256, True), (3, 40, True),
                                            (3, 40, False), (2, 1, True)])
def test_block_render_kernels_match_plain(table, S, nb, crossfade):
    xbs, idx, w = _inputs(table, S, nb, seed=S * 100 + nb)
    n_fft = _n_fft(table, B)
    flags = dict(apply_itd=True, apply_ild=True)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **flags)
    H64 = br.assemble_filters_reference(idx, w.double(), table, n_fft, **flags)
    assert _snr_db(H64, H) >= 100
    before = dict(br.launches)
    y = br.block_render(xbs, idx, w, table, n_fft, crossfade=crossfade, **flags)
    torch.cuda.synchronize()
    assert all(br.launches[k] == before[k] + 1 for k in br.KERNELS)
    y64 = br.block_render_reference(xbs.double(), idx, w, table, n_fft,
                                    crossfade=crossfade, **flags)
    assert y.shape == y64.shape == (2, (nb - 1) * B + n_fft)
    assert _snr_db(y64, y) >= 100


@pytest.mark.gpu
def test_raw_table_kernels_match_plain(table):
    raw = TorchTable.from_hrir_table(
        tinaural_torch.load_hrir_set("synthetic", decompose=False), table.device)
    xbs, idx, w = _inputs(raw, 2, 16, seed=5)
    flags = dict(crossfade=True, apply_itd=False, apply_ild=False)
    y = br.block_render(xbs, idx, w, raw, _n_fft(raw, B), **flags)
    y64 = br.block_render_reference(xbs.double(), idx, w, raw, _n_fft(raw, B),
                                    **flags)
    assert _snr_db(y64, y) >= 100


@pytest.mark.gpu
def test_cuda_route_rejects_bad_inputs(table):
    xbs, idx, w = _inputs(table, 1, 4, seed=6)
    flags = dict(crossfade=True, apply_itd=True, apply_ild=True)
    n_fft = _n_fft(table, B)
    with pytest.raises(TypeError):
        br.block_render(xbs.double(), idx, w, table, n_fft, **flags)
    with pytest.raises(ValueError):
        br.block_render(xbs, idx + 5000, w, table, n_fft, **flags)
    with pytest.raises(ValueError):
        br.block_render(xbs.cpu(), idx, w, table, n_fft, **flags)

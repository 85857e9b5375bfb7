"""tinaural_torch's `BinauralRenderer.render_streamed` (batched partitioned
convolution) against the JAX package's (plain jnp route), the float64
`GoldenStream`, and the port's own `Stream.render_offline`."""

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
    out = {}
    for taps in (128, 2048):
        arrays = tinaural.load_hrir_set("synthetic", taps=taps)
        out[taps] = (arrays, TorchTable.from_hrir_table(arrays, "cpu"))
    return out


def _signal(nb, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(nb * B).astype(np.float32)
    dirs = np.stack([rng.uniform(0, 360, nb), rng.uniform(-40, 90, nb)],
                    -1).astype(np.float32)
    return x, dirs


@pytest.mark.parametrize("taps,dir_rate", [(128, 1), (128, 4), (2048, 1),
                                           (2048, 4)])
def test_render_streamed(tables, taps, dir_rate):
    """P = 1 (128 taps) and P = 9 (2048 taps) at dir_rate 1 and 4: golden
    streams the snapped track."""
    arrays, t = tables[taps]
    cfg = tinaural_torch.RenderConfig(stream_block=B, dir_rate=dir_rate)
    jcfg = tinaural.RenderConfig(stream_block=B, dir_rate=dir_rate,
                                 use_pallas=False)
    nb = 7
    x, dirs = _signal(nb, taps + dir_rate)
    y = tinaural_torch.BinauralRenderer(t, cfg).render_streamed(x, dirs)
    assert y.shape == (2, nb * B) and bool(torch.isfinite(y).all())
    snapped = golden.snap_dirs(dirs, dir_rate)
    gs = golden.GoldenStream(arrays, jcfg)
    gold = np.concatenate([gs.push(x[b * B:(b + 1) * B].astype(np.float64),
                                   *snapped[b]) for b in range(nb)], -1)
    jy = np.asarray(JaxRenderer(arrays, jcfg).render_streamed(x, dirs))
    assert snr_db(jy, y.numpy()) >= 90
    assert snr_db(gold, y.numpy()) >= 80


@pytest.mark.parametrize("taps", [128, 2048])
def test_render_streamed_equals_render_offline(tables, taps):
    """At the default knobs the batched render is the stream's push by
    push output."""
    _, t = tables[taps]
    cfg = tinaural_torch.RenderConfig(stream_block=B)
    x, dirs = _signal(5, taps)
    y = tinaural_torch.BinauralRenderer(t, cfg).render_streamed(x, dirs)
    ys = tinaural_torch.Stream(t, cfg).render_offline(x, dirs)
    assert snr_db(ys.numpy(), y.numpy()) >= 120
    with pytest.raises(ValueError):
        tinaural_torch.BinauralRenderer(t, cfg).render_streamed(x[:-1], dirs)

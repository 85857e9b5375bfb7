"""tinaural_torch's natural-order route — the plain `assembly_mac` and
`assembly_mac_render`, and `render_trajectory` / `render_batch` at the FFT
sizes that take it — against tinaural (its Pallas kernel
`fused_assembly_mac` in interpret mode, its plain jnp route) and the
float64 golden oracle, on the same numpy inputs from a seed."""

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
from tinaural_torch.models.renderer import (NATURAL_ORDER_MIN_FFT, _n_fft,
                                            _neighbours, route,
                                            _trajectory_core)
from tinaural_torch.ops import _layout
from tinaural_torch.ops import assembly_mac as am
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops import block_step as bs
from tinaural_torch.ops.mac_plan import mac_plan

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    out = {}
    for taps in (128, 2048):
        arrays = tinaural.load_hrir_set("synthetic", taps=taps)
        out[taps] = arrays, TorchTable.from_hrir_table(arrays, "cpu")
    return out


def _jax_config(taps, **kw):
    """The JAX package's plain jnp route; at 2048 taps through its FFT
    filter path, the same linear map as its dense matmuls at a fraction of
    their set-up time."""
    return tinaural.RenderConfig(use_pallas=False, **kw,
                                 filter_path="fft" if taps > 128 else "matmul")


def _cplanes(z):
    z = np.asarray(z)
    return np.stack([z.real, z.imag])


@pytest.mark.parametrize("crossfade", [True, False])
def test_assembly_mac_reference_matches_pallas_kernel(tables, crossfade):
    """The setup of test_pallas.py's fused_assembly_mac test: 70 rows,
    `first` at 37 and passed as 0 at row 0 (both kernels force it), B 256;
    the JAX kernel gets h, d, g from `interpolate`, the port idx and w
    from `_neighbours` at the same directions."""
    from tinaural.ops.interp import interpolate
    from tinaural.ops.pallas_kernels import fused_assembly_mac

    arrays, t = tables[128]
    B, nb = 256, 70
    n_fft = _n_fft(t, B)
    rng = np.random.default_rng(11)
    dirs = np.stack([rng.uniform(0, 360, nb), rng.uniform(-40, 90, nb)],
                    axis=1).astype(np.float32)
    Xu = np.fft.rfft(rng.standard_normal((nb, n_fft))).astype(np.complex64)
    Xd = np.fft.rfft(rng.standard_normal((nb, n_fft))).astype(np.complex64)
    first = np.zeros(nb, np.float32)
    first[37] = 1.0
    tbl = jax.device_put(arrays)
    h, d, g = jax.vmap(lambda a, e: interpolate(tbl, a, e,
                                                tinaural.RenderConfig()))(
        jnp.asarray(dirs[:, 0]), jnp.asarray(dirs[:, 1]))
    theirs = fused_assembly_mac(h, d, g, jnp.asarray(Xu), jnp.asarray(Xd),
                                jnp.asarray(first), t.taps, n_fft,
                                crossfade=crossfade, interpret=True)
    idx, w = _neighbours(t, torch.from_numpy(dirs),
                         tinaural_torch.RenderConfig())
    ours = am.assembly_mac_reference(
        idx, w, t, torch.from_numpy(Xu), torch.from_numpy(Xd),
        torch.from_numpy(first), n_fft, crossfade=crossfade, apply_itd=True,
        apply_ild=True)
    assert ours.shape == (nb, 2, n_fft // 2 + 1)
    assert snr_db(_cplanes(theirs), _cplanes(ours.numpy())) >= 100


def test_assembly_mac_reference_first_rows(tables):
    """`first` anywhere: such a row is its own previous filter; row 0 is
    one whatever it holds; without `first` the previous row's filter."""
    _, t = tables[128]
    rng = np.random.default_rng(4)
    rows, n_fft = 9, 512
    idx, w = _neighbours(t, torch.from_numpy(rng.uniform(
        0, 90, (rows, 2)).astype(np.float32)), tinaural_torch.RenderConfig())
    Xu = torch.randn(rows, n_fft // 2 + 1, dtype=torch.complex128)
    Xd = torch.randn(rows, n_fft // 2 + 1, dtype=torch.complex128)
    first = torch.zeros(rows)
    first[4] = 1.0
    flags = dict(apply_itd=True, apply_ild=True)
    Y = am.assembly_mac_reference(idx, w.double(), t, Xu, Xd, first, n_fft,
                                  crossfade=True, **flags)
    H = br.assemble_filters_reference(idx, w.double(), t, n_fft, **flags)
    for r, prev in ((0, 0), (1, 0), (4, 4), (5, 4), (8, 7)):
        want = Xu[r, None] * H[r] + Xd[r, None] * H[prev]
        assert torch.allclose(Y[r], want, rtol=0, atol=1e-12), r


@pytest.mark.parametrize("taps,B,crossfade", [(128, 2048, True),
                                              (128, 2048, False),
                                              (2048, 256, True)])
def test_trajectory_on_the_natural_order_route(tables, taps, B, crossfade):
    """n_fft 4096 — 128 taps at block 2048, 2048 taps at block 256 — takes
    the natural-order route, against JAX and golden."""
    arrays, t = tables[taps]
    assert route("trajectory", 1, 5, _n_fft(t, B), 0) is am.assembly_mac_render
    cfg = tinaural_torch.RenderConfig(block_size=B, crossfade=crossfade)
    jcfg = _jax_config(taps, block_size=B, crossfade=crossfade)
    N = 5 * B - 100
    x = np.random.default_rng(taps + B).standard_normal(N)
    nb = -(-N // B)
    dirs = np.stack([np.linspace(0, 300, nb), np.linspace(-30, 60, nb)], 1)
    before = dict(am.launches)
    y = tinaural_torch.render_trajectory(t, x, dirs, cfg).numpy()
    assert dict(am.launches) == before  # CPU tensors: the plain version
    assert y.shape == (2, N + taps + 63) and np.isfinite(y).all()
    assert snr_db(np.asarray(JaxRenderer(arrays, jcfg).render_trajectory(
        x, dirs)), y) >= 90
    assert snr_db(golden.render_trajectory(arrays, x, dirs, jcfg), y) >= 80


@pytest.mark.parametrize("taps,B,static", [(128, 2048, False),
                                           (2048, 256, False),
                                           (2048, 256, True)])
def test_render_batch_on_the_natural_order_route(tables, taps, B, static):
    arrays, t = tables[taps]
    cfg = tinaural_torch.RenderConfig(block_size=B)
    jcfg = _jax_config(taps, block_size=B)
    rng = np.random.default_rng(taps + static)
    S, N = 2, 3 * B + 7
    nb = -(-N // B)
    shape = (S,) if static else (S, nb)
    dirs = np.stack([rng.uniform(0, 360, shape), rng.uniform(-40, 90, shape)],
                    -1)
    xs = rng.standard_normal((S, N))
    y = tinaural_torch.BinauralRenderer(t, cfg).render_batch(xs, dirs).numpy()
    assert y.shape == (S, 2, N + taps + 63) and np.isfinite(y).all()
    assert snr_db(np.asarray(JaxRenderer(arrays, jcfg).render_batch(xs, dirs)),
                  y) >= 90
    for s in range(S):  # each request on its own: no tail crosses requests
        track = np.broadcast_to(dirs[s], (nb, 2)) if static else dirs[s]
        assert snr_db(golden.render_trajectory(arrays, xs[s], track, jcfg),
                      y[s]) >= 80


def test_natural_order_route_equals_the_block_routes(tables):
    """The same map as `block_render` (one source) and `block_step_render`
    (independent sources), at a size below the switch too."""
    _, t = tables[128]
    rng = np.random.default_rng(5)
    S, nb, B = 3, 6, 256
    xbs = torch.from_numpy(rng.standard_normal((S, nb, B)))
    idx, w = _neighbours(t, torch.from_numpy(rng.uniform(
        0, 90, (S, nb, 2)).astype(np.float32)), tinaural_torch.RenderConfig())
    n_fft = _n_fft(t, B)
    for crossfade in (True, False):
        kw = dict(crossfade=crossfade, apply_itd=True, apply_ild=True)
        ours = am.assembly_mac_render(xbs, idx, w, t, n_fft, **kw)
        assert snr_db(bs.block_step_render(xbs, idx, w, t, n_fft, **kw).numpy(),
                      ours.numpy()) >= 200
        one = br.block_render(xbs[:1], idx[:1], w[:1], t, n_fft, **kw)
        assert snr_db(one.numpy(), ours[0].numpy()) >= 200
    cfg = tinaural_torch.RenderConfig(block_size=B)
    dirs = torch.from_numpy(rng.uniform(0, 90, (nb, 2)).astype(np.float32))
    assert torch.equal(
        _trajectory_core(t, xbs[0].float(), dirs, cfg),
        _trajectory_core(t, xbs[0].float(), dirs, cfg, render=br.block_render))


def test_natural_order_rule():
    """From n_fft 4096 on: 128 taps at block 2048, 2048 taps at 1024 or
    256, 16,384 taps at 1024; below it the main path's 2048."""
    assert NATURAL_ORDER_MIN_FFT == 4096
    for n_fft, want in ((2048, False), (1024, False), (4096, True),
                        (32768, True)):
        for kind in ("trajectory", "batch"):
            natural = route(kind, 1, 8, n_fft, 132) is am.assembly_mac_render
            assert natural is want


def test_run_length_rule():
    """Runs as short as leave one run per block the card holds at once:
    132 SMs × 3 blocks of the register plan at n_fft 4096, × 1 block of
    the split mode at 32768; 1 + 1/run assemblies per row."""
    slots = 132 * mac_plan(2048, 4096).blocks_per_sm
    assert slots == 396 and 132 * mac_plan(16384, 32768).blocks_per_sm == 132
    assert am.run_length(128, 132) == 1       # (j): 16,384-tap trajectory
    assert am.run_length(527, slots) == 2
    assert am.run_length(4096, slots) == 11   # (l): 1 + 1/11 per row
    assert am.run_length(8192, slots) == 21   # (k): 1 + 1/21 per row
    assert am.run_length(3001, slots) == 8
    assert am.run_length(100, 0) == 100       # no SM count: one slot


def test_assembly_mac_buffer_mode(monkeypatch):
    """The register plan's exchange buffer and carried H_prev fit 227 KB
    up to n_fft 16384 at any filter length; n_fft 32768 at the 16,384-tap
    table (L == n) takes the cluster mode, whose share fits too, and the
    split mode where forced; L < n above 16384 (128 taps at 32768) and
    n_fft above 131072 take the split mode."""
    limit = 232448
    for taps, n_fft in ((2048, 4096), (128, 4096), (4096, 8192),
                        (8192, 16384), (128, 16384)):
        p = mac_plan(taps, n_fft)
        assert _layout.launch_mode(p.body, p.shared_f2, n_fft,
                                   limit) == (_layout.REGISTER, 0)
    p = mac_plan(16384, 32768)
    assert p.body == _layout.CLUSTER and p.ranks == 2
    assert _layout.launch_mode(p.body, p.shared_f2, 32768,
                               limit) == (_layout.CLUSTER, 0)
    split = (_layout.SPLIT, _layout.SPLIT_WORK)
    for taps, n_fft in ((128, 32768), (200000, 1 << 18)):
        p = mac_plan(taps, n_fft)
        assert p.body != _layout.CLUSTER
        assert _layout.launch_mode(p.body, p.shared_f2, n_fft, limit) == split
    monkeypatch.setattr(_layout, "force_work", _layout.SPLIT_WORK)
    p = mac_plan(16384, 32768)
    assert _layout.launch_mode(p.body, p.shared_f2, 32768, limit) == split


def test_assembly_mac_render_rejects_bad_inputs(tables):
    _, t = tables[128]
    xbs = torch.zeros((2, 4, 256))
    idx, w = _neighbours(t, torch.zeros((2, 4, 2)),
                         tinaural_torch.RenderConfig())
    kw = dict(crossfade=True, apply_itd=True, apply_ild=True)
    with pytest.raises(ValueError):  # one filter per source: not this route
        am.assembly_mac_render(xbs, idx[:, :1], w[:, :1], t, 512, **kw)
    with pytest.raises(TypeError):
        am.assembly_mac_render(xbs, idx.long(), w, t, 512, **kw)
    with pytest.raises(ValueError):
        am.assembly_mac_render(xbs, idx, w, t, 256, **kw)  # too short
    with pytest.raises(ValueError):
        am.assembly_mac_render(xbs.to("meta"), idx, w, t, 512, **kw)

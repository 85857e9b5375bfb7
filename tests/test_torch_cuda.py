"""The CUDA kernels against their plain versions, on a card: the block
render's three, the partitioned convolution's three (the streaming step
with its hold step at P = 1, 5 and 9, S = 1 and block 128, a batched
stream's offline render, and the partitioned offline render, chunked and
whole), the block step's two with the per-source overlap-add, the scene
mixdown's `block_spectra_mix` with the summing `spectra_inverse`, the
natural-order `assembly_mac`, and `spectra_inverse` alone at every FFT
size; each family again in the split buffer mode, forced at small shapes,
and at the sizes that need it (a 44,100-tap `render_streamed`, a
16,384-tap trajectory); and the cluster mode of `spectra_inverse` and
`assemble_partitions` at its edges, under a refused plan, and forced back
to the split mode.

This file imports neither the JAX package nor the shared conftest (which
does), so it also runs where `tinaural` cannot be imported, as on a
machine without flax:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu -q

Without a CUDA device every test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tinaural_torch
from tinaural_torch.data import TorchTable
from tinaural_torch.models.renderer import _n_fft, _neighbours
from tinaural_torch.models.streaming import (StreamState, _batch_scan_core,
                                             init_state)
from tinaural_torch.models.renderer import _partitioned_core, _trajectory_core
from tinaural_torch.ops import _layout
from tinaural_torch.ops import assembly_mac as am
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops import block_step as bs
from tinaural_torch.ops import partitioned_conv as pc
from tinaural_torch.ops.mac_plan import mac_plan
from tinaural_torch.ops.partitions_plan import partitions_plan
from tinaural_torch.ops.render_plan import filters_plan, mix_plan
from tinaural_torch.ops.spectra_inverse import inverse_plan

from test_torch_mac_plan import _inputs as _random_inputs
from test_torch_mac_plan import _table as _random_table

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


# ------------------------------------------- the block render's register mode


@pytest.mark.gpu
@pytest.mark.parametrize("log2n", range(7, 15))
def test_block_render_register_kernels_every_size(log2n):
    """`assemble_filters` and `block_spectra_mix_inverse` against their
    float64 plain versions at every n_fft 128 … 16384 of the shared mode:
    L == n and L = 128 < n; 1, 7 and (up to n_fft 4096) 8193 rows, so the
    last CUDA block holds idle rows; S 1, 3, 16 and 64 sources, crossfade
    on and off; equal bits over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    n = 1 << log2n
    assert filters_plan(16, n).register and mix_plan(n).register
    for taps in {n - 67, 16}:  # L == n, and L = 128
        t = _random_table(taps, seed=taps, device=dev)
        for rows in (1, 7) + ((8193,) if n <= 4096 else ()):
            idx, w = (x.to(dev) for x in _random_inputs(t, rows, 2, rows)[:2])
            H = br.assemble_filters_cuda(idx[None], w[None], t, n, **FLAGS)
            H64 = br.assemble_filters_reference(idx[None], w[None].double(),
                                                t, n, **FLAGS)
            assert _snr_db(H64, H) >= 100, (n, taps, rows)
            assert torch.equal(H, br.assemble_filters_cuda(
                idx[None], w[None], t, n, **FLAGS))
    rng = np.random.default_rng(log2n)
    F = n // 2 + 1
    for S, nb in ((1, 7), (3, 5), (16, 3), (64, 2)):
        xbs = torch.from_numpy(rng.standard_normal((S, nb, n // 2)).astype(
            np.float32)).to(dev)
        H = torch.from_numpy((rng.standard_normal((S, nb, 2, F))
                              + 1j * rng.standard_normal((S, nb, 2, F))
                              ).astype(np.complex64)).to(dev)
        for crossfade in (True, False):
            got = br.block_spectra_mix_inverse_cuda(xbs, H, n,
                                                    crossfade=crossfade)
            ref = br.block_spectra_mix_inverse_reference(
                xbs.double(), H.to(torch.complex128), n, crossfade=crossfade)
            assert _snr_db(ref, got) >= 100, (n, S, crossfade)
            assert torch.equal(got, br.block_spectra_mix_inverse_cuda(
                xbs, H, n, crossfade=crossfade))


@pytest.mark.gpu
def test_block_render_at_the_mode_boundary(long_tables):
    """n_fft 16384, the largest register plan, and 32768, the split mode,
    on the same table, rows and blocks: both kernels and the whole render
    against the float64 plain version."""
    t = long_tables[2048]
    xbs, idx, w = _inputs(t, 2, 6, seed=11)
    for n in (16384, 32768):
        assert filters_plan(t.taps, n).register == (n == 16384)
        assert mix_plan(n).register == (n == 16384)
        H = br.assemble_filters_cuda(idx, w, t, n, **FLAGS)
        H64 = br.assemble_filters_reference(idx, w.double(), t, n, **FLAGS)
        assert _snr_db(H64, H) >= 100, n
        y = br.block_render(xbs, idx, w, t, n, crossfade=True, **FLAGS)
        y64 = br.block_render_reference(xbs.double(), idx, w, t, n,
                                        crossfade=True, **FLAGS)
        assert _snr_db(y64, y) >= 100, n


@pytest.mark.gpu
def test_block_render_refuses_another_plan(table, monkeypatch):
    """The entry points take only the plans they were compiled for:
    another thread count, rows per block or blocks per SM raises, and
    nothing is launched."""
    xbs, idx, w = _inputs(table, 1, 9, seed=12)
    n_fft = _n_fft(table, B)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    plan, mplan = filters_plan(table.taps, n_fft), mix_plan(n_fft)
    for wrong in (dict(threads=2 * plan.threads),
                  dict(rows_per_block=plan.rows_per_block // 2),
                  dict(blocks_per_sm=plan.blocks_per_sm + 1)):
        monkeypatch.setattr(br, "filters_plan", lambda taps, n, wrong=wrong:
                            dataclasses.replace(plan, **wrong))
        before = br.launches["assemble_filters"]
        with pytest.raises(RuntimeError):
            br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
        assert br.launches["assemble_filters"] == before
    for wrong in (dict(threads=2 * mplan.threads),
                  dict(blocks_per_sm=mplan.blocks_per_sm + 1)):
        monkeypatch.setattr(br, "mix_plan", lambda n, wrong=wrong:
                            dataclasses.replace(mplan, **wrong))
        before = br.launches["block_spectra_mix_inverse"]
        with pytest.raises(RuntimeError):
            br.block_spectra_mix_inverse_cuda(xbs, H, n_fft, crossfade=True)
        assert br.launches["block_spectra_mix_inverse"] == before


@pytest.mark.gpu
def test_block_render_kernels_reject_bad_inputs(table):
    xbs, idx, w = _inputs(table, 2, 3, seed=13)
    n_fft = _n_fft(table, B)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    with pytest.raises(ValueError):  # H of another n_fft
        br.block_spectra_mix_inverse_cuda(xbs, H, 2 * n_fft, crossfade=True)
    with pytest.raises(ValueError):  # below the smallest plan
        br.block_spectra_mix_inverse_cuda(xbs[..., :32].contiguous(),
                                          H[..., :33].contiguous(), 64,
                                          crossfade=True)
    with pytest.raises(TypeError):
        br.block_spectra_mix_inverse_cuda(xbs.double(), H, n_fft,
                                          crossfade=True)
    with pytest.raises(ValueError):
        br.assemble_filters_cuda(idx, w, table, 96, **FLAGS)
    with pytest.raises(ValueError):
        br.assemble_filters_cuda(idx.cpu(), w, table, n_fft, **FLAGS)


# ---------------------------------------------------------------- partitioned


class _Tables(dict):
    """Synthetic tables on the card by length, each built at first use."""

    def __missing__(self, taps):
        self[taps] = TorchTable.from_hrir_table(
            tinaural_torch.load_hrir_set("synthetic", taps=taps),
            torch.device("cuda"))
        return self[taps]


@pytest.fixture(scope="module")
def long_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    tables = _Tables()
    for taps in (128, 2048):
        tables[taps]
    return tables


def _rows(t, shape, seed):
    rng = np.random.default_rng(seed)
    dirs = np.stack([rng.uniform(0, 360, shape),
                     rng.uniform(-40, 90, shape)], -1).astype(np.float32)
    return _neighbours(t, torch.from_numpy(dirs).to(t.device),
                       tinaural_torch.RenderConfig())


FLAGS = dict(apply_itd=True, apply_ild=True)


@pytest.mark.gpu
@pytest.mark.parametrize("taps,B", [(128, 256), (2048, 512), (2048, 256),
                                    (128, 128), (16384, 512), (44100, 512)])
def test_assemble_partitions_matches_plain(long_tables, taps, B):
    """Against the float64 plain version: the shared mode up to 2048 taps,
    the cluster mode at 16,384 taps (L 32768, 2 blocks per row) and
    44,100 (L 65536, 4 blocks)."""
    t = long_tables[taps]
    assert partitions_plan(taps, B).cluster == (taps > 8128)
    idx, w = _rows(t, (6,), seed=B)
    hr, hi = pc.assemble_partitions_cuda(idx, w, t, B, **FLAGS)
    r64, i64 = pc.assemble_partitions_reference(idx, w.double(), t, B, **FLAGS)
    assert hr.shape == (6, -(-(taps + 64) // B), 2, B + 1)
    assert _snr_db(torch.complex(r64, i64), torch.complex(hr, hi)) >= 100


@pytest.mark.gpu
@pytest.mark.parametrize("taps,B,S", [(128, 256, 5), (2048, 512, 3),
                                      (2048, 256, 1), (128, 128, 2)])
def test_stream_conv_chain_matches_plain(long_tables, taps, B, S):
    """Update, update, hold, update: every kernel output against the plain
    float64 step on the same carried state, over a chain that carries the
    delay line and the previous filter."""
    t = long_tables[taps]
    cfg = tinaural_torch.RenderConfig(stream_block=B)
    st = init_state(t, cfg, S)
    rng = np.random.default_rng(taps + B + S)
    for i, update in enumerate((True, True, False, True)):
        xb = torch.from_numpy(rng.standard_normal((S, B)).astype(np.float32)
                              ).to(t.device)
        args = (xb, st.prev_in, st.fdl_re, st.fdl_im, st.prev_h_re,
                st.prev_h_im, st.started)
        args64 = tuple(a.double() for a in args)
        if update:
            idx, w = _rows(t, (S,), seed=10 * i)
            got = pc.stream_step(t, idx, w, *args, crossfade=True, **FLAGS)
            ref = pc.stream_step_reference(t, idx, w.double(), *args64,
                                           crossfade=True, **FLAGS)
        else:
            got = pc.stream_hold(*args)
            ref = pc.stream_hold_reference(*args64)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert _snr_db(r, g) >= 100, i
        h = got[4:] if update else (st.prev_h_re, st.prev_h_im)
        st = st._replace(prev_in=got[1], fdl_re=got[2], fdl_im=got[3],
                         prev_h_re=h[0], prev_h_im=h[1],
                         started=torch.ones_like(st.started))


@pytest.mark.gpu
@pytest.mark.parametrize("taps,B,crossfade", [(2048, 512, True),
                                              (2048, 256, True),
                                              (128, 256, False),
                                              (128, 128, True)])
def test_partitioned_conv_matches_plain(long_tables, taps, B, crossfade,
                                        monkeypatch):
    t = long_tables[taps]
    nb = 40
    idx, w = _rows(t, (nb,), seed=nb + B)
    xb = torch.from_numpy(np.random.default_rng(B).standard_normal(
        (nb, B)).astype(np.float32)).to(t.device)
    hr, hi = pc.assemble_partitions_cuda(idx, w, t, B, **FLAGS)
    y = pc.partitioned_conv_cuda(xb, hr, hi, crossfade=crossfade)
    y64 = pc.partitioned_conv_reference(xb.double(), hr.double(), hi.double(),
                                        crossfade=crossfade)
    assert _snr_db(y64, y) >= 100
    kw = dict(crossfade=crossfade, **FLAGS)
    whole = pc.partitioned_render(xb, idx, w, t, **kw)
    monkeypatch.setattr(pc, "CHUNK_BYTES", 3 * hr[0].numel() * 8)  # 3 blocks
    chunked = pc.partitioned_render(xb, idx, w, t, **kw)
    assert torch.equal(whole, chunked)
    ref = pc.partitioned_render_reference(xb.double(), idx, w, t, **kw)
    assert _snr_db(ref, whole) >= 100


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_batched_render_offline_matches_plain(long_tables, k):
    """BatchedStream.render_offline, whose burst reaches the kernels as a
    transposed view, against the plain float64 chain of the same pushes."""
    t = long_tables[128]
    cfg = tinaural_torch.RenderConfig(stream_update_rate=k)
    B, S, nb = cfg.stream_block, 3, 7
    rng = np.random.default_rng(k)
    xs = torch.from_numpy(rng.standard_normal((S, nb * B)).astype(np.float32)
                          ).to(t.device)
    dirs = torch.from_numpy(rng.uniform(0, 90, (S, nb, 2)).astype(np.float32)
                            ).to(t.device)
    y = tinaural_torch.BatchedStream(t, S, cfg).render_offline(xs, dirs)
    st64 = StreamState(*(f.double() for f in init_state(t, cfg, S)))
    ys = _batch_scan_core(t, st64, xs.double().reshape(S, nb, B).transpose(0, 1),
                          dirs[..., 0].T, dirs[..., 1].T, cfg,
                          pc.stream_step_reference, pc.stream_hold_reference)[1]
    assert _snr_db(ys.permute(1, 2, 0, 3).reshape(S, 2, nb * B), y) >= 100


@pytest.mark.gpu
def test_partitioned_cuda_route_rejects_bad_inputs(long_tables):
    t = long_tables[128]
    B, S = 256, 2
    st = init_state(t, tinaural_torch.RenderConfig(stream_block=B), S)
    xb = torch.zeros((S, B), device=t.device)
    with pytest.raises(TypeError):
        pc.stream_hold(xb.double(), *(f.double() for f in st[:5]),
                       st.started.double())
    with pytest.raises(ValueError):
        pc.stream_hold(xb, st.prev_in, st.fdl_re[:1], *st[2:])
    with pytest.raises(ValueError):
        pc.stream_hold(xb, st.prev_in.cpu(), *st[1:])
    idx, w = _rows(t, (4,), seed=0)
    with pytest.raises(TypeError):
        pc.partitioned_render(torch.zeros((4, B), device=t.device,
                                          dtype=torch.float64),
                              idx, w, t, crossfade=True, **FLAGS)


# ----------------------------------------------------------------- block step


@pytest.mark.gpu
@pytest.mark.parametrize("S,nb,crossfade,one_filter", [
    (3, 40, True, False), (3, 40, False, True), (4, 1, True, False),
    (2, 9, True, True)])
def test_block_step_kernels_match_plain(table, S, nb, crossfade, one_filter):
    """block_spectra, spectra_inverse and the per-source overlap_add
    against their plain float64 versions on the same inputs, with source
    boundaries inside the rows."""
    xbs, idx, w = _inputs(table, S, nb, seed=S * 10 + nb)
    if one_filter:
        idx, w = idx[:, :1].contiguous(), w[:, :1].contiguous()
    n_fft = _n_fft(table, B)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    Y = bs.block_spectra_cuda(xbs, H, n_fft, crossfade=crossfade)
    Y64 = bs.block_spectra_reference(xbs.double(), H.to(torch.complex128),
                                     n_fft, crossfade=crossfade)
    assert Y.shape == Y64.shape == (S, nb, 2, n_fft // 2 + 1)
    assert _snr_db(Y64, Y) >= 100
    frames = bs.spectra_inverse_cuda(Y, n_fft)
    f64 = bs.spectra_inverse_reference(Y.to(torch.complex128), n_fft)
    assert _snr_db(f64, frames) >= 100
    out = br.overlap_add_cuda(frames, B)
    ref = br.overlap_add(frames.transpose(1, 2), B)
    assert out.shape == (S, 2, (nb - 1) * B + n_fft)
    assert torch.allclose(out, ref, rtol=0, atol=1e-6)
    before = (dict(br.launches), dict(bs.launches))
    y = bs.block_step_render(xbs, idx, w, table, n_fft, crossfade=crossfade,
                             **FLAGS)
    torch.cuda.synchronize()
    assert br.launches["assemble_filters"] == before[0]["assemble_filters"] + 1
    assert br.launches["overlap_add"] == before[0]["overlap_add"] + 1
    assert all(bs.launches[k] == before[1][k] + 1
               for k in ("block_spectra", "spectra_inverse"))
    assert bs.launches["block_spectra_mix"] == before[1]["block_spectra_mix"]
    y64 = bs.block_step_render_reference(xbs.double(), idx, w, table, n_fft,
                                         crossfade=crossfade, **FLAGS)
    assert _snr_db(y64, y) >= 100


@pytest.mark.gpu
@pytest.mark.parametrize("work", [64, 256])
def test_split_mode_matches_plain(table, long_tables, monkeypatch, work):
    """Every kernel with its buffers in the device scratch and its FFTs
    split in two passes, forced at small shapes (work² ≥ each FFT)."""
    monkeypatch.setattr(_layout, "force_work", work)
    # block render and block step: n_fft 2048 = 32·64, L 256
    xbs, idx, w = _inputs(table, 3, 6, seed=work)
    n_fft = _n_fft(table, B)
    kw = dict(crossfade=True, **FLAGS)
    for render, ref in ((br.block_render, br.block_render_reference),
                        (bs.block_step_render, bs.block_step_render_reference)):
        y = render(xbs, idx, w, table, n_fft, **kw)
        assert _snr_db(ref(xbs.double(), idx, w, table, n_fft, **kw), y) >= 100
    # partitioned: L 4096 = 64·64 at 2048 taps, frames of 512
    t = long_tables[2048]
    idx, w = _rows(t, (12,), seed=work)
    xb = torch.from_numpy(np.random.default_rng(work).standard_normal(
        (12, 256)).astype(np.float32)).to(t.device)
    y = pc.partitioned_render(xb, idx, w, t, **kw)
    assert _snr_db(pc.partitioned_render_reference(xb.double(), idx, w, t,
                                                   **kw), y) >= 100
    st = init_state(t, tinaural_torch.RenderConfig(stream_block=256), 12)
    args = (xb, st.prev_in, st.fdl_re, st.fdl_im, st.prev_h_re, st.prev_h_im,
            torch.ones_like(st.started))
    got = pc.stream_step(t, idx, w, *args, **kw)
    ref = pc.stream_step_reference(t, idx, w.double(),
                                   *(a.double() for a in args), **kw)
    for g, r in zip(got, ref):
        assert _snr_db(r, g) >= 100


# ------------------------------------------------ scene mixdown, natural order


@pytest.mark.gpu
@pytest.mark.parametrize("S,nb,crossfade,one_filter,chunk", [
    (5, 40, True, False, 2), (5, 40, False, True, 5), (3, 1, True, False, 1),
    (7, 9, True, True, 3)])
def test_block_spectra_mix_matches_plain(table, S, nb, crossfade, one_filter,
                                         chunk):
    """block_spectra_mix's partials against the plain float64 version, the
    summing spectra_inverse against the irfft of their sum, and the whole
    scene route against its plain version."""
    xbs, idx, w = _inputs(table, S, nb, seed=S * 10 + nb + chunk)
    if one_filter:
        idx, w = idx[:, :1].contiguous(), w[:, :1].contiguous()
    n_fft = _n_fft(table, B)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    P = bs.block_spectra_mix_cuda(xbs, H, n_fft, crossfade=crossfade,
                                  chunk=chunk)
    P64 = bs.block_spectra_mix_reference(xbs.double(), H.to(torch.complex128),
                                         n_fft, crossfade=crossfade,
                                         chunk=chunk)
    assert P.shape == P64.shape == (-(-S // chunk), nb, 2, n_fft // 2 + 1)
    assert _snr_db(P64, P) >= 100
    frames = bs.spectra_inverse_cuda(P, n_fft, summed=True)
    f64 = bs.spectra_inverse_reference(P.to(torch.complex128).sum(0), n_fft)
    assert frames.shape == (nb, 2, n_fft) and _snr_db(f64, frames) >= 100
    kw = dict(crossfade=crossfade, **FLAGS)
    y = bs.scene_step_render(xbs, idx, w, table, n_fft, **kw)
    y64 = bs.scene_step_render_reference(xbs.double(), idx, w, table, n_fft,
                                         **kw)
    assert y.shape == y64.shape == (2, (nb - 1) * B + n_fft)
    assert _snr_db(y64, y) >= 100


@pytest.mark.gpu
def test_scene_mix_route_is_deterministic(table):
    """Two calls of the mixdown route give equal bits: the partials are
    summed in a fixed order, with no atomics."""
    xbs, idx, w = _inputs(table, 64, 16, seed=11)
    kw = dict(crossfade=True, **FLAGS)
    n_fft = _n_fft(table, B)
    before = dict(bs.launches)
    first = bs.scene_step_render(xbs, idx, w, table, n_fft, **kw)
    assert bs.launches["block_spectra_mix"] == before["block_spectra_mix"] + 1
    assert torch.equal(first, bs.scene_step_render(xbs, idx, w, table, n_fft,
                                                   **kw))


def _mac_inputs(t, rows, n_fft, seed):
    idx, w = _rows(t, (rows,), seed)
    rng = np.random.default_rng(seed)
    F = n_fft // 2 + 1
    X = torch.from_numpy((rng.standard_normal((2, rows, F))
                          + 1j * rng.standard_normal((2, rows, F))).astype(
                              np.complex64)).to(t.device)
    return idx, w, X[0], X[1]


@pytest.mark.gpu
@pytest.mark.parametrize("taps,n_fft,rows,firsts,crossfade", [
    (128, 4096, 70, (0, 37), True), (128, 4096, 70, (37,), False),
    (2048, 4096, 9, (4, 5), True),
    (128, 4096, 3001, (0, 1, 999, 1500, 3000), True),
    (2048, 4096, 1001, (399, 401), True),
    (2048, 8192, 300, (150,), True), (6000, 8192, 301, (99, 100), True),
    (6000, 8192, 64, (), False), (128, 16384, 100, (50,), True),
    (12000, 16384, 101, (33, 34), True)])
def test_assembly_mac_matches_plain(long_tables, taps, n_fft, rows, firsts,
                                    crossfade):
    """Against the plain float64 version at every register plan shape the
    routes reach (n_fft 4096, 8192, 16384; L < n and L == n; crossfade on
    and off), with `first` at run boundaries and inside runs, row 0 passed
    as 0 where firsts omit it, and rows that are no multiple of the run
    (3001 rows run 8 at a time on 132 SMs × 3 blocks; 1001 rows 3 at a
    time, so 399 starts a run and 401 falls inside one)."""
    dev = long_tables[128].device
    if taps in long_tables:
        t = long_tables[taps]
        idx, w, Xu, Xd = _mac_inputs(t, rows, n_fft, seed=rows + taps)
    else:  # L == n at 8192 and 16384
        t = _random_table(taps, seed=taps, device=dev)
        idx, w, Xu, Xd = (x.to(dev) for x in _random_inputs(t, rows, n_fft,
                                                            seed=rows))
    first = torch.zeros(rows, device=dev)
    first[list(firsts)] = 1.0
    kw = dict(crossfade=crossfade, **FLAGS)
    Y = am.assembly_mac_cuda(idx, w, t, Xu, Xd, first, n_fft, **kw)
    Y64 = am.assembly_mac_reference(idx, w.double(), t,
                                    Xu.to(torch.complex128),
                                    Xd.to(torch.complex128), first, n_fft,
                                    **kw)
    assert Y.shape == (rows, 2, n_fft // 2 + 1)
    assert _snr_db(Y64, Y) >= 100
    assert torch.equal(Y, am.assembly_mac_cuda(idx, w, t, Xu, Xd, first,
                                               n_fft, **kw))


@pytest.mark.gpu
def test_assembly_mac_at_the_mode_boundary(long_tables):
    """n_fft 16384, the largest register plan, and 32768, the split mode,
    on the same table and rows, each against the float64 plain version."""
    t = long_tables[128]
    for n_fft in (16384, 32768):
        assert mac_plan(t.taps, n_fft).register == (n_fft == 16384)
        idx, w, Xu, Xd = _mac_inputs(t, 40, n_fft, seed=9)
        first = torch.zeros(40, device=t.device)
        first[[0, 17]] = 1.0
        kw = dict(crossfade=True, **FLAGS)
        Y = am.assembly_mac_cuda(idx, w, t, Xu, Xd, first, n_fft, **kw)
        Y64 = am.assembly_mac_reference(idx, w.double(), t,
                                        Xu.to(torch.complex128),
                                        Xd.to(torch.complex128), first,
                                        n_fft, **kw)
        assert _snr_db(Y64, Y) >= 100, n_fft


@pytest.mark.gpu
def test_assembly_mac_refuses_another_plan(long_tables, monkeypatch):
    """The entry point takes only the plan it was compiled for: another
    thread count or blocks per SM raises, and nothing is launched."""
    t = long_tables[128]
    idx, w, Xu, Xd = _mac_inputs(t, 8, 4096, seed=3)
    first = torch.zeros(8, device=t.device)
    plan = mac_plan(t.taps, 4096)
    for wrong in (dict(threads=2 * plan.threads),
                  dict(blocks_per_sm=plan.blocks_per_sm + 1)):
        monkeypatch.setattr(am, "mac_plan", lambda taps, n, wrong=wrong:
                            dataclasses.replace(plan, **wrong))
        before = am.launches["assembly_mac"]
        with pytest.raises(RuntimeError):
            am.assembly_mac_cuda(idx, w, t, Xu, Xd, first, 4096,
                                 crossfade=True, **FLAGS)
        assert am.launches["assembly_mac"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("taps,Bn", [(128, 2048), (2048, 256)])
def test_assembly_mac_render_matches_plain(long_tables, taps, Bn):
    t = long_tables[taps]
    rng = np.random.default_rng(taps)
    S, nb = 3, 11
    xbs = torch.from_numpy(rng.standard_normal((S, nb, Bn)).astype(
        np.float32)).to(t.device)
    idx, w = _rows(t, (S, nb), seed=Bn)
    n_fft = _n_fft(t, Bn)
    assert n_fft == 4096
    kw = dict(crossfade=True, **FLAGS)
    before = dict(am.launches)
    y = am.assembly_mac_render(xbs, idx, w, t, n_fft, **kw)
    assert am.launches["assembly_mac"] == before["assembly_mac"] + 1
    y64 = am.assembly_mac_render_reference(xbs.double(), idx, w, t, n_fft,
                                           **kw)
    assert y.shape == y64.shape == (S, 2, (nb - 1) * Bn + n_fft)
    assert _snr_db(y64, y) >= 100


@pytest.mark.gpu
@pytest.mark.parametrize("work", [64, 256])
def test_split_mode_mix_and_assembly_mac(table, monkeypatch, work):
    """block_spectra_mix, the summing spectra_inverse and assembly_mac with
    their buffers in the device scratch, forced at small shapes."""
    monkeypatch.setattr(_layout, "force_work", work)
    xbs, idx, w = _inputs(table, 5, 6, seed=work + 1)
    n_fft = _n_fft(table, B)
    kw = dict(crossfade=True, **FLAGS)
    y = bs.scene_step_render(xbs, idx, w, table, n_fft, **kw)
    assert _snr_db(bs.scene_step_render_reference(xbs.double(), idx, w, table,
                                                  n_fft, **kw), y) >= 100
    idx, w, Xu, Xd = _mac_inputs(table, 23, 4096, seed=work)
    first = torch.zeros(23, device=table.device)
    first[[7, 8]] = 1.0
    Y = am.assembly_mac_cuda(idx, w, table, Xu, Xd, first, 4096, **kw)
    Y64 = am.assembly_mac_reference(idx, w.double(), table,
                                    Xu.to(torch.complex128),
                                    Xd.to(torch.complex128), first, 4096, **kw)
    assert _snr_db(Y64, Y) >= 100


@pytest.mark.gpu
def test_mix_and_natural_order_routes_reject_bad_inputs(table):
    xbs, idx, w = _inputs(table, 2, 4, seed=8)
    n_fft = _n_fft(table, B)
    kw = dict(crossfade=True, **FLAGS)
    with pytest.raises(TypeError):
        bs.scene_step_render(xbs.double(), idx, w, table, n_fft, **kw)
    with pytest.raises(ValueError):
        bs.scene_step_render(xbs.cpu(), idx, w, table, n_fft, **kw)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    with pytest.raises(ValueError):
        bs.block_spectra_mix_cuda(xbs, H[:1], n_fft, crossfade=True, chunk=1)
    with pytest.raises(ValueError):
        bs.block_spectra_mix_cuda(xbs, H, n_fft, crossfade=True, chunk=0)
    with pytest.raises(TypeError):
        am.assembly_mac_render(xbs.double(), idx, w, table, n_fft, **kw)
    flat_idx, flat_w, Xu, Xd = _mac_inputs(table, 8, n_fft, seed=1)
    first = torch.zeros(8, device=table.device)
    with pytest.raises(ValueError):
        am.assembly_mac_cuda(flat_idx, flat_w, table, Xu, Xd[:4], first,
                             n_fft, **kw)
    with pytest.raises(TypeError):
        am.assembly_mac_cuda(flat_idx, flat_w, table, Xu, Xd, first.double(),
                             n_fft, **kw)
    with pytest.raises(ValueError):
        am.assembly_mac_cuda(flat_idx, flat_w, table, Xu, Xd, first.cpu(),
                             n_fft, **kw)


@pytest.mark.gpu
def test_long_filters_render_on_the_card():
    """The sizes that exceed shared memory: `render_streamed` at 44,100
    taps (L = 65536, P = 87 at stream_block 512) and a trajectory at
    16,384 taps, B = 1024 (n_fft = L = 32768), each against the float64
    plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for taps, core, render, B_, nb in (
            (44100, _partitioned_core, pc.partitioned_render_reference, 512, 24),
            (16384, _trajectory_core, br.block_render_reference, 1024, 12)):
        t = TorchTable.from_hrir_table(
            tinaural_torch.load_hrir_set("synthetic", taps=taps), dev)
        cfg = tinaural_torch.RenderConfig(block_size=B_, stream_block=B_)
        xb = torch.from_numpy(rng.standard_normal((nb, B_)).astype(
            np.float32)).to(dev)
        dirs = torch.from_numpy(np.stack(
            [np.linspace(0, 300, nb), np.linspace(-30, 60, nb)], 1).astype(
                np.float32)).to(dev)
        y = core(t, xb, dirs, cfg)
        y64 = core(t, xb.double(), dirs, cfg, render=render)
        assert bool(torch.isfinite(y).all())
        assert _snr_db(y64, y) >= 100, taps


# ----------------------------------------------------------- spectra_inverse


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spectra(shape, n_fft, seed, dev):
    """Half spectra of seeded random frames: (*shape, 2, F) complex64."""
    x = np.random.default_rng(seed).standard_normal((*shape, 2, n_fft))
    return torch.fft.rfft(torch.from_numpy(x)).to(torch.complex64).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("log2n", range(1, 18))
def test_spectra_inverse_every_size(cuda, log2n):
    """spectra_inverse against the float64 plain version at every power of
    two 2 … 16384 (the register kernel) and 32768 … 131072 (the cluster
    mode): 1, 7 and, up to n_fft 2048, 8193 rows, so the last CUDA block
    holds idle rows; summed over 2 and 8 terms; equal bits over two
    calls."""
    n = 1 << log2n
    for rows in (1, 7) + ((8193,) if n <= 2048 else ()):
        Y = _spectra((rows,), n, log2n * 10 + rows, cuda)
        got = bs.spectra_inverse_cuda(Y, n)
        assert got.shape == (rows, 2, n)
        f64 = bs.spectra_inverse_reference(Y.to(torch.complex128), n)
        assert _snr_db(f64, got) >= 120, (n, rows)
        assert torch.equal(got, bs.spectra_inverse_cuda(Y, n))
    for terms in (2, 8):
        P = _spectra((terms, 5), n, log2n * 10 + terms, cuda)
        got = bs.spectra_inverse_cuda(P, n, summed=True)
        assert got.shape == (5, 2, n)
        f64 = bs.spectra_inverse_reference(P.to(torch.complex128).sum(0), n)
        assert _snr_db(f64, got) >= 120, (n, terms)
        assert torch.equal(got, bs.spectra_inverse_cuda(P, n, summed=True))


@pytest.mark.gpu
def test_spectra_inverse_rejects_bad_inputs(cuda):
    Y = _spectra((3,), 64, 1, cuda)
    with pytest.raises(TypeError):
        bs.spectra_inverse_cuda(Y.to(torch.complex128), 64)
    with pytest.raises(ValueError):
        bs.spectra_inverse_cuda(Y, 128)  # F does not match n_fft
    with pytest.raises(ValueError):
        bs.spectra_inverse_cuda(Y[..., :-1].contiguous(), 62)  # not 2^k
    with pytest.raises(ValueError):
        bs.spectra_inverse_cuda(Y[0], 64, summed=True)  # no row axis
    with pytest.raises(ValueError):
        bs.spectra_inverse_cuda(Y.cpu(), 64)
    with pytest.raises(ValueError):
        bs.spectra_inverse_cuda(Y[:, :, ::2], 32)  # not contiguous


# ------------------------------------------------------------ cluster mode


@pytest.mark.gpu
def test_cluster_mode_boundaries(long_tables):
    """Each side of the cluster mode's lower edge against the float64
    plain version: spectra_inverse at 16384 (one block per row) and 32768
    (a cluster of 2); assemble_partitions at L 8192 (the shared mode) and
    16384 (a cluster of 1)."""
    dev = long_tables[128].device
    for n in (16384, 32768):
        assert inverse_plan(n).ranks == n // 16384
        Y = _spectra((3,), n, n, dev)
        f64 = bs.spectra_inverse_reference(Y.to(torch.complex128), n)
        assert _snr_db(f64, bs.spectra_inverse_cuda(Y, n)) >= 120, n
    for taps, L in ((8000, 8192), (9000, 16384)):
        plan = partitions_plan(taps, 512)
        assert plan.L == L and plan.cluster == (L == 16384)
        t = long_tables[taps]
        idx, w = _rows(t, (5,), seed=taps)
        hr, hi = pc.assemble_partitions_cuda(idx, w, t, 512, **FLAGS)
        r64, i64 = pc.assemble_partitions_reference(idx, w.double(), t, 512,
                                                    **FLAGS)
        assert _snr_db(torch.complex(r64, i64), torch.complex(hr, hi)) >= 100


@pytest.mark.gpu
def test_cluster_mode_refuses_another_plan(long_tables, monkeypatch):
    """The entry points take only the cluster plan they were compiled for:
    another cluster size raises, and nothing is launched."""
    dev = long_tables[128].device
    Y = _spectra((2,), 32768, 3, dev)
    right = inverse_plan(32768)
    monkeypatch.setattr(bs, "inverse_plan", lambda n: dataclasses.replace(
        right, ranks=4))
    before = bs.launches["spectra_inverse"]
    with pytest.raises(RuntimeError):
        bs.spectra_inverse_cuda(Y, 32768)
    assert bs.launches["spectra_inverse"] == before
    t = long_tables[9000]
    idx, w = _rows(t, (2,), seed=1)
    plan = partitions_plan(9000, 512)
    monkeypatch.setattr(pc, "partitions_plan", lambda taps, B:
                        dataclasses.replace(plan, ranks=2))
    before = pc.launches["assemble_partitions"]
    with pytest.raises(RuntimeError):
        pc.assemble_partitions_cuda(idx, w, t, 512, **FLAGS)
    assert pc.launches["assemble_partitions"] == before


@pytest.mark.gpu
def test_forced_split_mode_at_cluster_sizes(long_tables, monkeypatch):
    """force_work still takes the split mode where the cluster mode would
    run: spectra_inverse at 32768 and 65536, assemble_partitions at
    16,384 and 44,100 taps, each against the float64 plain version."""
    monkeypatch.setattr(_layout, "force_work", _layout.SPLIT_WORK)
    dev = long_tables[128].device
    for n in (32768, 65536):
        Y = _spectra((3,), n, n + 1, dev)
        f64 = bs.spectra_inverse_reference(Y.to(torch.complex128), n)
        assert _snr_db(f64, bs.spectra_inverse_cuda(Y, n)) >= 120, n
    for taps in (16384, 44100):
        t = long_tables[taps]
        idx, w = _rows(t, (3,), seed=taps + 1)
        hr, hi = pc.assemble_partitions_cuda(idx, w, t, 512, **FLAGS)
        r64, i64 = pc.assemble_partitions_reference(idx, w.double(), t, 512,
                                                    **FLAGS)
        assert _snr_db(torch.complex(r64, i64), torch.complex(hr, hi)) >= 100

"""The CUDA kernels against their plain versions, on a card: the block
render's three, the partitioned convolution's three (the streaming step
with its hold step at P = 1, 5 and 9, S = 1 and block 128, a batched
stream's offline render, and the partitioned offline render, chunked and
whole), the block step's two with the per-source overlap-add (their
register bodies at every n_fft 128 … 16384, at the mode boundaries and
under a refused plan), `overlap_add` alone equal in bits to its plain
version at B 1 … 2048 and k 2, 4 and 32 on its vector and scalar bodies
(a frames view off alignment) and under a refused plan, the scene
mixdown's `block_spectra_mix` with the summing `spectra_inverse`, the
natural-order `assembly_mac` (its register plans, and its cluster mode at
n_fft 32768, 65536 and 131072), B1's `assemble_filters` and
`block_spectra_mix_inverse` in their cluster mode at the same sizes
(dir_rate 1, 2 and 4, equal in bits over two calls, under a refused plan
and forced back to the split mode), `spectra_inverse` alone at every FFT
size, and `assemble_partitions`' register body at every (L, B) pair with
its refusal of another plan; each family again in the split buffer mode, forced at small shapes,
and at the sizes that need it (a 44,100-tap `render_streamed`, a
16,384-tap trajectory); the cluster mode of `spectra_inverse` and
`assemble_partitions` at its edges, under a refused plan, and forced back
to the split mode; and the dir_rate row map (one filter per group of k
blocks) of B1's, the block step's, the scene mixdown's and the
partitioned kernels at k = 2, 4 and 8, nb no multiple of k, in chunks,
in B1's cluster mode at n_fft 32768 and `assemble_partitions`' cluster
mode, each against the float64 plain path at k = 1 on the snapped
track; the CLI's `render` and `sweep` on the card (their launches, and
within 1 int16 LSB of the API); `fit`'s step and loop on CUDA tensors
(the loss's plain route), against the CPU's step; a `utils.profiling.trace`
of a render naming its kernels; the host syncs of a trajectory and a
scene, counted by torch's sync debug mode and by the program; the blocks
`_blockify` frames on the card, equal in bits to the host-padded blocks,
with its host time a call; and the
parallel layer in a group of one over NCCL against the unsharded entry
points.

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
from tinaural_torch.ops.conv_plan import conv_plan, stream_launch
from tinaural_torch.ops.mac_plan import mac_plan
from tinaural_torch.ops.ola_plan import ola_plan
from tinaural_torch.ops.partitions_plan import partitions_plan
from tinaural_torch.ops.render_plan import filters_plan, mix_plan
from tinaural_torch.ops.spectra_inverse import inverse_plan
from tinaural_torch.ops.step_plan import pruned_plan, step_plan

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
    """n_fft 16384, the largest register plan, and 32768 (L = 4096 < n:
    `assemble_filters` in the split mode, `block_spectra_mix_inverse` in
    the cluster mode) on the same table, rows and blocks: both kernels and
    the whole render against the float64 plain version."""
    t = long_tables[2048]
    xbs, idx, w = _inputs(t, 2, 6, seed=11)
    for n in (16384, 32768):
        assert filters_plan(t.taps, n).register == (n == 16384)
        assert not filters_plan(t.taps, n).cluster
        assert mix_plan(n).register == (n == 16384)
        assert mix_plan(n).cluster == (n == 32768)
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


# ------------------------------------------------------ B1's cluster mode


def _cluster_rows(long_tables, taps, S, nb, k, seed):
    """(S, nb, B) blocks and ⌈nb/k⌉ rows a source on the synthetic table
    of ``taps`` taps, or at 70,000 taps on a random table whose delays
    and weights are exact in float32 (`_exact_delay_inputs`)."""
    if taps != 70000:
        return (long_tables[taps], *_group_rows(long_tables[taps], S, nb, k,
                                                seed))
    fnb = br.filter_rows(nb, k)
    dev = long_tables[128].device
    t, idx, w = _exact_delay_inputs(taps, S * fnb, seed, dev)
    xbs = _inputs(long_tables[128], S, nb, seed)[0]
    return t, xbs, idx.reshape(S, fnb, 4), w.reshape(S, fnb, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("taps,n_fft,S,nb,crossfade,k", [
    (16384, 32768, 1, 128, True, 1), (16384, 32768, 3, 21, True, 4),
    (16384, 32768, 2, 13, False, 1), (16384, 32768, 4, 9, True, 2),
    (44100, 65536, 2, 9, True, 1), (44100, 65536, 3, 13, True, 4),
    (44100, 65536, 2, 5, False, 4), (70000, 131072, 2, 5, True, 1)])
def test_block_render_cluster_mode_matches_plain(long_tables, taps, n_fft, S,
                                                 nb, crossfade, k):
    """B1's two FFT kernels in the cluster mode (n_fft = L 32768, 65536
    and 131072: clusters of 2, 4 and 8), at dir_rate 1, 2 and 4 with nb no
    multiple of k: `assemble_filters` on ⌈nb/k⌉ rows a source against its
    float64 plain version, `block_spectra_mix_inverse` on those filters
    against its float64 plain version, each ≥ 100 dB and equal in bits
    over two calls, then the route against the float64 plain path with
    one launch of each kernel."""
    t, xbs, idx, w = _cluster_rows(long_tables, taps, S, nb, k,
                                   seed=taps + S * 100 + nb + k)
    assert filters_plan(t.taps, n_fft).cluster and mix_plan(n_fft).cluster
    assert _n_fft(t, B) == n_fft
    H = br.assemble_filters_cuda(idx, w, t, n_fft, **FLAGS)
    H64 = br.assemble_filters_reference(idx, w.double(), t, n_fft, **FLAGS)
    assert _snr_db(H64, H) >= 100
    assert torch.equal(H, br.assemble_filters_cuda(idx, w, t, n_fft, **FLAGS))
    mix = dict(crossfade=crossfade, dir_rate=k)
    frames = br.block_spectra_mix_inverse_cuda(xbs, H, n_fft, **mix)
    f64 = br.block_spectra_mix_inverse_reference(
        xbs.double(), H.to(torch.complex128), n_fft, **mix)
    assert _snr_db(f64, frames) >= 100
    assert torch.equal(frames, br.block_spectra_mix_inverse_cuda(
        xbs, H, n_fft, **mix))
    before = dict(br.launches)
    y = br.block_render(xbs, idx, w, t, n_fft, **mix, **FLAGS)
    torch.cuda.synchronize()
    assert all(br.launches[n] == before[n] + 1 for n in br.KERNELS)
    y64 = br.block_render_reference(xbs.double(), idx, w, t, n_fft, **mix,
                                    **FLAGS)
    assert _snr_db(y64, y) >= 100


@pytest.mark.gpu
@pytest.mark.parametrize("taps,n_fft", [(16384, 32768), (44100, 65536)])
def test_block_render_forced_split_at_cluster_sizes(long_tables, monkeypatch,
                                                    taps, n_fft):
    """force_work still takes the split mode where B1's cluster mode would
    run: both kernels against their float64 plain versions, at dir_rate 1
    and 4."""
    monkeypatch.setattr(_layout, "force_work", _layout.SPLIT_WORK)
    for k in (1, 4):
        t, xbs, idx, w = _cluster_rows(long_tables, taps, 2, 9, k, seed=k)
        H = br.assemble_filters_cuda(idx, w, t, n_fft, **FLAGS)
        H64 = br.assemble_filters_reference(idx, w.double(), t, n_fft,
                                            **FLAGS)
        assert _snr_db(H64, H) >= 100, k
        frames = br.block_spectra_mix_inverse_cuda(xbs, H, n_fft,
                                                   crossfade=True, dir_rate=k)
        f64 = br.block_spectra_mix_inverse_reference(
            xbs.double(), H.to(torch.complex128), n_fft, crossfade=True,
            dir_rate=k)
        assert _snr_db(f64, frames) >= 100, k


@pytest.mark.gpu
def test_block_render_cluster_mode_refuses_another_plan(long_tables,
                                                        monkeypatch):
    """The cluster entry points take only the plans they were compiled
    for: other ranks, threads, rows per block or blocks per SM raise, and
    nothing is launched."""
    t, xbs, idx, w = _cluster_rows(long_tables, 16384, 1, 4, 1, seed=5)
    n_fft = _n_fft(t, B)
    H = br.assemble_filters_cuda(idx, w, t, n_fft, **FLAGS)
    plan, mplan = filters_plan(t.taps, n_fft), mix_plan(n_fft)
    for wrong in (dict(ranks=4), dict(ranks=0), dict(threads=512),
                  dict(rows_per_block=2), dict(blocks_per_sm=2)):
        monkeypatch.setattr(br, "filters_plan", lambda taps, n, wrong=wrong:
                            dataclasses.replace(plan, **wrong))
        before = br.launches["assemble_filters"]
        with pytest.raises(RuntimeError):
            br.assemble_filters_cuda(idx, w, t, n_fft, **FLAGS)
        assert br.launches["assemble_filters"] == before, wrong
    for wrong in (dict(ranks=4), dict(ranks=0), dict(threads=512),
                  dict(blocks_per_sm=2)):
        monkeypatch.setattr(br, "mix_plan", lambda n, wrong=wrong:
                            dataclasses.replace(mplan, **wrong))
        before = br.launches["block_spectra_mix_inverse"]
        with pytest.raises(RuntimeError):
            br.block_spectra_mix_inverse_cuda(xbs, H, n_fft, crossfade=True)
        assert br.launches["block_spectra_mix_inverse"] == before, wrong


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
                                    (128, 128), (16384, 512), (44100, 512),
                                    (2048, 32), (128, 4096)])
def test_assemble_partitions_matches_plain(long_tables, taps, B):
    """Against the float64 plain version: the shared mode up to 2048 taps
    (the register body at B 64 … 2048, the radix-2 body at B 32 and
    4096), the cluster mode at 16,384 taps (L 32768, 2 blocks per row)
    and 44,100 (L 65536, 4 blocks)."""
    t = long_tables[taps]
    assert partitions_plan(taps, B).cluster == (taps > 8128)
    idx, w = _rows(t, (6,), seed=B)
    hr, hi = pc.assemble_partitions_cuda(idx, w, t, B, **FLAGS)
    r64, i64 = pc.assemble_partitions_reference(idx, w.double(), t, B, **FLAGS)
    assert hr.shape == (6, -(-(taps + 64) // B), 2, B + 1)
    assert _snr_db(torch.complex(r64, i64), torch.complex(hr, hi)) >= 100


def _exact_delay_inputs(taps: int, rows: int, seed: int, dev):
    """A random table whose delays, and rows whose weights, lie on a 1/16
    grid, so that every row's weighted delay is exact in float32. With the
    table's delays of 0 … 56 samples, the float32 rounding of a delay near
    40 alone puts the float64 reference 88–97 dB away from every float32
    version (the plain one too) at some rows; on this grid the comparison
    measures the kernel's arithmetic."""
    t = _random_table(taps, seed=seed, device=dev)
    t = dataclasses.replace(t, delays=torch.round(t.delays * 16) / 16)
    rng = np.random.default_rng(rows + seed)
    cuts = np.sort(np.stack([rng.choice(np.arange(1, 16), 3, replace=False)
                             for _ in range(rows)]), axis=1)
    counts = np.diff(np.concatenate([np.zeros((rows, 1)), cuts,
                                     np.full((rows, 1), 16)], axis=1), axis=1)
    idx = torch.from_numpy(rng.integers(0, 8, (rows, 4)).astype(np.int32))
    w = torch.from_numpy((counts / 16).astype(np.float32))
    return t, idx.to(dev), w.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("log2L", range(7, 14))
def test_assemble_partitions_register_every_size(long_tables, log2L):
    """The shared mode's register body at every L 128 … 8192 and every B
    64 … 2048, t_pad just above L/2 or at L, on 1 row, 7 rows and the
    most rows per block + 1 (no SM count: sm_count 0), against the
    float64 plain version with the rows' delays exact in float32: ≥ 100
    dB."""
    L = 1 << log2L
    dev = long_tables[128].device
    for i, B in enumerate(64 << k for k in range(6)):
        taps = L - 64 if i % 2 else max(1, L // 2 - 63)
        plan = partitions_plan(taps, B)
        assert plan.register and plan.L == L
        for rows in (1, 7, plan.rows_per_block(10 ** 6, 0) + 1):
            t, idx, w = _exact_delay_inputs(taps, rows, i, dev)
            hr, hi = pc.assemble_partitions_cuda(idx, w, t, B, **FLAGS)
            ref = torch.complex(*pc.assemble_partitions_reference(
                idx, w.double(), t, B, **FLAGS))
            s = _snr_db(ref, torch.complex(hr, hi))
            assert s >= 100, (L, B, rows, s)


@pytest.mark.gpu
def test_assemble_partitions_register_refuses_another_plan(long_tables,
                                                           monkeypatch):
    """The register body takes only the plan it was compiled for: other
    threads, or rows per block that are not a power of two up to the
    compiled most, raise, and nothing is launched."""
    t = long_tables[2048]
    idx, w = _rows(t, (64,), seed=2)
    plan = partitions_plan(2048, 256)
    G = plan.rows_per_block(64, 132)
    assert G == 1
    # (G, threads, shared figure) of the launch
    for bad in ((G, plan.block_threads(G) + 32, plan.block_shared_f2(G)),
                *((g, plan.block_threads(g), plan.block_shared_f2(g))
                  for g in (3, 4))):
        with monkeypatch.context() as m:
            m.setattr(pc, "launch", lambda *args, bad=bad: bad)
            before = pc.launches["assemble_partitions"]
            with pytest.raises(RuntimeError):
                pc.assemble_partitions_cuda(idx, w, t, 256, **FLAGS)
            assert pc.launches["assemble_partitions"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("taps,B,S", [(128, 256, 5), (2048, 512, 3),
                                      (2048, 256, 1), (128, 128, 2),
                                      (128, 64, 3), (128, 2048, 2),
                                      (128, 32, 2), (128, 4096, 1),
                                      (128, 256, 301), (44100, 512, 1)])
def test_stream_conv_chain_matches_plain(long_tables, taps, B, S):
    """Update, update, hold, update: every kernel output against the plain
    float64 step on the same carried state, over a chain that carries the
    delay line and the previous filter. The register body at B 64 … 2048
    (its edges, P = 1, 3, 9 and (j)'s 87, S = 1, odd S, and 301 streams in
    blocks of G = 2 with one stream in the last), the radix-2 body at B
    32 and 4096."""
    t = long_tables[taps]
    G = stream_launch(B, -(-(taps + 64) // B), S, 132)[0]
    assert (G > 0) == (64 <= B <= 2048) and (G == 2) == (S == 301)
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
                                              (128, 128, True),
                                              (128, 64, True),
                                              (128, 2048, True),
                                              (128, 32, True),
                                              (128, 4096, False),
                                              (44100, 512, True)])
def test_partitioned_conv_matches_plain(long_tables, taps, B, crossfade,
                                        monkeypatch):
    """`partitioned_conv` (with `frame_spectra` in the register range: B
    64 … 2048, its edges, P = 1, 3, 5, 9 and (j)'s 87; the radix-2 body
    at B 32, the split mode at B 4096) against its float64 plain version;
    `partitioned_render` whole and in chunks of 3 blocks, equal in bits,
    against the float64 plain render; then at dir_rate 4, whole and in
    chunks of two groups, equal in bits, against the float64 plain
    `partitioned_conv` on the render's own partitions (the float32
    assembly of 10 rows alone may cost a few dB against float64)."""
    t = long_tables[taps]
    nb = 40
    idx, w = _rows(t, (nb,), seed=nb + B)
    xb = torch.from_numpy(np.random.default_rng(B).standard_normal(
        (nb, B)).astype(np.float32)).to(t.device)
    hr, hi = pc.assemble_partitions_cuda(idx, w, t, B, **FLAGS)
    register = conv_plan(B, hr.shape[1]).register
    if register:  # frames 6 … 39; transforms pair frames 2m and 2m + 1
        X = pc.frame_spectra_cuda(xb, 6, nb)
        X64 = pc.frame_spectra_reference(xb.double(), 6, nb)
        assert X.shape == X64.shape and _snr_db(X64, X) >= 100
        with pytest.raises(ValueError):
            pc.frame_spectra_cuda(xb, 7, nb)
    before = dict(pc.launches)
    y = pc.partitioned_conv_cuda(xb, hr, hi, crossfade=crossfade)
    assert pc.launches["partitioned_conv"] == before["partitioned_conv"] + 1
    assert (pc.launches["frame_spectra"]
            == before["frame_spectra"] + int(register))
    y64 = pc.partitioned_conv_reference(xb.double(), hr.double(), hi.double(),
                                        crossfade=crossfade)
    assert _snr_db(y64, y) >= 100
    kw = dict(crossfade=crossfade, **FLAGS)
    whole = pc.partitioned_render(xb, idx, w, t, **kw)
    with monkeypatch.context() as m:
        m.setattr(pc, "CHUNK_BYTES", 3 * hr[0].numel() * 8)  # 3 blocks
        chunked = pc.partitioned_render(xb, idx, w, t, **kw)
    assert torch.equal(whole, chunked)
    ref = pc.partitioned_render_reference(xb.double(), idx, w, t, **kw)
    assert _snr_db(ref, whole) >= 100
    idx4, w4 = idx[::4].contiguous(), w[::4].contiguous()
    whole = pc.partitioned_render(xb, idx4, w4, t, dir_rate=4, **kw)
    monkeypatch.setattr(pc, "CHUNK_BYTES", 2 * hr[0].numel() * 8)
    assert torch.equal(whole, pc.partitioned_render(xb, idx4, w4, t,
                                                    dir_rate=4, **kw))
    h4 = pc.assemble_partitions_cuda(idx4, w4, t, B, **FLAGS)
    ref = pc.partitioned_conv_reference(xb.double(), h4[0].double(),
                                        h4[1].double(), crossfade=crossfade,
                                        dir_rate=4)
    assert _snr_db(ref, whole) >= 100


@pytest.mark.gpu
def test_partitioned_register_kernels_refuse_another_plan(long_tables,
                                                          monkeypatch):
    """`stream_conv`, `frame_spectra` and `partitioned_conv` take only the
    plan they were compiled for: other G, threads or shared figures
    raise, and the kernel with the wrong plan is not launched."""
    t = long_tables[2048]
    S, B = 5, 256
    P = -(-(2048 + 64) // B)
    st = init_state(t, tinaural_torch.RenderConfig(stream_block=B), S)
    xb = torch.zeros((S, B), device=t.device)
    args = (xb, st.prev_in, st.fdl_re, st.fdl_im, st.prev_h_re,
            st.prev_h_im, st.started)
    plan = conv_plan(B, P)
    G = plan.streams_per_block(S, 132)
    good = (G, plan.threads(G), plan.shared_f2(G, plan.threads(G), True))
    for bad in ((G, good[1] + 32, good[2]), (3, *good[1:]),
                (4, plan.threads(4), good[2]), (G, good[1], good[2] + 1),
                (0, *good[1:])):
        with monkeypatch.context() as m:
            m.setattr(pc, "stream_launch", lambda *a, bad=bad: bad)
            before = pc.launches["stream_conv"]
            with pytest.raises(RuntimeError):
                pc.stream_hold(*args)
            assert pc.launches["stream_conv"] == before
    nb = 12
    xb = torch.zeros((nb, B), device=t.device)
    hr = torch.zeros((nb, P, 2, B + 1), device=t.device)
    threads = plan.part_threads(nb, 132)
    f2 = plan.shared_f2(1, threads, False)
    for bad in ((threads + 32, f2), (threads, f2 + 1), (0, f2), (32, f2)):
        with monkeypatch.context() as m:
            m.setattr(pc, "conv_launch", lambda *a, bad=bad: bad)
            before = pc.launches["partitioned_conv"]
            with pytest.raises(RuntimeError):
                pc.partitioned_conv_cuda(xb, hr, hr, crossfade=True)
            assert pc.launches["partitioned_conv"] == before
    Gf = plan.frame_groups(nb // 2, 132)
    for bad in ((Gf, Gf * 32 + 32, Gf * 544), (Gf, Gf * 32, Gf * 544 + 1),
                (3, 96, 3 * 544)):
        with monkeypatch.context() as m:
            m.setattr(pc, "frames_launch", lambda *a, bad=bad: bad)
            before = dict(pc.launches)
            with pytest.raises(RuntimeError):
                pc.partitioned_conv_cuda(xb, hr, hr, crossfade=True)
            assert pc.launches == before


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
    k = nb if one_filter else 1  # one filter per source: dir_rate nb
    if one_filter:
        idx, w = idx[:, :1].contiguous(), w[:, :1].contiguous()
    n_fft = _n_fft(table, B)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    Y = bs.block_spectra_cuda(xbs, H, n_fft, crossfade=crossfade, dir_rate=k)
    Y64 = bs.block_spectra_reference(xbs.double(), H.to(torch.complex128),
                                     n_fft, crossfade=crossfade, dir_rate=k)
    assert Y.shape == Y64.shape == (S, nb, 2, n_fft // 2 + 1)
    assert _snr_db(Y64, Y) >= 100
    frames = bs.spectra_inverse_cuda(Y, n_fft)
    f64 = bs.spectra_inverse_reference(Y.to(torch.complex128), n_fft)
    assert _snr_db(f64, frames) >= 100
    out = br.overlap_add_cuda(frames, B)
    ref = br.overlap_add(frames.transpose(1, 2), B)
    assert out.shape == (S, 2, (nb - 1) * B + n_fft)
    assert torch.equal(out, ref)
    before = (dict(br.launches), dict(bs.launches))
    y = bs.block_step_render(xbs, idx, w, table, n_fft, crossfade=crossfade,
                             dir_rate=k, **FLAGS)
    torch.cuda.synchronize()
    assert br.launches["assemble_filters"] == before[0]["assemble_filters"] + 1
    assert br.launches["overlap_add"] == before[0]["overlap_add"] + 1
    assert all(bs.launches[k] == before[1][k] + 1
               for k in ("block_spectra", "spectra_inverse"))
    assert bs.launches["block_spectra_mix"] == before[1]["block_spectra_mix"]
    y64 = bs.block_step_render_reference(xbs.double(), idx, w, table, n_fft,
                                         crossfade=crossfade, dir_rate=k,
                                         **FLAGS)
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
    k = nb if one_filter else 1  # one filter per source: dir_rate nb
    if one_filter:
        idx, w = idx[:, :1].contiguous(), w[:, :1].contiguous()
    n_fft = _n_fft(table, B)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    P = bs.block_spectra_mix_cuda(xbs, H, n_fft, crossfade=crossfade,
                                  chunk=chunk, dir_rate=k)
    P64 = bs.block_spectra_mix_reference(xbs.double(), H.to(torch.complex128),
                                         n_fft, crossfade=crossfade,
                                         chunk=chunk, dir_rate=k)
    assert P.shape == P64.shape == (-(-S // chunk), nb, 2, n_fft // 2 + 1)
    assert _snr_db(P64, P) >= 100
    frames = bs.spectra_inverse_cuda(P, n_fft, summed=True)
    f64 = bs.spectra_inverse_reference(P.to(torch.complex128).sum(0), n_fft)
    assert frames.shape == (nb, 2, n_fft) and _snr_db(f64, frames) >= 100
    kw = dict(crossfade=crossfade, dir_rate=k, **FLAGS)
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


# ----------------------------------------- the block step's register bodies


def _step_inputs(S, nb, n, k, seed, dev):
    """Blocks of B = n/2 samples and the filters `assemble_filters` makes
    on the card from `_exact_delay_inputs`' table and rows (⌈nb/k⌉ a
    source)."""
    fnb = -(-nb // k)
    t, idx, w = _exact_delay_inputs(n // 4, S * fnb, seed, dev)
    H = br.assemble_filters_cuda(idx.reshape(S, fnb, 4),
                                 w.reshape(S, fnb, 4), t, n, **FLAGS)
    xbs = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (S, nb, n // 2)).astype(np.float32)).to(dev)
    return xbs, H


def _check_step_kernels(xbs, H, n, crossfade, k, chunk, min_db=100):
    """Both kernels against their plain float32 and float64 versions (≥
    min_db), the mix kernel's partials equal in bits over two calls."""
    kw = dict(crossfade=crossfade, dir_rate=k)
    H64 = H.to(torch.complex128)
    Y = bs.block_spectra_cuda(xbs, H, n, **kw)
    for ref in (bs.block_spectra_reference(xbs, H, n, **kw),
                bs.block_spectra_reference(xbs.double(), H64, n, **kw)):
        assert _snr_db(ref, Y) >= min_db, (n, crossfade, k)
    P = bs.block_spectra_mix_cuda(xbs, H, n, chunk=chunk, **kw)
    for ref in (bs.block_spectra_mix_reference(xbs, H, n, chunk=chunk, **kw),
                bs.block_spectra_mix_reference(xbs.double(), H64, n,
                                               chunk=chunk, **kw)):
        assert _snr_db(ref, P) >= min_db, (n, crossfade, k, chunk)
    assert torch.equal(P, bs.block_spectra_mix_cuda(xbs, H, n, chunk=chunk,
                                                    **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("log2n", range(7, 15))
def test_block_step_register_kernels_every_size(cuda, log2n):
    """`block_spectra` and `block_spectra_mix` against their plain float32
    and float64 versions at every n_fft 128 … 16384 of the register
    bodies, B = n/2: 3 sources × 5 blocks (a partial last CUDA block of
    rows), crossfade on and off, dir_rate 1, 2 (nb no multiple of k) and
    ≥ nb, the mix on the scene route's chunk and in chunks of 2 (the last
    of one source); ≥ 100 dB, equal bits over two calls."""
    n = 1 << log2n
    assert step_plan(n, False).register and step_plan(n, True).register
    S, nb = 3, 5
    for k in (1, 2, 8):
        xbs, H = _step_inputs(S, nb, n, k, seed=log2n * 10 + k, dev=cuda)
        for crossfade in (True, False):
            for chunk in {bs.mix_chunk(S, nb, n, _layout.sm_count(cuda),
                                            n // 2, crossfade), 2}:
                _check_step_kernels(xbs, H, n, crossfade, k, chunk)


def _spy_slices(monkeypatch) -> list:
    """The split slices of every block-step launch's layout from now on (0:
    no scratch, the register or pruned body)."""
    seen, real = [], bs.layout

    def spy(*args):
        out = real(*args)
        seen.append(out[1])
        return out

    monkeypatch.setattr(bs, "layout", spy)
    return seen


@pytest.mark.gpu
def test_block_step_at_the_mode_boundaries(cuda, monkeypatch):
    """n_fft 16384 (the largest register plan), 32768 at B 16384 (the
    pruned mode at Q 16384, P 2: a block a residue) and a forced split
    mode at 2048, on both kernels against their plain versions; and B <
    128 (n_fft 64) on the radix-2 body in shared memory."""
    slices = _spy_slices(monkeypatch)
    for n, force in ((16384, 0), (32768, 0), (2048, 64), (64, 0)):
        monkeypatch.setattr(_layout, "force_work", force)
        assert step_plan(n, True).register == (128 <= n <= 16384)
        pruned = pruned_plan(n, True, n // 2) if n > 16384 else None
        assert (pruned is not None) == (n == 32768)
        assert pruned is None or (pruned.half and pruned.P == 2)
        del slices[:]
        rng = np.random.default_rng(n)
        S, nb, F = 3, 4, n // 2 + 1
        xbs = torch.from_numpy(rng.standard_normal((S, nb, n // 2)).astype(
            np.float32)).to(cuda)
        H = torch.from_numpy((rng.standard_normal((S, nb, 2, F))
                              + 1j * rng.standard_normal((S, nb, 2, F))
                              ).astype(np.complex64)).to(cuda)
        _check_step_kernels(xbs, H, n, True, 1, 2)
        assert slices and all((s > 0) == bool(force) for s in slices)


def _random_step_inputs(S, nb, B_, n, k, seed, dev):
    """Seeded blocks and random filter spectra (⌈nb/k⌉ a source)."""
    rng = np.random.default_rng(seed)
    fnb, F = -(-nb // k), n // 2 + 1
    xbs = torch.from_numpy(rng.standard_normal((S, nb, B_)).astype(
        np.float32)).to(dev)
    H = torch.from_numpy((rng.standard_normal((S, fnb, 2, F))
                          + 1j * rng.standard_normal((S, fnb, 2, F))
                          ).astype(np.complex64)).to(dev)
    return xbs, H


@pytest.mark.gpu
@pytest.mark.parametrize("n,B_", [(1 << 15, 1024), (1 << 16, 1024),
                                  (1 << 18, 1024), (1 << 15, 64),
                                  (1 << 16, 3000), (1 << 16, 16384)])
def test_block_step_pruned_mode(cuda, n, B_, monkeypatch):
    """Both kernels in the pruned mode (no scratch) at n_fft 32768, 65536
    and 262144 with B 1024 (Q 1024), and at Q 128, 4096 and 16384 (P 4: a
    block a residue, the mirror's transform first): 3 sources × 5 blocks,
    crossfade on and off, dir_rate 1 and 4 (nb no multiple of k), the mix
    in chunks of 2 and on the scene route's chunk, each against its plain
    float32 and float64 versions (≥ 100 dB) and equal in bits over two
    calls; then the split mode forced at the same shape (the radix-2 body
    over a scratch), against the same plain versions."""
    assert pruned_plan(n, False, B_) and pruned_plan(n, True, B_)
    slices = _spy_slices(monkeypatch)
    S, nb = 3, 5
    for k in (1, 4):
        xbs, H = _random_step_inputs(S, nb, B_, n, k, seed=n % 97 + B_ + k,
                                     dev=cuda)
        for crossfade in (True, False):
            kw = dict(crossfade=crossfade, dir_rate=k)
            Y = bs.block_spectra_cuda(xbs, H, n, **kw)
            assert torch.equal(Y, bs.block_spectra_cuda(xbs, H, n, **kw))
            chunks = {bs.mix_chunk(S, nb, n, _layout.sm_count(cuda), B_,
                                    crossfade), 2}
            for chunk in chunks:
                _check_step_kernels(xbs, H, n, crossfade, k, chunk)
    assert slices and not any(slices)
    monkeypatch.setattr(_layout, "force_work", _layout.SPLIT_WORK)
    xbs, H = _random_step_inputs(S, nb, B_, n, 1, seed=7, dev=cuda)
    _check_step_kernels(xbs, H, n, True, 1, 2)
    assert slices[-1] > 0 and slices[-2] > 0


@pytest.mark.gpu
def test_block_spectra_refuses_another_plan(table, monkeypatch):
    """`block_spectra`'s entry point takes only the plan it was compiled
    for: another thread count, more rows per block than the compiled most
    or other blocks per SM raises, and nothing is launched."""
    xbs, idx, w = _inputs(table, 2, 9, seed=14)
    n_fft = _n_fft(table, B)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    plan = step_plan(n_fft, False)
    for wrong, rows in ((dict(threads=2 * plan.threads), None),
                        (dict(blocks_per_sm=plan.blocks_per_sm + 1), None),
                        ({}, plan.max_per_block + 1)):
        monkeypatch.setattr(bs, "step_plan", lambda n, mix, wrong=wrong:
                            dataclasses.replace(step_plan(n, mix), **wrong))
        if rows:
            monkeypatch.setattr(bs, "spectra_rows", lambda *a, g=rows: g)
        before = bs.launches["block_spectra"]
        with pytest.raises(RuntimeError):
            bs.block_spectra_cuda(xbs, H, n_fft, crossfade=True)
        assert bs.launches["block_spectra"] == before


@pytest.mark.gpu
def test_block_spectra_mix_refuses_another_plan(table, monkeypatch):
    """`block_spectra_mix`'s entry point likewise: another thread count,
    more groups than the compiled most, or other blocks per SM raises,
    and nothing is launched."""
    xbs, idx, w = _inputs(table, 8, 9, seed=15)
    n_fft = _n_fft(table, B)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    plan = step_plan(n_fft, True)
    for wrong, groups in ((dict(threads=2 * plan.threads), None),
                          (dict(blocks_per_sm=plan.blocks_per_sm + 1), None),
                          ({}, plan.max_per_block + 1)):
        monkeypatch.setattr(bs, "step_plan", lambda n, mix, wrong=wrong:
                            dataclasses.replace(step_plan(n, mix), **wrong))
        if groups:
            monkeypatch.setattr(bs, "mix_groups", lambda *a, g=groups: g)
        before = bs.launches["block_spectra_mix"]
        with pytest.raises(RuntimeError):
            bs.block_spectra_mix_cuda(xbs, H, n_fft, crossfade=True, chunk=8)
        assert bs.launches["block_spectra_mix"] == before


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
    (12000, 16384, 101, (33, 34), True),
    (16384, 32768, 128, (37,), True), (16384, 32768, 131, (64, 65, 130), True),
    (16384, 32768, 70, (), False), (44100, 65536, 67, (1, 40, 41), True),
    (44100, 65536, 30, (7,), False), (70000, 131072, 21, (5, 6), True)])
def test_assembly_mac_matches_plain(long_tables, taps, n_fft, rows, firsts,
                                    crossfade):
    """Against the plain float64 version at every register plan shape the
    routes reach (n_fft 4096, 8192, 16384; L < n and L == n; crossfade on
    and off), with `first` at run boundaries and inside runs, row 0 passed
    as 0 where firsts omit it, and rows that are no multiple of the run
    (3001 rows run 8 at a time on 132 SMs × 3 blocks; 1001 rows 3 at a
    time, so 399 starts a run and 401 falls inside one); then the cluster
    mode (L == n): (j)'s 128 rows × 16,384 taps at n_fft 32768 (clusters
    of 2, runs of 2 on the H100's 66), 131 rows (65 starts a run's second
    row, 130 the last run), crossfade off; 44,100 taps at 65536 (clusters
    of 4) with `first` inside runs and crossfade off; 70,000 taps at
    131072 (clusters of 8, a random table with its delays exact in
    float32). Each also equal in bits over two calls."""
    dev = long_tables[128].device
    if taps in (128, 2048, 16384, 44100):  # synthetic tables
        t = long_tables[taps]
        idx, w, Xu, Xd = _mac_inputs(t, rows, n_fft, seed=rows + taps)
    elif n_fft > 16384:  # the cluster mode at 131072
        t, idx, w = _exact_delay_inputs(taps, rows, taps, dev)
        Xu, Xd = _mac_inputs(long_tables[128], rows, n_fft, seed=rows)[2:]
    else:  # L == n at 8192 and 16384
        t = _random_table(taps, seed=taps, device=dev)
        idx, w, Xu, Xd = (x.to(dev) for x in _random_inputs(t, rows, n_fft,
                                                            seed=rows))
    assert mac_plan(t.taps, n_fft).cluster == (n_fft > 16384)
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
def test_assembly_mac_at_the_mode_boundary(long_tables, monkeypatch):
    """Each side of the register plan's upper edge on 40 rows, each against
    the float64 plain version: n_fft 16384 at 128 taps (the largest
    register plan), 32768 at 16,384 taps (L == n: the cluster mode, a
    cluster of 2), 32768 at 128 taps (L = 256 < n: the split mode), and the
    16,384-tap shape again with the split mode forced."""
    for taps, n_fft, mode, force in ((128, 16384, "register", 0),
                                     (16384, 32768, "cluster", 0),
                                     (128, 32768, "split", 0),
                                     (16384, 32768, "split",
                                      _layout.SPLIT_WORK)):
        t = long_tables[taps]
        plan = mac_plan(t.taps, n_fft)
        assert (plan.register, plan.cluster) == (mode == "register",
                                                 mode == "cluster" or
                                                 bool(force))
        monkeypatch.setattr(_layout, "force_work", force)
        idx, w, Xu, Xd = _mac_inputs(t, 40, n_fft, seed=9)
        first = torch.zeros(40, device=t.device)
        first[[0, 17]] = 1.0
        kw = dict(crossfade=True, **FLAGS)
        Y = am.assembly_mac_cuda(idx, w, t, Xu, Xd, first, n_fft, **kw)
        Y64 = am.assembly_mac_reference(idx, w.double(), t,
                                        Xu.to(torch.complex128),
                                        Xd.to(torch.complex128), first,
                                        n_fft, **kw)
        assert _snr_db(Y64, Y) >= 100, (taps, n_fft, mode)


@pytest.mark.gpu
def test_assembly_mac_refuses_another_plan(long_tables, monkeypatch):
    """The entry point takes only the plan it was compiled for: another
    thread count or blocks per SM raises, and so do a cluster plan with
    other ranks or threads and a register plan with ranks at n_fft 4096;
    nothing is launched."""
    for taps, n_fft, wrongs in (
            (128, 4096, lambda p: (dict(threads=2 * p.threads),
                                   dict(blocks_per_sm=p.blocks_per_sm + 1),
                                   dict(ranks=2))),
            (16384, 32768, lambda p: (dict(ranks=4), dict(ranks=0),
                                      dict(threads=512),
                                      dict(blocks_per_sm=2)))):
        t = long_tables[taps]
        idx, w, Xu, Xd = _mac_inputs(t, 8, n_fft, seed=3)
        first = torch.zeros(8, device=t.device)
        plan = mac_plan(t.taps, n_fft)
        for wrong in wrongs(plan):
            monkeypatch.setattr(am, "mac_plan", lambda taps, n, wrong=wrong:
                                dataclasses.replace(plan, **wrong))
            before = am.launches["assembly_mac"]
            with pytest.raises(RuntimeError):
                am.assembly_mac_cuda(idx, w, t, Xu, Xd, first, n_fft,
                                     crossfade=True, **FLAGS)
            assert am.launches["assembly_mac"] == before, (n_fft, wrong)


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


# ------------------------------------------------------- the dir_rate row map


def _group_rows(t, S, nb, k, seed):
    """(S, nb, B) blocks and the rows and weights of ⌈nb/k⌉ random
    directions a source: one filter per group of k blocks."""
    xbs, _, _ = _inputs(t, S, nb, seed)
    idx, w = _rows(t, (S, br.filter_rows(nb, k)), seed + 1)
    return xbs, idx, w


def _per_block(t: torch.Tensor, nb: int, k: int) -> torch.Tensor:
    """Group rows (..., ⌈nb/k⌉, 4) → block rows (..., nb, 4): the snapped
    track's rows at dir_rate 1."""
    return t[..., torch.arange(nb, device=t.device) // k, :].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("S,nb,crossfade", [(1, 37, True), (3, 21, True),
                                            (2, 13, False)])
def test_dir_rate_block_render_matches_plain(table, k, S, nb, crossfade):
    """B1 at dir_rate k, nb no multiple of k: `assemble_filters` on ⌈nb/k⌉
    rows a source, `block_spectra_mix_inverse` reading row ⌊b/k⌋ and
    ⌊(b−1)/k⌋ against its float64 plain version, and the route against
    the float64 plain path at k = 1 with every block's row."""
    xbs, idx, w = _group_rows(table, S, nb, k, seed=S * 100 + nb + k)
    n_fft = _n_fft(table, B)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    assert H.shape[1] == -(-nb // k)
    frames = br.block_spectra_mix_inverse_cuda(xbs, H, n_fft,
                                               crossfade=crossfade,
                                               dir_rate=k)
    f64 = br.block_spectra_mix_inverse_reference(
        xbs.double(), H.to(torch.complex128), n_fft, crossfade=crossfade,
        dir_rate=k)
    assert _snr_db(f64, frames) >= 100
    kw = dict(crossfade=crossfade, **FLAGS)
    before = dict(br.launches)
    y = br.block_render(xbs, idx, w, table, n_fft, dir_rate=k, **kw)
    torch.cuda.synchronize()
    assert all(br.launches[n] == before[n] + 1 for n in br.KERNELS)
    y64 = br.block_render_reference(xbs.double(), _per_block(idx, nb, k),
                                    _per_block(w, nb, k), table, n_fft, **kw)
    assert _snr_db(y64, y) >= 100


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("S,nb,crossfade,chunk", [(3, 21, True, 2),
                                                  (5, 13, False, 5)])
def test_dir_rate_block_step_kernels_match_plain(table, k, S, nb, crossfade,
                                                 chunk):
    """`block_spectra` and `block_spectra_mix` at dir_rate k against their
    float64 plain versions, and both routes against the float64 plain
    path at k = 1 with every block's row."""
    xbs, idx, w = _group_rows(table, S, nb, k, seed=S * 10 + nb + k)
    n_fft = _n_fft(table, B)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    H64 = H.to(torch.complex128)
    Y = bs.block_spectra_cuda(xbs, H, n_fft, crossfade=crossfade, dir_rate=k)
    assert _snr_db(bs.block_spectra_reference(
        xbs.double(), H64, n_fft, crossfade=crossfade, dir_rate=k), Y) >= 100
    P = bs.block_spectra_mix_cuda(xbs, H, n_fft, crossfade=crossfade,
                                  chunk=chunk, dir_rate=k)
    assert _snr_db(bs.block_spectra_mix_reference(
        xbs.double(), H64, n_fft, crossfade=crossfade, chunk=chunk,
        dir_rate=k), P) >= 100
    kw = dict(crossfade=crossfade, **FLAGS)
    rows = (xbs.double(), _per_block(idx, nb, k), _per_block(w, nb, k))
    for route, plain in ((bs.block_step_render, bs.block_step_render_reference),
                         (bs.scene_step_render, bs.scene_step_render_reference)):
        y = route(xbs, idx, w, table, n_fft, dir_rate=k, **kw)
        assert _snr_db(plain(*rows, table, n_fft, **kw), y) >= 100


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("taps,B,nb", [(2048, 512, 37), (128, 256, 21)])
def test_dir_rate_partitioned_matches_plain(cuda, monkeypatch, k, taps, B,
                                            nb):
    """`partitioned_conv` at dir_rate k against its float64 plain version;
    `partitioned_render` in chunks of two groups (group-aligned starts, a
    partial last group) equal in bits to one chunk, and against the
    float64 plain path at k = 1 with every block's row, on
    `_exact_delay_inputs`' table and rows: with 5 filters for 37 blocks
    (k = 8) one row weighs a fifth of the error, and random synthetic
    rows once held that float64 comparison to 96.5 dB through the
    float32 assembly alone."""
    t, idx, w = _exact_delay_inputs(taps, -(-nb // k), nb + B + k, cuda)
    xb = torch.from_numpy(np.random.default_rng(B + k).standard_normal(
        (nb, B)).astype(np.float32)).to(cuda)
    hr, hi = pc.assemble_partitions_cuda(idx, w, t, B, **FLAGS)
    y = pc.partitioned_conv_cuda(xb, hr, hi, crossfade=True, dir_rate=k)
    y64 = pc.partitioned_conv_reference(xb.double(), hr.double(), hi.double(),
                                        crossfade=True, dir_rate=k)
    assert _snr_db(y64, y) >= 100
    kw = dict(crossfade=True, **FLAGS)
    whole = pc.partitioned_render(xb, idx, w, t, dir_rate=k, **kw)
    monkeypatch.setattr(pc, "CHUNK_BYTES", 2 * hr[0].numel() * 8)
    assert torch.equal(whole, pc.partitioned_render(xb, idx, w, t,
                                                    dir_rate=k, **kw))
    ref = pc.partitioned_render_reference(
        xb.double(), _per_block(idx, nb, k), _per_block(w, nb, k), t, **kw)
    assert _snr_db(ref, whole) >= 100


@pytest.mark.gpu
def test_dir_rate_above_shared_memory(table, long_tables, monkeypatch):
    """dir_rate 4, nb no multiple of 4, where the buffers leave shared
    memory: B1's cluster mode at n_fft 32768 (16,384 taps) and
    `assemble_partitions`' cluster mode (44,100 taps) through the
    renderer's cores against the float64 plain path at dir_rate 1 on the
    snapped track; then B1, the block-step routes and the partitioned
    route in the forced split mode."""
    dev = table.device
    rng = np.random.default_rng(12)
    nb = 13
    dirs = torch.from_numpy(np.stack(
        [np.linspace(0, 300, nb), np.linspace(-30, 60, nb)], 1).astype(
            np.float32)).to(dev)
    snapped = dirs[torch.arange(nb, device=dev) // 4 * 4]
    for taps, core, kern, plain, B_ in (
            (44100, _partitioned_core, pc.partitioned_render,
             pc.partitioned_render_reference, 512),
            (16384, _trajectory_core, br.block_render,
             br.block_render_reference, 1024)):
        t = long_tables[taps]
        cfg = tinaural_torch.RenderConfig(block_size=B_, stream_block=B_)
        xb = torch.from_numpy(rng.standard_normal((nb, B_)).astype(
            np.float32)).to(dev)
        y = core(t, xb, dirs, cfg.replace(dir_rate=4), render=kern)
        y64 = core(t, xb.double(), snapped, cfg, render=plain)
        assert bool(torch.isfinite(y).all())
        assert _snr_db(y64, y) >= 100, taps
    monkeypatch.setattr(_layout, "force_work", 64)
    xbs, idx, w = _group_rows(table, 3, 10, 4, seed=13)
    n_fft = _n_fft(table, B)
    kw = dict(crossfade=True, **FLAGS)
    rows = (xbs.double(), _per_block(idx, 10, 4), _per_block(w, 10, 4))
    for route, plain in ((br.block_render, br.block_render_reference),
                         (bs.block_step_render, bs.block_step_render_reference),
                         (bs.scene_step_render, bs.scene_step_render_reference)):
        y = route(xbs, idx, w, table, n_fft, dir_rate=4, **kw)
        assert _snr_db(plain(*rows, table, n_fft, **kw), y) >= 100
    t = long_tables[2048]
    idx, w = _rows(t, (3,), seed=14)
    xb = torch.from_numpy(rng.standard_normal((10, 256)).astype(
        np.float32)).to(dev)
    y = pc.partitioned_render(xb, idx, w, t, dir_rate=4, **kw)
    assert _snr_db(pc.partitioned_render_reference(
        xb.double(), _per_block(idx, 10, 4), _per_block(w, 10, 4), t, **kw),
        y) >= 100


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


# (S, nb, B, k) of the overlap_add checks: B 1, 2, 4, 1024 and 2048, k 2,
# 4 and 32, S 1 and 64; (a)'s 8192 frames and the scene mixdown's 128
OLA_CASES = ((1, 7, 1, 2), (64, 3, 1, 4), (64, 3, 2, 4), (1, 9, 2, 32),
             (3, 9, 4, 32), (64, 5, 4, 2), (1, 8192, 1024, 2),
             (1, 128, 1024, 2), (64, 5, 1024, 4), (1, 9, 1024, 32),
             (1, 300, 2048, 2), (64, 3, 2048, 4), (1, 3, 2048, 32))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("S,nb,hop,k", OLA_CASES)
def test_overlap_add_equals_plain_in_bits(cuda, S, nb, hop, k, offset):
    """`overlap_add_cuda` against the plain float32 version on the same
    frames: max abs err 0, on its vector bodies and, at B < 4 or from a
    frames view one float past 16-byte alignment, its scalar body."""
    n = k * hop
    g = torch.Generator(device=cuda)
    g.manual_seed(S * 1000 + nb + hop + k + offset)
    flat = torch.randn(offset + S * nb * 2 * n, generator=g, device=cuda)
    frames = flat[offset:].view(S, nb, 2, n)
    plan = ola_plan(S, nb, hop, n, offset == 0)
    assert (plan.vec == 1) == (offset == 1 or hop < 4)
    before = br.launches["overlap_add"]
    out = br.overlap_add_cuda(frames, hop)
    ref = br.overlap_add(frames.transpose(1, 2), hop)
    torch.cuda.synchronize()
    assert br.launches["overlap_add"] == before + 1
    assert out.shape == ref.shape == (S, 2, (nb - 1) * hop + n)
    assert float((out - ref).abs().max()) == 0 and torch.equal(out, ref)


@pytest.mark.gpu
def test_overlap_add_refuses_another_plan(cuda, monkeypatch):
    """The entry point takes only its own plan: another vector width or
    grid raises, and nothing is launched;
    a row of 2^31 frame values or more (checked from the shape, nothing
    allocated) and a hop that is no power of two raise too."""
    frames = torch.randn(2, 9, 2, 2048, device=cuda)
    plan = ola_plan(2, 9, 1024, 2048, True)
    for wrong in (dict(vec=1), dict(vec=8),
                  dict(grid=(plan.grid[0] + 1, plan.grid[1])),
                  dict(grid=(plan.grid[0] - 1, plan.grid[1]))):
        monkeypatch.setattr(br, "ola_plan", lambda *a, wrong=wrong:
                            dataclasses.replace(plan, **wrong))
        before = br.launches["overlap_add"]
        with pytest.raises(RuntimeError):
            br.overlap_add_cuda(frames, 1024)
        assert br.launches["overlap_add"] == before
    monkeypatch.undo()
    huge = torch.empty((1, 1, 1, 1), device=cuda).expand(1, 2**18, 2, 4096)
    with pytest.raises(ValueError, match="32-bit"):
        br.overlap_add_cuda(huge, 2048)
    with pytest.raises(ValueError, match="power of two"):
        br.overlap_add_cuda(torch.zeros((1, 3, 2, 12), device=cuda), 3)


def _cli_launches(fn) -> dict:
    """The kernel launches of one call of fn, counted from 0."""
    mods = (br, bs, pc, am)
    for m in mods:
        m.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: v for m in mods for k, v in m.launches.items() if v}


@pytest.mark.gpu
@pytest.mark.parametrize("cmd", ["render", "sweep"])
def test_cli_launches_its_kernels_and_matches_the_api(table, tmp_path, cmd):
    """The CLI on the card (no --cpu) launches the route's kernels and
    writes the port's API output to within 1 int16 LSB."""
    from scipy.io import wavfile

    from tinaural_torch.cli import main
    from tinaural_torch.utils import circular_sweep

    x = np.clip(np.random.default_rng(21).standard_normal(16 * B) * 0.2,
                -1, 1)
    src, out, ref = (tmp_path / f for f in ("in.wav", "out.wav", "ref.wav"))
    tinaural_torch.write_wav(src, 44100, x)
    _, x = tinaural_torch.read_wav(src)
    args = ["--az", "33", "--el", "12"] if cmd == "render" else \
        ["--start", "270", "--end", "90"]
    counts = _cli_launches(lambda: main([cmd, str(src), str(out), *args]))
    r = tinaural_torch.BinauralRenderer(table)
    y = (r.render(x, 33.0, 12.0) if cmd == "render" else
         r.render_trajectory(x, circular_sweep(16, 270.0, 90.0)))
    tinaural_torch.write_wav(ref, 44100, y.cpu().numpy().T)
    want = ({"assemble_filters": 1, "block_spectra": 1, "spectra_inverse": 1,
             "overlap_add": 1} if cmd == "render" else
            {"assemble_filters": 1, "block_spectra_mix_inverse": 1,
             "overlap_add": 1})
    assert counts == want
    ya = wavfile.read(out)[1].astype(np.int64)
    yb = wavfile.read(ref)[1].astype(np.int64)
    assert ya.shape == yb.shape and np.abs(ya - yb).max() <= 1


def _fit_inputs(dev, seed=3, S=2, nb=3):
    rng = np.random.default_rng(seed)
    xbs = torch.tensor(rng.standard_normal((S, nb, 256)), dtype=torch.float32,
                       device=dev)
    d = np.stack([rng.uniform(0, 360, S), rng.uniform(-40, 90, S)], 1)
    dirs = torch.tensor(np.broadcast_to(d[:, None], (S, nb, 2)).copy(),
                        dtype=torch.float32, device=dev)
    target = torch.tensor(rng.standard_normal((2, nb * 256)) * 0.1,
                          dtype=torch.float32, device=dev)
    return xbs, dirs, target


@pytest.mark.gpu
def test_train_step_on_the_card(table):
    """One step on CUDA tensors: finite, non-zero gradients on every leaf,
    and the loss of the CPU's step to rtol 1e-4 (the loss's plain route on
    either device)."""
    from tinaural_torch.models import fit

    cfg = tinaural_torch.RenderConfig(block_size=256)
    cpu_table = TorchTable.from_hrir_table(
        tinaural_torch.load_hrir_set("synthetic"), "cpu")
    losses, grads = {}, {}
    for dev, t in (("cuda", table), ("cpu", cpu_table)):
        params = fit.FitParams(*(p.requires_grad_()
                                 for p in fit.init_params(device=dev)))
        opt = torch.optim.Adam(params, lr=3e-2)
        loss = fit.train_step(params, opt, t, *_fit_inputs(dev), cfg)
        assert loss.device.type == dev
        losses[dev] = loss.item()
        grads[dev] = [p.grad.cpu() for p in params]
    for name, g in zip(fit.FitParams._fields, grads["cuda"]):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), name
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-4)


@pytest.mark.gpu
def test_fit_runs_on_cuda_tensors(table):
    """fit_hrtf on the card refuses nothing and keeps θ there."""
    from tinaural_torch.models import fit

    cfg = tinaural_torch.RenderConfig(block_size=256)
    xbs, dirs, target = _fit_inputs("cuda")
    xs = xbs.reshape(2, -1).cpu().numpy()
    params, losses = fit.fit_hrtf(table, xs, dirs.cpu().numpy(),
                                  target.cpu().numpy(), steps=5, config=cfg)
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    assert all(p.device.type == "cuda" for p in params)
    assert losses[-1] < losses[0]


@pytest.mark.gpu
def test_trace_names_the_render_kernels(table, tmp_path):
    """`utils.profiling.trace` of one trajectory render (B1's route) writes
    a chrome trace that names its three kernels."""
    import glob
    import json

    from tinaural_torch.utils import trace

    r = tinaural_torch.BinauralRenderer(table)
    x = np.random.default_rng(22).standard_normal(64 * B).astype(np.float32)
    dirs = np.stack([np.linspace(0, 300, 64), np.zeros(64)], 1)
    r.render_trajectory(x, dirs)  # built and warm before the trace
    with trace(tmp_path) as d:
        r.render_trajectory(x, dirs)
    (path,) = glob.glob(str(d / "trace-*.json"))
    with open(path) as f:
        names = " ".join(e.get("name", "") for e in json.load(f)["traceEvents"])
    for kernel in br.KERNELS:
        assert f"{kernel}_kernel" in names, kernel


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["render_trajectory", "render_scene"])
def test_host_syncs_counts_every_sync(table, entry):
    """One warm call of each offline entry point at a test size (B1's route
    for the trajectory, B4's for the 8-source scene): the synchronising
    operations torch's sync debug mode reports equal the growth of the
    program's counter ``host_syncs``: `assemble_filters`' range check
    alone, as the host-to-device copies of the blocks and the directions
    go through page-locked memory and wait for nothing."""
    import warnings

    from tinaural_torch.utils import profiling

    r = tinaural_torch.BinauralRenderer(table)
    rng = np.random.default_rng(31)
    nb, S = 64, 8
    if entry == "render_trajectory":
        args = (rng.standard_normal(nb * B).astype(np.float32),
                np.stack([np.linspace(0, 300, nb), np.linspace(-30, 60, nb)],
                         1).astype(np.float32))
    else:
        args = (rng.standard_normal((S, nb * B)).astype(np.float32),
                np.stack([rng.uniform(0, 360, (S, nb)),
                          rng.uniform(-40, 90, (S, nb))], -1
                         ).astype(np.float32))
    getattr(r, entry)(*args)  # built, its tables made
    torch.cuda.synchronize()
    before = profiling.counters()["host_syncs"]
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            getattr(r, entry)(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in got
             if "called a synchronizing CUDA operation" in str(w.message)]
    grown = profiling.counters()["host_syncs"] - before
    assert len(syncs) == grown, (grown, syncs)
    assert grown == 1


@pytest.mark.gpu
@pytest.mark.parametrize("short", [0, 37])
def test_blockify_frames_on_the_card(table, short):
    """`_blockify` of a 2^23-sample source, and of 8 sources of 2^20, N =
    nb·B − ``short``: the blocks on the card equal the host-padded blocks
    in bits, and ``tt.blockify``'s self time (less its ``tt.h2d``), the
    median of 5 warm calls within `tracing()`, is under 2 ms: no host
    copy of the samples is made."""
    from tinaural_torch.utils import profiling

    r = tinaural_torch.BinauralRenderer(table)
    rng = np.random.default_rng(37)
    for shape in ((1 << 23,), (8, 1 << 20)):
        x = rng.standard_normal(shape[:-1] + (shape[-1] - short,)
                                ).astype(np.float32)
        nb = -(-x.shape[-1] // B)
        pad = [(0, 0)] * (x.ndim - 1) + [(0, nb * B - x.shape[-1])]
        want = np.pad(x, pad).reshape(*x.shape[:-1], nb, B)
        xb, N = r._blockify(x)
        assert N == x.shape[-1] and xb.device.type == "cuda"
        assert np.array_equal(xb.cpu().numpy(), want)
    x = rng.standard_normal((1 << 23) - short).astype(np.float32)
    r._blockify(x)
    torch.cuda.synchronize()
    profiling.clear()
    with profiling.tracing():
        for _ in range(5):
            r._blockify(x)
    spans = profiling.spans()
    inner = {s.parent: s.end_ns - s.start_ns for s in spans
             if s.name == "tt.h2d"}
    self_ms = sorted((s.end_ns - s.start_ns - inner[s.id]) / 1e6
                     for s in spans if s.name == "tt.blockify")
    assert len(self_ms) == 5
    assert self_ms[2] < 2.0, self_ms


@pytest.mark.gpu
def test_make_mesh_cuda_needs_a_process_group(table):
    import torch.distributed as dist

    from tinaural_torch.parallel import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), "cuda")


@pytest.mark.gpu
def test_sharded_renders_at_world_size_one_over_nccl(table, tmp_path):
    """A group of one over NCCL on a (1, 1) mesh: the sharded scene (moving
    and static) and streams equal the unsharded entry points in bits, the
    sharded long render (one span behind a silent block) is ≥ 100 dB from
    the unsharded one, and each launches what the unsharded call does."""
    import torch.distributed as dist

    from tinaural_torch.parallel import (ShardedBatchedStream, make_mesh,
                                         render_long_sharded,
                                         render_scene_sharded)

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), "cuda")
        cfg = tinaural_torch.RenderConfig()
        r = tinaural_torch.BinauralRenderer(table, cfg)
        rng = np.random.default_rng(23)
        S, N = 8, 32 * B
        xs = rng.standard_normal((S, N)).astype(np.float32)
        moving = np.stack([rng.uniform(0, 360, (S, 32)),
                           rng.uniform(-40, 90, (S, 32))], -1)
        static = moving[:, 0]
        for dirs in (moving, static):
            n_want = _cli_launches(lambda: r.render_scene(xs, dirs))
            n_got = _cli_launches(lambda: render_scene_sharded(
                table, xs, dirs, mesh, cfg))
            want = r.render_scene(xs, dirs)
            got = render_scene_sharded(table, xs, dirs, mesh, cfg)
            assert torch.equal(got, want) and n_got == n_want
        x = rng.standard_normal(64 * B + 100).astype(np.float32)
        tdirs = np.stack([np.linspace(0, 350, 65), np.zeros(65)], 1)
        n_want = _cli_launches(lambda: r.render_trajectory(x, tdirs))
        n_got = _cli_launches(lambda: render_long_sharded(table, x, tdirs,
                                                          mesh, cfg))
        got = render_long_sharded(table, x, tdirs, mesh, cfg)
        want = r.render_trajectory(x, tdirs)
        assert got.shape == want.shape and n_got == n_want
        assert _snr_db(want, got) >= 100
        scfg = tinaural_torch.RenderConfig(stream_update_rate=4)
        blocks = torch.tensor(rng.standard_normal((8, 16, 256)),
                              dtype=torch.float32, device=table.device)
        azs = torch.linspace(0, 300, 16, device=table.device)
        els = torch.zeros(16, device=table.device)
        plain = tinaural_torch.BatchedStream(table, 16, scfg)
        sharded = ShardedBatchedStream(table, 16, mesh, scfg)
        n_want = _cli_launches(lambda: plain.push_many(blocks, azs, els))
        n_got = _cli_launches(lambda: sharded.push_many(blocks, azs, els))
        assert n_got == n_want == {"assemble_partitions": 2,
                                   "stream_conv": 8}
        assert torch.equal(sharded.push_many(blocks, azs, els),
                           plain.push_many(blocks, azs, els))
    finally:
        dist.destroy_process_group()

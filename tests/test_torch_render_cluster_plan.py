"""B1's cluster mode on the CPU: the plans of `assemble_filters` and
`block_spectra_mix_inverse` at n_fft 32768 … 131072 against the CUDA
constants, numpy models of both cluster kernels against the float64 plain
block render, and a moving scene on the port's B1 route against the JAX
package.

Above 16384 points each transform spreads over a thread-block cluster of
C = n/16384 blocks of 1024 threads (``csrc/fft_reg.cuh`` `ClusterPlan`).
The models keep one array per block (rank), place every value where the
kernel stores it and assert that every read is local
(`test_torch_cluster_plan.Cluster`).
`_model_filters` follows ``csrc/assemble_filters.cu``'s cluster kernel:
the cluster chain (`test_torch_cluster_plan._model_filter`), h_eff
truncated and handed to rfft_n in registers, rfft_n across the cluster,
the pair exchange that brings Z[q] and Z[n − q] of each bin to the rank
that owns it (`_pairs`: every slot written once), and H written once a
bin. `_model_mix` follows ``csrc/block_mix_inverse.cu``'s: per source in
order, the forward transform by conjugation, the pair exchange, the MAC
packed into the block's sums (which the kernel carries in the block's
frames row, the Nyquist bin in a register), then the sums through the
cluster into the inverse's input order and the cluster inverse.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from conftest import snr_db
from test_torch_cluster_plan import (SHARE, SHARE_F2, THREADS, Cluster,
                                     _local_out, _model_filter, _spread,
                                     _threads)
from test_torch_mac_plan import _read, _snr_db, _table, _unpack
from tinaural.models.renderer import BinauralRenderer as JaxRenderer
from tinaural_torch.data import TorchTable
from tinaural_torch.models.renderer import _n_fft, route
from tinaural_torch.ops import _layout
from tinaural_torch.ops._layout import CLUSTER, REGISTER
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops.ola import overlap_add
from tinaural_torch.ops.render_plan import filters_plan, mix_groups, mix_plan
from tinaural_torch.ops.spectra_inverse import (MAX_CLUSTER_N,
                                                MAX_REGISTER_N, inverse_plan,
                                                twiddles)

torch.set_num_threads(1)

CSRC = Path(tinaural_torch.__file__).parent / "csrc"
H100_SHARED_BYTES = 232_448  # one block's opt-in shared memory (227 KB)
PAIRS = SHARE // 2  # bins a rank pairs up: 8192
FLAGS = dict(apply_itd=True, apply_ild=True)
CPU = torch.device("cpu")
NAN = np.complex64(np.nan + 0j)
B = 1024


# ------------------------------------------------------------------- plans


def _constants() -> dict:
    """The integer constants the cluster kernels' launches rest on, as the
    CUDA sources state them."""
    fft = (CSRC / "fft_reg.cuh").read_text()
    filt = (CSRC / "assemble_filters.cu").read_text()
    mix = (CSRC / "block_mix_inverse.cu").read_text()
    out = {}
    for name in ("kRegMaxLog2N", "kClusterMaxLog2N", "kClusterThreads"):
        out[name] = int(re.search(rf"constexpr int {name} = (\d+);",
                                  fft).group(1))
    assert "constexpr int kClusterPairs = (1 << kRegMaxLog2N) / 2;" in fft
    assert "static constexpr int share_f2 = Local::row_f2;" in fft
    assert "passes > 1 ? n + n / 16 : 0;" in fft
    # each kernel's share is one block's RegPlan<14>::row_f2
    for src, name in ((filt, "kFiltersClusterShared"),
                      (mix, "kMixClusterShared")):
        assert (f"constexpr int {name} = ClusterPlan<kRegMaxLog2N + 1>"
                "::share_f2;") in src
    # one block of kClusterThreads an SM; a cluster per run of rows, or
    # per output block
    assert re.search(r"__launch_bounds__\(kClusterThreads, 1\)\n"
                     r"    assemble_filters_kernel\(const FilterArgs a\)",
                     filt)
    assert re.search(r"__launch_bounds__\(kClusterThreads, 1\)\n"
                     r"    block_spectra_mix_inverse_kernel\(const MixArgs a\)",
                     mix)
    assert re.search(r"filters_cluster_kernel<kLog2N>\(\), "
                     r"\(a\.rows \+ a\.run - 1\) / a\.run,\s+PN::ranks,",
                     filt)
    assert re.search(r"launch_cluster\(kernel, a\.nb, PN::ranks,", mix)
    # the entry points refuse any other plan
    assert re.search(r"rows_per_block != 1 \|\| blocks_per_sm != 1", filt)
    assert re.search(r"groups != 1 \|\|\s+blocks_per_sm != 1", mix)
    M = 1 << out["kRegMaxLog2N"]
    out["share_f2"] = M + M // 16
    return out


@pytest.mark.parametrize("log2n", range(15, 18))
def test_cluster_plans_equal_the_cuda_constants(log2n, monkeypatch):
    """n = 2^15 … 2^17: both plans take n/16384 ranks of 1024 threads, one
    block an SM, the radices (ranks, 16, 16, 16, 4) and a share of 139,264
    B, which the layout takes unless the split mode is forced;
    `assemble_filters` only where L == n_fft, the mix at any L, one group
    a block."""
    c = _constants()
    n = 1 << log2n
    M = 1 << c["kRegMaxLog2N"]
    assert log2n <= c["kClusterMaxLog2N"] and MAX_CLUSTER_N == 1 << 17
    assert M == MAX_REGISTER_N
    plans = (filters_plan(n - 64, n), mix_plan(n))
    f, m = plans
    for p, share in ((f, f.shared_f2), (m, m.group_f2)):
        assert p.body == CLUSTER and p.body != REGISTER
        assert p.ranks == n // M <= 8
        assert p.threads == c["kClusterThreads"] and p.blocks_per_sm == 1
        assert share == c["share_f2"] and share * 8 == 139_264
        assert 2 * PAIRS + 2 <= share and p.ranks * PAIRS == n // 2
        assert _layout.launch_mode(CLUSTER, share, n,
                                   H100_SHARED_BYTES) == (CLUSTER, 0)
    assert f.L == n and f.rows_per_block == 1
    assert f.radices_n == f.radices_L == (f.ranks, 16, 16, 16, 4)
    assert m.radices == (m.ranks, *inverse_plan(M).radices)
    assert m.max_groups == 1 and mix_groups(64, 256, m, 132) == 1
    # L < n: the filters stay split, the mix does not depend on L
    short = filters_plan(n // 2 - 64, n)
    assert short.L == n // 2 and short.body != CLUSTER
    split = (_layout.SPLIT, _layout.SPLIT_WORK)
    assert _layout.launch_mode(short.body, short.shared_f2, n,
                               H100_SHARED_BYTES) == split
    monkeypatch.setattr(_layout, "force_work", _layout.SPLIT_WORK)
    for share in (f.shared_f2, m.group_f2):
        assert _layout.launch_mode(CLUSTER, share, n,
                                   H100_SHARED_BYTES) == split


def test_the_gap_and_the_routes():
    """At block 1024 a table of 15,298 … 16,320 taps gives n_fft 32768
    with L 16384: `assemble_filters` stays split there, the mix takes the
    cluster; at 16,321 taps and more both take the cluster (n_fft = L =
    32768), up to 44,100 taps at 65536. A moving scene of more blocks than
    SMs takes B1."""
    table = lambda taps: type("T", (), {"taps": taps})()
    for taps, n, L, cluster in ((15297, 16384, 16384, False),
                                (15298, 32768, 16384, False),
                                (16320, 32768, 16384, False),
                                (16321, 32768, 32768, True),
                                (16384, 32768, 32768, True),
                                (44100, 65536, 65536, True)):
        assert _n_fft(table(taps), B) == n
        p = filters_plan(taps, n)
        assert p.L == L and (p.body == CLUSTER) == cluster
        assert (mix_plan(n).body == CLUSTER) == (n > MAX_REGISTER_N)
    assert route("scene", 64, 256, 1 << 15, 132) is br.block_render  # (n): B1
    assert route("scene", 64, 131, 1 << 15, 132) is not br.block_render


# ------------------------------------------------------------------ models


def _pairs(Z: np.ndarray, n: int) -> Cluster:
    """`cluster_pairs`: Z (C, 1024, 16) holds Z[k], k = c + C·(tid +
    1024·local_out(m)); each goes to the rank of q = min(k, n − k), slot
    2·(q mod 8192) (+1 for the mirror), bins 0 and n/2 to both slots, n/2
    on the last rank at pair 8192. Every slot written once."""
    C = n // SHARE
    c, tid, m = _threads(C)
    k = c + C * (tid + THREADS * _local_out(m))
    assert (np.sort(k.ravel()) == np.arange(n)).all()
    lo = k <= n // 2
    q = np.where(lo, k, n - k)
    o = np.minimum(q // PAIRS, C - 1)
    at = 2 * (q - o * PAIRS) + np.where(lo, 0, 1)
    dup = (k == 0) | (k == n // 2)
    cl = Cluster(C, SHARE_F2)
    cl.write(o, at, Z)
    cl.write(o[dup], at[dup] + 1, Z[dup])
    filled = ~np.isnan(cl.buf)
    assert filled[:, : 2 * PAIRS].all()
    assert filled[:-1, 2 * PAIRS:].sum() == 0
    assert filled[-1, 2 * PAIRS:].sum() == 2
    return cl


def _rank_pairs(rank: int, C: int) -> np.ndarray:
    """The pairs l = tid + 1024·i (i < 8) a rank's threads read, and n/2's
    (l = 8192) on the last rank."""
    ls = (np.arange(THREADS)[:, None] + THREADS * np.arange(8)).ravel()
    return np.append(ls, PAIRS) if rank == C - 1 else ls


def _model_filters(idx, w, table, n: int) -> np.ndarray:
    """The cluster kernel of `assemble_filters`: idx, w (rows, 4) → H
    (rows, 2, F) complex64, one row after another on a cluster; every
    output bin written once."""
    p = filters_plan(table.taps, n)
    assert p.body == CLUSTER
    C, M, span = p.ranks, SHARE, SHARE // p.ranks
    arrays = (idx.numpy(), w.numpy(),
              table.h.reshape(-1, 2, table.taps).numpy(),
              table.delays.reshape(-1, 2).numpy(),
              table.gains.reshape(-1, 2).numpy())
    rows, F = idx.shape[0], n // 2 + 1
    twN = twiddles(n, CPU).numpy()
    H = np.full((rows, 2, F), NAN)
    writes = np.zeros((rows, 2, F), int)
    c, tid, m = _threads(C)
    t = M * (m % C) + c * span + tid + (m // C) * THREADS
    for r in range(rows):
        x = _model_filter(r, arrays, table.taps, p.L)
        v = np.where(t < p.t_pad, np.conj(x * np.float32(1 / n)),
                     0).astype(np.complex64)
        cl = _pairs(np.conj(_spread(v, n, twN)), n)
        for rank in range(C):
            ls = _rank_pairs(rank, C)
            A, Bq = _unpack(cl.read(rank, 2 * ls, rank),
                            cl.read(rank, 2 * ls + 1, rank))
            qq = rank * PAIRS + ls
            H[r, 0, qq], H[r, 1, qq] = A, Bq
            np.add.at(writes[r], (0, qq), 1)
            np.add.at(writes[r], (1, qq), 1)
    assert (writes == 1).all()
    return H


def _model_mix(x: np.ndarray, H: np.ndarray, n: int, crossfade: bool,
               dir_rate: int) -> np.ndarray:
    """The cluster kernel of `block_spectra_mix_inverse`: x (S, nb, B)
    float32, H (S, ⌈nb/k⌉, 2, F) complex64 → frames (nb, 2, n) float32,
    one cluster per output block."""
    S, nb, Bk = x.shape
    C, M = n // SHARE, SHARE
    span = M // C
    f32 = np.float32
    tw = twiddles(n, CPU).numpy()
    c, tid, m = _threads(C)
    t = np.broadcast_to(M * (m % C) + c * span + tid + (m // C) * THREADS,
                        (C, THREADS, 16))
    live = t < Bk
    inv_B = f32(1.0) / f32(Bk)
    u = (t[live].astype(f32) + f32(0.5)) * inv_B
    frames = np.full((nb, 2, n), np.nan, f32)
    for b in range(nb):
        hc = b // dir_rate
        hp = hc - 1 if b > 0 and b == hc * dir_rate else hc
        # the block's frames row as n complex64: Z[q], Z[n − q] at pair q
        sums = np.full((n // 2, 2), NAN)
        nyquist = np.complex64(0)
        for s in range(S):
            val = x[s, b][t[live]]
            z = np.zeros(t.shape, np.complex64)
            if crossfade:
                xu = val * u
                z[live] = xu + 1j * (xu - val)  # conj(x·u + i·x·(1−u))
            else:
                z[live] = val
            cl = _pairs(np.conj(_spread(z, n, tw)), n)
            for rank in range(C):
                ls = _rank_pairs(rank, C)
                Zq = cl.read(rank, 2 * ls, rank)
                Zm = cl.read(rank, 2 * ls + 1, rank)
                q = rank * PAIRS + ls
                Hc, Hp = H[s, hc], H[s, hp]
                if crossfade:
                    Xu, Xd = _unpack(Zq, Zm)
                    y0 = Xu * Hc[0, q] + Xd * Hp[0, q]
                    y1 = Xu * Hc[1, q] + Xd * Hp[1, q]
                else:
                    y0, y1 = Zq * Hc[0, q], Zq * Hc[1, q]
                edge = (q == 0) | (q == n // 2)
                y0 = np.where(edge, y0.real, y0).astype(np.complex64)
                y1 = np.where(edge, y1.real, y1).astype(np.complex64)
                P = np.stack([(y0.real - y1.imag) + 1j * (y0.imag + y1.real),
                              (y0.real + y1.imag) + 1j * (y1.real - y0.imag)],
                             -1).astype(np.complex64)
                body = q < n // 2
                if s:
                    P[body] = _read(sums, q[body]) + P[body]
                sums[q[body]] = P[body]
                if (~body).any():
                    nyquist = nyquist + P[~body][0, 0]
        assert not np.isnan(sums).any()  # each pair written by its thread
        # the sums into cluster_spread's input order, through the cluster
        k = np.concatenate([np.arange(n // 2), n - np.arange(1, n // 2),
                            [n // 2]])
        vals = np.concatenate([sums[:, 0], sums[1:, 1], [nyquist]])
        cl = Cluster(C)
        k2 = k % M
        cl.write(k2 // span, (k // M) * span + k2 % span, vals)
        v = cl.read(c, (m % C) * span + tid + (m // C) * THREADS, c)
        v = _spread(v.astype(np.complex64), n, tw)
        pos = c + C * (tid + THREADS * _local_out(m))
        pos = np.broadcast_to(pos, v.shape)
        frames[b, 0, pos] = v.real * f32(1 / n)
        frames[b, 1, pos] = v.imag * f32(1 / n)
    assert not np.isnan(frames).any()
    return frames


def _scene_inputs(taps: int, n: int, dir_rate: int, seed: int):
    table = _table(taps, seed=seed)
    assert _n_fft(table, B) == n
    rng = np.random.default_rng(seed)
    S, nb = 2, 3
    fnb = br.filter_rows(nb, dir_rate)
    idx = torch.from_numpy(rng.integers(0, 8, (S, fnb, 4)).astype(np.int32))
    w = rng.uniform(0.1, 1.0, (S, fnb, 4))
    w = torch.from_numpy((w / w.sum(-1, keepdims=True)).astype(np.float32))
    x = rng.standard_normal((S, nb, B)).astype(np.float32)
    return table, idx, w, x


@pytest.mark.parametrize("taps,n,crossfade,dir_rate", [
    (16384, 1 << 15, True, 1), (16384, 1 << 15, False, 1),
    (16384, 1 << 15, True, 4), (16384, 1 << 15, True, 2),
    (44100, 1 << 16, True, 1), (44100, 1 << 16, False, 1),
    (44100, 1 << 16, True, 4)])
def test_models_match_the_block_render(taps, n, crossfade, dir_rate):
    """Both models chained through the overlap-add against the float64
    `block_render_reference` on 2 sources × 3 output blocks, n = L = 32768
    (clusters of 2) and 65536 (clusters of 4), ≥ 100 dB and within 1 dB of
    the plain float32 render; each kernel alone against its float64 plain
    version, ≥ 100 dB. dir_rate 2 starts a filter group at block 2 (its
    predecessor's row the one before); 4 gives one filter a source."""
    table, idx, w, x = _scene_inputs(taps, n, dir_rate, seed=taps + n
                                     + dir_rate + crossfade)
    assert filters_plan(taps, n).body == mix_plan(n).body == CLUSTER
    S, fnb, _ = idx.shape
    H = _model_filters(idx.reshape(-1, 4), w.reshape(-1, 4), table,
                       n).reshape(S, fnb, 2, -1)
    H64 = br.assemble_filters_reference(idx, w.double(), table, n, **FLAGS)
    assert _snr_db(H64.numpy(), H) >= 100
    frames = _model_mix(x, H, n, crossfade, dir_rate)
    kw = dict(crossfade=crossfade, dir_rate=dir_rate)
    f64 = br.block_spectra_mix_inverse_reference(
        torch.from_numpy(x).double(), torch.from_numpy(H).to(torch.complex128),
        n, **kw)
    assert _snr_db(f64.numpy(), frames) >= 100
    got = overlap_add(torch.from_numpy(frames).transpose(0, 1), B).numpy()
    xt = torch.from_numpy(x)
    ref = br.block_render_reference(xt.double(), idx, w, table, n, **kw,
                                    **FLAGS).numpy()
    plain = br.block_render_reference(xt, idx, w, table, n, **kw,
                                      **FLAGS).numpy()
    floor = _snr_db(ref, plain)
    snr = _snr_db(ref, got)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert snr >= 100 and snr >= floor - 1, (snr, floor)


# ------------------------------------------------------------------- JAX


def test_moving_scene_at_32768_matches_jax():
    """A moving `render_scene` of 2 sources × 3 blocks at 16,384 taps and
    block 1024 (n_fft 32768, B1's cluster shapes on a card) on the port's
    B1 route, whose plain version runs on the CPU, against `tinaural`'s
    jnp route on the same numpy inputs: ≥ 100 dB."""
    arrays = tinaural.load_hrir_set("synthetic", taps=16384)
    table = TorchTable.from_hrir_table(arrays, "cpu")
    n = _n_fft(table, B)
    assert n == 1 << 15 and filters_plan(table.taps, n).body == CLUSTER
    rng = np.random.default_rng(11)
    S, nb = 2, 3
    N = nb * B - 200
    xs = rng.standard_normal((S, N)).astype(np.float32)
    dirs = np.stack([rng.uniform(0, 360, (S, nb)),
                     rng.uniform(-40, 90, (S, nb))], -1).astype(np.float32)
    called = []
    real = br.block_render_reference

    def spy(*args, **kw):
        called.append(args[4])
        return real(*args, **kw)

    br.block_render_reference = spy
    try:
        y = tinaural_torch.render_scene(
            table, xs, dirs, tinaural_torch.RenderConfig(block_size=B),
            dedupe=False).numpy()
    finally:
        br.block_render_reference = real
    assert called == [n]  # B1's plain version
    jcfg = tinaural.RenderConfig(use_pallas=False, block_size=B,
                                 filter_path="fft")
    yj = np.asarray(JaxRenderer(arrays, jcfg).render_scene(xs, dirs,
                                                           dedupe=False))
    assert y.shape == yj.shape and np.isfinite(y).all()
    assert snr_db(yj, y) >= 100

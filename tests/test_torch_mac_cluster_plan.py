"""`assembly_mac`'s cluster mode on the CPU: its plan against the CUDA
constants, and a numpy model of the cluster kernel against the float64
plain version and the JAX package.

At n_fft 32768 … 131072 with L == n_fft, one thread-block cluster of
C = n/16384 blocks of 1024 threads takes a run of rows
(``csrc/assembly_mac.cu``, cluster kernel). The model (`_model_mac`)
keeps one array per block (rank) and follows the kernel index by index:
the cluster chain (`test_torch_cluster_plan._model_filter`: the gather,
rfft_L, the ramp exchange, irfft_L), the truncated h_eff handed to
rfft_n in registers, rfft_n across the cluster (`_spread`), the exchange
that brings Z[q] and Z[n − q] of each MAC bin q side by side to the rank
that runs it (every slot written once, every read local), and the MAC,
whose carry goes through Y: row r writes Xd[r + 1]·H[r] into Y[r + 1] and
row r + 1 adds to it, on the same thread and bins. Held against the
float64 `assembly_mac_reference` at n = L = 32768 and 65536, it pins the
index maps before a card runs them.
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
from test_torch_mac_plan import _inputs, _read, _snr_db, _table, _unpack
from tinaural.models.renderer import BinauralRenderer as JaxRenderer
from tinaural_torch.data import TorchTable
from tinaural_torch.models.renderer import _n_fft, route
from tinaural_torch.ops import _layout
from tinaural_torch.ops._layout import CLUSTER, REGISTER
from tinaural_torch.ops import assembly_mac as am
from tinaural_torch.ops.mac_plan import mac_plan
from tinaural_torch.ops.spectra_inverse import (MAX_CLUSTER_N,
                                                MAX_REGISTER_N, twiddles)

torch.set_num_threads(1)

CSRC = Path(tinaural_torch.__file__).parent / "csrc"
H100_SHARED_BYTES = 232_448  # one block's opt-in shared memory (227 KB)
PAIRS = SHARE // 2  # MAC bins a rank: 8192
FLAGS = dict(apply_itd=True, apply_ild=True)
CPU = torch.device("cpu")
NAN = np.complex64(np.nan + 0j)


# ------------------------------------------------------------------- plan


def _constants() -> dict:
    """The integer constants the cluster kernel's launch rests on, as the
    CUDA sources state them."""
    fft = (CSRC / "fft_reg.cuh").read_text()
    mac = (CSRC / "assembly_mac.cu").read_text()
    out = {}
    for name in ("kRegMaxLog2N", "kClusterMaxLog2N", "kClusterThreads"):
        out[name] = int(re.search(rf"constexpr int {name} = (\d+);",
                                  fft).group(1))
    # kClusterPairs = (1 << kRegMaxLog2N) / 2 (the pair exchange of
    # fft_reg.cuh cluster_pairs); the share is RegPlan<14>::row_f2
    assert re.search(r"constexpr int kClusterPairs = "
                     r"\(1 << kRegMaxLog2N\) / 2;", fft)
    assert "bin(kClusterPairs);  // n/2" in mac
    assert re.search(r"constexpr int kMacClusterShared = "
                     r"ClusterPlan<kRegMaxLog2N \+ 1>::share_f2;", mac)
    assert "static constexpr int share_f2 = Local::row_f2;" in fft
    assert "passes > 1 ? n + n / 16 : 0;" in fft
    M = 1 << out["kRegMaxLog2N"]
    out["kClusterPairs"] = M // 2
    out["kMacClusterShared"] = M + M // 16
    # one block of kClusterThreads an SM, one cluster a run
    assert re.search(r"__launch_bounds__\(kClusterThreads, 1\)\n"
                     r"    assembly_mac_kernel\(const MacArgs a\)", mac)
    assert "(a.rows + a.run - 1) / a.run, PN::ranks," in mac
    return out


@pytest.mark.parametrize("log2n", range(15, 18))
def test_cluster_plan_equals_the_cuda_constants(log2n):
    """n = L = 2^15 … 2^17: n/16384 ranks of 1024 threads, one block an
    SM, a share of 139,264 B that the pair exchange's 16386 slots fit and
    the layout takes unless the split mode is forced; L < n stays split."""
    c = _constants()
    n = 1 << log2n
    p = mac_plan(n - 64, n)
    assert p.L == n and p.body == CLUSTER and p.body != REGISTER
    assert p.ranks == n >> c["kRegMaxLog2N"] <= 8
    assert p.threads == c["kClusterThreads"] and p.blocks_per_sm == 1
    assert p.shared_f2 == c["kMacClusterShared"]
    assert p.shared_f2 * 8 == 139_264
    assert 2 * c["kClusterPairs"] + 2 <= p.shared_f2
    assert p.ranks * c["kClusterPairs"] == n // 2
    assert log2n <= c["kClusterMaxLog2N"] and MAX_CLUSTER_N == 1 << 17
    assert _layout.launch_mode(p.body, p.shared_f2, n,
                               H100_SHARED_BYTES) == (CLUSTER, 0)
    short = mac_plan(n // 2 - 64, n)  # L = n/2: the split mode
    assert short.L == n // 2 and short.body != CLUSTER
    assert _layout.launch_mode(short.body, short.shared_f2, n,
                               H100_SHARED_BYTES) == (_layout.SPLIT,
                                                      _layout.SPLIT_WORK)


# ------------------------------------------------------------------ model


def _model_mac(idx, w, table, Xu, Xd, first, n, run, crossfade):
    """The cluster kernel's map, one cluster per run: → Y (rows, 2, F)
    complex64; every final output bin written once."""
    p = mac_plan(table.taps, n)
    assert p.body == CLUSTER
    C, M, span, t_pad = p.ranks, SHARE, SHARE // p.ranks, p.t_pad
    arrays = (idx.numpy(), w.numpy(),
              table.h.reshape(-1, 2, table.taps).numpy(),
              table.delays.reshape(-1, 2).numpy(),
              table.gains.reshape(-1, 2).numpy())
    Xu, Xd, first = Xu.numpy(), Xd.numpy(), first.numpy()
    rows, F = idx.shape[0], n // 2 + 1
    twN = twiddles(n, CPU).numpy()
    Y = np.full((rows, 2, F), NAN)  # device memory
    writes = np.zeros((rows, 2, F), int)
    c, tid, m = _threads(C)
    t = M * (m % C) + c * span + tid + (m // C) * THREADS
    k = c + C * (tid + THREADS * _local_out(m))  # rfft_n's output bins
    assert (np.sort(k.ravel()) == np.arange(n)).all()
    lo = k <= n // 2
    q = np.where(lo, k, n - k)
    o = np.minimum(q // PAIRS, C - 1)
    at = 2 * (q - o * PAIRS) + np.where(lo, 0, 1)
    dup = (k == 0) | (k == n // 2)  # their own mirrors: stored twice
    slots = np.concatenate([(o * SHARE_F2 + at).ravel(),
                            (o * SHARE_F2 + at + 1)[dup]])
    assert np.unique(slots).size == slots.size == n + 2  # each once
    # each thread's MAC pairs: l = tid + 1024·i, and n/2 on the last rank
    pair = np.arange(THREADS)[:, None] + THREADS * np.arange(8)
    for r0 in range(0, rows, run):
        r1 = min(rows, r0 + run)
        prev = crossfade and r0 > 0 and first[r0] < 0.5
        for r in range(r0 - 1 if prev else r0, r1):
            x = _model_filter(r, arrays, table.taps, p.L)
            v = np.where(t < t_pad, np.conj(x * np.float32(1 / n)),
                         0).astype(np.complex64)
            Z = np.conj(_spread(v, n, twN))  # Z[k] at rank k mod C
            cl = Cluster(C, SHARE_F2)
            cl.write(o, at, Z)
            cl.write(o[dup], at[dup] + 1, Z[dup])
            # every slot of the exchange written once: 2 per pair, the
            # last rank's n/2 too
            filled = ~np.isnan(cl.buf)
            assert filled[:, : 2 * PAIRS].all()
            assert filled[:-1, 2 * PAIRS:].sum() == 0
            assert filled[-1, 2 * PAIRS:].sum() == 2
            own = r == 0 or first[r] > 0.5
            carry = crossfade and r + 1 < r1 and first[r + 1] < 0.5
            for rank in range(C):
                ls = pair.ravel()
                if rank == C - 1:
                    ls = np.append(ls, PAIRS)
                Zq = cl.read(rank, 2 * ls, rank)
                Zm = cl.read(rank, 2 * ls + 1, rank)
                A, Bq = _unpack(Zq, Zm)
                qq = rank * PAIRS + ls
                if r >= r0:
                    y0, y1 = Xu[r, qq] * A, Xu[r, qq] * Bq
                    if crossfade:
                        if own:
                            y0 = y0 + Xd[r, qq] * A
                            y1 = y1 + Xd[r, qq] * Bq
                        else:  # Xd·H_prev, written for the row before
                            y0 = y0 + _read(Y[r, 0], qq)
                            y1 = y1 + _read(Y[r, 1], qq)
                    Y[r, 0, qq], Y[r, 1, qq] = y0, y1
                    np.add.at(writes[r, 0], qq, 1)
                    np.add.at(writes[r, 1], qq, 1)
                if carry:
                    Y[r + 1, 0, qq] = Xd[r + 1, qq] * A
                    Y[r + 1, 1, qq] = Xd[r + 1, qq] * Bq
    assert (writes == 1).all()  # every output bin written once
    return Y


def _check(taps, n, rows, run, firsts, crossfade, seed):
    table = _table(taps, seed=seed)
    assert mac_plan(taps, n).body == CLUSTER
    idx, w, Xu, Xd = _inputs(table, rows, n, seed=seed)
    first = torch.zeros(rows)
    first[list(firsts)] = 1.0
    kw = dict(crossfade=crossfade, **FLAGS)
    got = _model_mac(idx, w, table, Xu, Xd * (1 if crossfade else np.nan),
                     first, n, run, crossfade)
    ref = am.assembly_mac_reference(idx, w.double(), table,
                                    Xu.to(torch.complex128),
                                    Xd.to(torch.complex128), first, n,
                                    **kw).numpy()
    plain = am.assembly_mac_reference(idx, w, table, Xu, Xd, first, n,
                                      **kw).numpy()
    floor = _snr_db(ref, plain)
    assert got.shape == ref.shape and np.isfinite(got).all()
    snr = _snr_db(ref, got)
    assert snr >= 100 and snr >= floor - 1, (snr, floor)


def test_model_matches_reference_at_32768():
    """n = L = 32768 ((j)'s 16,384 taps, clusters of 2): 7 rows in runs of
    3, `first` inside the second run (row 4) and at the third's start (row
    6), row 0 passed as 0; ≥ 100 dB against float64 and within 1 dB of
    the plain float32 version."""
    _check(16384, 1 << 15, 7, 3, (4, 6), True, seed=1)


def test_model_matches_reference_at_65536():
    """n = L = 65536 (44,100 taps, clusters of 4): 4 rows in runs of 2,
    `first` at row 3, inside the second run, whose predecessor row 1 is
    assembled again."""
    _check(44100, 1 << 16, 4, 2, (3,), True, seed=2)


def test_model_without_crossfade():
    """Without crossfade no predecessor is assembled, nothing is carried
    and Xd is unread (NaN here)."""
    _check(20000, 1 << 15, 3, 2, (), False, seed=3)


# ------------------------------------------------------------------- JAX


def test_natural_order_route_at_32768_matches_jax():
    """A trajectory at 16,384 taps and block 1024 (n_fft = L = 32768, the
    cluster mode's shapes on a card) on the port's natural-order route
    against `tinaural`'s plain jnp route on the same numpy inputs: ≥ 90
    dB."""
    arrays = tinaural.load_hrir_set("synthetic", taps=16384)
    table = TorchTable.from_hrir_table(arrays, "cpu")
    B = 1024
    n = _n_fft(table, B)
    assert n == 1 << 15 and mac_plan(table.taps, n).body == CLUSTER
    assert route("trajectory", 1, 3, n, 0) is am.assembly_mac_render
    assert n > MAX_REGISTER_N
    N = 3 * B - 100
    rng = np.random.default_rng(5)
    x = rng.standard_normal(N)
    nb = -(-N // B)
    dirs = np.stack([np.linspace(10, 300, nb), np.linspace(-30, 60, nb)], 1)
    called = []
    real = am.assembly_mac_render_reference

    def spy(*args, **kw):
        called.append(args[-1])
        return real(*args, **kw)

    am.assembly_mac_render_reference = spy
    try:
        y = tinaural_torch.render_trajectory(
            table, x, dirs, tinaural_torch.RenderConfig(block_size=B)).numpy()
    finally:
        am.assembly_mac_render_reference = real
    assert called == [n]  # the natural-order route's plain version
    jcfg = tinaural.RenderConfig(use_pallas=False, block_size=B,
                                 filter_path="fft")
    yj = np.asarray(JaxRenderer(arrays, jcfg).render_trajectory(x, dirs))
    assert y.shape == yj.shape and np.isfinite(y).all()
    assert snr_db(yj, y) >= 90

"""The cluster buffer mode's plans, and numpy models of its two kernels, on
the CPU.

Above 16384 points a transform spreads over a thread-block cluster of
C = n/16384 blocks of 1024 threads, 16 points each, in four steps
(``csrc/fft_reg.cuh`` `ClusterPlan`, `cluster_spread`,
`cluster_local_fft`): a radix-C step in registers, one exchange through
the cluster's distributed shared memory, and each block's 16384-point
register FFT. The models keep one array per block (rank), place every
value where the kernel stores it, and assert that every read is local to
the reading thread's rank: the stores are the remote accesses.
`_model_inverse` follows the cluster instance of ``csrc/spectra_inverse.cu``;
`_model_partitions` the cluster instance of ``csrc/partitioned.cu``
`assemble_partitions`: the gather, rfft_L, the exchange that brings each
bin's mirror L − q to its block, the ramp in registers, irfft_L in the
reverse order with the C-point DFT last, the truncated h_eff in each
block's shared memory, and the partition FFTs of each block's own samples
in two rounds. Held against `np.fft.irfft` and the float64
`assemble_partitions_reference`, they pin the index maps before a card
runs them.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_inverse_plan import _dft, _pad
from test_torch_mac_plan import (_ramp, _read, _reg_passes, _snr_db,
                                 _table, _unpack)
from tinaural_torch.data.table import ALIGN_GUARD, MAX_RENDER_SHIFT
from tinaural_torch.ops import _layout
from tinaural_torch.ops import partitioned_conv as pc
from tinaural_torch.ops.filters import n_parts
from tinaural_torch.ops.mac_plan import ramp_taper
from tinaural_torch.ops.partitions_plan import (KEEP_SAMPLES,
                                                MAX_CLUSTER_BLOCK,
                                                MAX_CLUSTER_L,
                                                MIN_CLUSTER_BLOCK,
                                                MIN_CLUSTER_L,
                                                partitions_plan)
from tinaural_torch.ops.spectra_inverse import (CLUSTER_THREADS,
                                                MAX_CLUSTER_N,
                                                MAX_REGISTER_N, inverse_plan,
                                                twiddles)

torch.set_num_threads(1)

H100_SHARED_BYTES = 232_448  # one block's opt-in shared memory (227 KB)
CPU = torch.device("cpu")
SHARE = MAX_REGISTER_N  # positions per rank
SHARE_F2 = SHARE + SHARE // 16  # padded
THREADS = CLUSTER_THREADS
NAN = np.complex64(np.nan + 0j)


# ------------------------------------------------------------------- plans


@pytest.mark.parametrize("log2n", range(15, 18))
def test_cluster_inverse_plan(log2n):
    """n = 2^15 … 2^17: C = n/16384 blocks of 1024 threads, 16 points
    each, the register radices, a padded 16384-position share per block
    that fits the H100; the layout takes it unless the split mode is
    forced."""
    n = 1 << log2n
    p = inverse_plan(n)
    assert p.ranks == n // SHARE and p.threads == THREADS
    assert p.points == 16 and p.rows_per_block == 1
    assert p.points * p.threads * p.ranks == n
    assert math.prod(p.radices) == n
    assert p.radices == (p.ranks, *inverse_plan(SHARE).radices)
    assert p.shared_f2 * 8 == 139_264
    assert p.shared_f2 * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES
    assert _layout.split_work(p.shared_f2, n, H100_SHARED_BYTES) == 0
    assert MAX_CLUSTER_N == 1 << 17


def test_forced_split_reaches_the_cluster_sizes(monkeypatch):
    monkeypatch.setattr(_layout, "force_work", 256)
    for n in (1 << 15, 1 << 16):
        assert _layout.split_work(inverse_plan(n).shared_f2, n,
                                  H100_SHARED_BYTES) == 256
    p = partitions_plan(44100, 512)
    assert _layout.split_work(p.shared_f2, p.L, H100_SHARED_BYTES) == 256


@pytest.mark.parametrize("taps,block", [
    (44100, 512), (44100, 256), (9000, 512), (16384, 512), (8000, 512),
    (70000, 2048), (44100, 4096), (44100, 32), (100, 256), (44100, 64)])
def test_partitions_plan(taps, block):
    """The cluster mode covers L 16384 … 131072 at B 64 … 2048, with one
    block per 16384 samples, 1024 threads, 199,680 B of shared memory
    (the 196 KB carve-out with its reserve), and 8192/B partitions per round; the layout takes it
    unless forced. Other shapes keep the shared mode (L ≤ 8192) or the
    split mode (the shared figure no block holds)."""
    p = partitions_plan(taps, block)
    assert p.parts == n_parts(taps, block) == -(-(taps + 64) // block)
    assert p.parts * block <= p.L
    fits = p.shared_f2 * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES
    cluster = (MIN_CLUSTER_L <= p.L <= MAX_CLUSTER_L
               and MIN_CLUSTER_BLOCK <= block <= MAX_CLUSTER_BLOCK)
    assert p.cluster == cluster
    assert fits == (cluster or p.L <= 8192)
    if cluster:
        assert p.ranks == p.L // SHARE and p.threads == THREADS
        assert math.prod(p.radices_L) == p.L
        assert math.prod(p.radices_2B) == 2 * block
        # with the 1 KB a block reserves, the SM's 196 KB carve-out
        assert p.shared_f2 * 8 + 1024 == 196 * 1024
        assert p.slots * (2 * block // 16) == THREADS
        assert p.slots * (2 * block + 2 * block // 16) == SHARE_F2
    work = _layout.split_work(p.shared_f2, max(p.L, 2 * block),
                              H100_SHARED_BYTES)
    assert work == (0 if fits else _layout.SPLIT_WORK)


# ------------------------------------------------------------------ models


def _local_out(m: np.ndarray) -> np.ndarray:
    """`local_out`: the output tid + 1024·local_out(m) that register m
    holds after a block's 16384-point transform (last radix 4)."""
    return m // 4 + 4 * (m % 4)


class Cluster:
    """C rank-local buffers; every write names its rank, every read must
    come from the reader's own."""

    def __init__(self, C: int, size: int = SHARE):
        self.C, self.size = C, size
        self.buf = np.full((C, size), NAN)

    def write(self, rank, local, vals):
        rank, local = np.broadcast_arrays(rank, local)
        assert local.min() >= 0 and local.max() < self.size
        at = (rank * self.size + local).ravel()
        assert np.unique(at).size == at.size  # each position once
        self.buf.ravel()[at] = np.broadcast_to(vals, rank.shape).ravel()

    def read(self, rank, local, reader):
        rank, local = np.broadcast_arrays(rank, local)
        assert (rank == reader).all()  # every read is local
        return _read(self.buf.ravel(), rank * self.size + local)


def _threads(C: int):
    """(C, 1024, 1) rank and thread indices, and (16,) slots."""
    return (np.arange(C)[:, None, None], np.arange(THREADS)[None, :, None],
            np.arange(16))


def _spread(v: np.ndarray, n: int, tw: np.ndarray) -> np.ndarray:
    """`cluster_spread` + `cluster_local_fft`: v (C, 1024, 16) holds
    Z[M·k1 + k2] at v[c, tid, s·C + k1], k2 = c·M/C + tid + s·1024. The
    C-point DFT and twiddle in registers, u_t1[k2] stored at local k2 of
    rank t1, then each rank's 16384-point register FFT → (C, 1024, 16):
    output t1 + C·(tid + 1024·local_out(m)) of rank t1."""
    C = n // SHARE
    c, tid, m = _threads(C)
    k2 = c * (SHARE // C) + tid + (m // C) * THREADS
    t1 = m % C  # after the DFT, slot s·C + t1 holds u_t1
    if C > 1:
        v = _dft(v.reshape(C, THREADS, 16 // C, C), C).reshape(v.shape)
        v = v * tw[k2 * t1]
    cl = Cluster(C)
    cl.write(t1, k2, v)
    return _local_fft(cl, C)


def _local_fft(cl: Cluster, C: int) -> np.ndarray:
    """`cluster_local_fft` on every rank: its buf[tid + 1024·r], dft16,
    the 16384-point register passes, each rank in its own padded
    exchange buffer."""
    c, tid, m = _threads(C)
    v = cl.read(c, tid + THREADS * m, c)
    v = _dft(v.astype(np.complex64), 16)
    local = inverse_plan(SHARE)
    tw = twiddles(SHARE, CPU).numpy()
    return np.stack([_reg_passes(v[r], local.radices, SHARE, tw)
                     for r in range(C)])


def _model_inverse(Y: np.ndarray, n: int) -> np.ndarray:
    """The cluster kernel of `spectra_inverse`: Y (terms, rows, 2, F) →
    frames (rows, 2, n) float32; one cluster per row."""
    plan = inverse_plan(n)
    C = plan.ranks
    terms, rows = Y.shape[:2]
    Y = Y.astype(np.complex64)
    tw = twiddles(n, CPU).numpy()
    c, tid, m = _threads(C)
    k = SHARE * (m % C) + c * (SHARE // C) + tid + (m // C) * THREADS
    mirror = k > n // 2
    q = np.where(mirror, n - k, k)
    edge = (q == 0) | (q == n // 2)
    pos = c + C * (tid + THREADS * _local_out(m))
    assert (np.sort(pos.ravel()) == np.arange(n)).all()
    frames = np.full((rows, 2, n), np.nan, np.float32)
    for row in range(rows):
        a, b = Y[0, row, 0][q], Y[0, row, 1][q]
        for t in range(1, terms):  # in order of t
            a, b = a + Y[t, row, 0][q], b + Y[t, row, 1][q]
        a = np.where(edge, a.real, a).astype(np.complex64)
        b = np.where(edge, b.real, b).astype(np.complex64)
        v = np.where(mirror, (a.real + b.imag) + 1j * (b.real - a.imag),
                     (a.real - b.imag) + 1j * (a.imag + b.real))
        v = _spread(v.astype(np.complex64), n, tw)
        frames[row, 0, pos] = v.real * np.float32(1 / n)
        frames[row, 1, pos] = v.imag * np.float32(1 / n)
    return frames


@pytest.mark.parametrize("terms", [1, 3])
@pytest.mark.parametrize("log2n", range(15, 18))
def test_cluster_inverse_model_matches_irfft(log2n, terms):
    """The cluster model against np.fft.irfft of the summed spectra in
    float64, on 2 rows: ≥ 120 dB at 2^15, 2^16 and 2^17."""
    n = 1 << log2n
    F = n // 2 + 1
    rng = np.random.default_rng(log2n * 10 + terms)
    Y = (rng.standard_normal((terms, 2, 2, F))
         + 1j * rng.standard_normal((terms, 2, 2, F))).astype(np.complex64)
    got = _model_inverse(Y, n)
    ref = np.fft.irfft(Y.astype(np.complex128).sum(0), n=n)
    assert np.isfinite(got).all()
    assert _snr_db(ref, got) >= 120, _snr_db(ref, got)


def _model_partitions(idx, w, table, B: int):
    """The cluster kernel of `assemble_partitions`: → H (rows, P, 2, B+1)
    complex64, one cluster per row."""
    plan = partitions_plan(table.taps, B)
    L, C, P, t_pad = plan.L, plan.ranks, plan.parts, plan.t_pad
    M, span = SHARE, SHARE // C
    f32 = np.float32
    twL, tw2 = twiddles(L, CPU).numpy(), twiddles(2 * B, CPU).numpy()
    taper = ramp_taper(L, CPU).numpy()
    h = table.h.reshape(-1, 2, table.taps).numpy()
    delays = table.delays.reshape(-1, 2).numpy()
    gains = table.gains.reshape(-1, 2).numpy()
    idx, w = idx.numpy(), w.numpy()
    rows = idx.shape[0]
    H = np.full((rows, P, 2, B + 1), NAN)
    writes = np.zeros(H.shape, int)
    c, tid, m = _threads(C)
    t2_out = tid + THREADS * _local_out(m)  # after a local transform
    for r in range(rows):
        rw, wk = idx[r], w[r]
        d, gn = [], []
        for e in range(2):  # clipped delays and gains, in the kernel's order
            dv, gv = f32(0), f32(0)
            for k in range(4):
                dv = f32(dv + wk[k] * delays[rw[k], e])
                gv = f32(gv + wk[k] * gains[rw[k], e])
            d.append(f32(min(max(dv - f32(ALIGN_GUARD), f32(-ALIGN_GUARD)),
                             f32(MAX_RENDER_SHIFT))))
            gn.append(gv)
        # gather conj(h0 + i·h1) at t = M·k1 + k2 straight into registers
        t = M * (m % C) + c * span + tid + (m // C) * THREADS
        t = np.broadcast_to(t, (C, THREADS, 16))
        z = np.zeros((2, C, THREADS, 16), np.float32)
        live = t < table.taps
        for k in range(4):
            z[:, live] += wk[k] * h[rw[k]][:, t[live]]
        v = _spread((z[0] - 1j * z[1]).astype(np.complex64), L, twL)
        S = np.conj(v)  # rfft_L at bins c + C·t2_out
        q = c + C * t2_out
        assert (np.sort(q.ravel()) == np.arange(L)).all()
        # the lo bins q < L/2 (local_out < 8), the hi ones; L/2 (rank 0,
        # t2 = M/2) is its own mirror, as bin 0 is
        lo = np.broadcast_to(_local_out(m) < 8, q.shape)
        half = q == L // 2
        assert (lo == (q < L // 2)).all()
        partner = np.broadcast_to((C - c) % C, q.shape)
        cf, t2f = np.broadcast_to(c, q.shape), np.broadcast_to(t2_out, q.shape)
        t2m = np.where(c > 0, M - 1 - t2f, (M - t2f) & (M - 1))
        # each hi S[q] to its mirror's rank, at the mirror's (lo) slot
        cl = Cluster(C)
        send = ~lo & ~half
        cl.write(partner[send], t2m[send], S[send])
        # each lo pair (q, L − q), and L/2, ramped once
        own = lo & (q > 0)
        Sm = S.copy()  # bins 0 and L/2 pair with themselves
        Sm[own] = cl.read(cf[own], t2f[own], cf[own])
        done = lo | half
        qd = q[done]
        G0, G1 = _unpack(S[done], Sm[done])
        G0 = (G0 * _ramp(qd, L, d[0], twL, taper)) * gn[0]
        G1 = (G1 * _ramp(qd, L, d[1], twL, taper)) * gn[1]
        edge = (qd == 0) | (qd == L // 2)
        G0 = np.where(edge, G0.real, G0)
        G1 = np.where(edge, G1.real, G1)
        Z = np.full(q.shape, NAN)
        Z[done] = (G0.real - G1.imag) + 1j * (G0.imag + G1.real)
        # Z[L − q] back to the mirror's rank, at its hi slot, unwritten
        back = own[done]
        zm = ((G0.real + G1.imag) + 1j * (G1.real - G0.imag))[back]
        rk, at = partner[own], t2m[own]
        assert np.isnan(cl.buf[rk, at]).all()
        cl.write(rk, at, zm)
        Z[send] = cl.read(cf[send], t2f[send], cf[send])
        assert not np.isnan(Z).any()
        # into the inverse's first-pass order: Z[c + C·k2] at u[k2 / 1024]
        u = np.empty((C, THREADS, 16), np.complex64)
        u[:, :, _local_out(np.arange(16))] = Z
        u = _dft(u, 16)
        local = inverse_plan(SHARE)
        twM = twiddles(SHARE, CPU).numpy()
        u = np.stack([_reg_passes(u[i], local.radices, M, twM)
                      for i in range(C)])
        u = u * twL[c * t2_out]  # e^{2πi·c·t2/L}
        # to the rank that owns t2's span, then the C-point DFT there
        cl = Cluster(C)
        cl.write(t2_out // span, c * span + t2_out % span, u)
        t2 = c * span + tid + (m // C) * THREADS
        x = cl.read(c, (m % C) * span + tid + (m // C) * THREADS, c)
        x = x.reshape(C, THREADS, 16 // C, C)
        if C > 1:
            x = _dft(x, C)
        x = x.reshape(C, THREADS, 16)
        # conj(h_eff) truncated and scaled: sample M·t1 + t2 at rank t1,
        # local t2 xor 8192
        t1 = np.broadcast_to(m % C, x.shape)
        smp = M * t1 + t2
        assert (np.sort(smp.ravel()) == np.arange(L)).all()
        cl = Cluster(C)
        cl.write(t1, np.broadcast_to(t2 ^ 8192, x.shape), np.where(
            smp < t_pad, np.conj(x * f32(1 / L)), 0).astype(np.complex64))
        # partitions: rank c transforms those of its own samples, 8192/B
        # at a time, 2B/16 threads each (lane, slot)
        Tp, slots = 2 * B // 16, plan.slots
        lane, slot = np.arange(THREADS) % Tp, np.arange(THREADS) // Tp
        tail = 2 * B + 2 * B // 16
        for rk in range(C):
            for rnd in range(2):
                q0 = (rk * SHARE + rnd * 8192) // B
                if q0 >= P:
                    continue
                # the samples at (1 − rnd)·8192; the buffers from there, or
                # for round 0 from KEEP_SAMPLES below, over round 1's last
                # samples, which threads tid < KEEP_SAMPLES hold meanwhile
                base = 0 if rnd else 8192 - KEEP_SAMPLES
                tt = lane[:, None] + np.arange(16)[None, :] * Tp
                xp = np.zeros((THREADS, 16), np.complex64)
                xp[:, :8] = cl.read(rk, (1 - rnd) * 8192 + slot[:, None] * B
                                    + tt[:, :8], rk)
                vp = _dft(xp, 16)
                vp = _partition_passes(vp.reshape(slots, Tp, 16),
                                       plan.radices_2B, 2 * B, tw2)
                # the last pass's bins, conjugated, natural order per slot
                # in the round's region (after its samples were read)
                R = plan.radices_2B[-1]
                jj = lane[:, None] + np.arange(16 // R)[None, :] * Tp
                kpos = (jj[..., None] + np.arange(R) * (2 * B // R)).reshape(
                    THREADS, 16)
                reg = np.full(slots * tail, NAN)
                at = (slot[:, None] * tail + kpos).ravel()
                assert np.unique(at).size == at.size
                reg[at] = np.conj(vp.reshape(THREADS, 16)).ravel()
                assert base + slots * tail <= plan.shared_f2
                kb = np.concatenate([lane[:, None] + np.arange(8) * Tp,
                                     np.full((THREADS, 1), B)], 1)
                keep = np.ones(kb.shape, bool)
                keep[:, 8] = lane == 0
                qq = q0 + slot
                ok = (qq < P)[:, None] & keep
                A, Bk = _unpack(
                    _read(reg, slot[:, None] * tail + kb),
                    _read(reg, slot[:, None] * tail + ((2 * B - kb)
                                                       & (2 * B - 1))))
                rr, kk = np.broadcast_to(qq[:, None], kb.shape)[ok], kb[ok]
                H[r, rr, 0, kk], H[r, rr, 1, kk] = A[ok], Bk[ok]
                np.add.at(writes[r], (rr, 0, kk), 1)
                np.add.at(writes[r], (rr, 1, kk), 1)
    assert (writes == 1).all()  # every output bin written once
    return H


def _partition_passes(v: np.ndarray, radices, n: int, tw: np.ndarray):
    """`reg_passes` for one round: v (slots, n/16, 16), one padded
    exchange buffer per slot, one after another."""
    slots, T = v.shape[:2]
    row = n + n // 16
    lane = np.arange(T)
    strides = [math.prod(radices[:p]) for p in range(len(radices))]
    for p in range(1, len(radices)):
        Rq, Nq = radices[p - 1], strides[p - 1]
        j = lane[:, None] + np.arange(16 // Rq)[None, :] * T
        pos = ((j // Nq) * Nq * Rq + j % Nq)[..., None] + np.arange(Rq) * Nq
        at = np.arange(slots)[:, None, None] * row + _pad(pos.reshape(T, 16))
        assert np.unique(at).size == at.size and at.max() < SHARE_F2
        buf = np.full(slots * row, NAN)
        buf[at] = v
        R, Ns = radices[p], strides[p]
        j = lane[:, None] + np.arange(16 // R)[None, :] * T
        x = _read(buf, np.arange(slots)[:, None, None, None] * row
                  + _pad(j[..., None] + np.arange(R) * (n // R)))
        m = np.arange(R) * (j % Ns)[..., None] * (n // (Ns * R))
        v = _dft(x * tw[m], R).reshape(slots, T, 16)
    return v


@pytest.mark.parametrize("taps,B", [(9000, 256), (9000, 512),
                                    (44100, 256), (44100, 512)])
def test_partitions_model_matches_reference(taps, B):
    """The cluster model against the float64 `assemble_partitions_reference`
    at L = 16384 (C = 1) and 65536 (C = 4, (j)'s 44,100 taps), B 256 and
    512, on 2 rows: ≥ 100 dB and no more than 1 dB below the plain float32
    version, which is the float32 floor of these three long transforms
    (110 dB at L = 16384, 105 dB at 65536)."""
    table = _table(taps, seed=taps + B)
    plan = partitions_plan(taps, B)
    assert plan.cluster and plan.L in (16384, 65536)
    rng = np.random.default_rng(B)
    idx = torch.from_numpy(rng.integers(0, 8, (2, 4)).astype(np.int32))
    w = rng.uniform(0.1, 1.0, (2, 4))
    w = torch.from_numpy((w / w.sum(1, keepdims=True)).astype(np.float32))
    got = _model_partitions(idx, w, table, B)
    re, im = pc.assemble_partitions_reference(idx, w.double(), table, B,
                                              apply_itd=True, apply_ild=True)
    ref = (re + 1j * im).numpy()
    re, im = pc.assemble_partitions_reference(idx, w, table, B,
                                              apply_itd=True, apply_ild=True)
    floor = _snr_db(ref, (re + 1j * im).numpy())
    assert got.shape == ref.shape and np.isfinite(got).all()
    snr = _snr_db(ref, got)
    assert snr >= 100 and snr >= floor - 1, (snr, floor)

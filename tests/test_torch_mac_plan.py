"""Kernel `assembly_mac`'s launch plan and ramp table, and a numpy model of
its register design, on the CPU.

The model (`_model_mac`) follows ``csrc/assembly_mac.cu`` and
``csrc/fft_reg.cuh`` index by index: the gather into the first pass's
input order on the block's first L/16 threads, rfft_L as the conjugate of
the register inverse, the exchange that unpacks bins j and L − j, applies
the table-driven ramp and the gain and packs the inverse's input, irfft_L,
the truncation to t_pad with its hand-off to rfft_n (a register
permutation where L == n, an exchange otherwise), rfft_n, and the final
exchange from which each thread unpacks its own bins of H and runs the
MAC. It walks the rows in runs as the CUDA blocks do, with the carried
H_prev kept per thread. Every exchange writes each position once and
reads back only what was written; the MAC writes each output bin once.
Held against the float64 `assembly_mac_reference` (which
``tests/test_torch_assembly_mac.py`` holds against the JAX package's
`fused_assembly_mac`), it pins the index maps before a card runs them.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_inverse_plan import _dft, _pad
from tinaural_torch.data import TorchTable
from tinaural_torch.data.table import ALIGN_GUARD, DELAY_PAD, MAX_RENDER_SHIFT
from tinaural_torch.ops import _layout
from tinaural_torch.ops._layout import CLUSTER, REGISTER
from tinaural_torch.ops import assembly_mac as am
from tinaural_torch.ops.filters import delay_ramp
from tinaural_torch.ops.mac_plan import SPLIT_THREADS, mac_plan, ramp_taper
from tinaural_torch.ops.spectra_inverse import MAX_REGISTER_N, twiddles

torch.set_num_threads(1)

# one block's opt-in shared memory on the H100 (227 KB)
H100_SHARED_BYTES = 232_448
CPU = torch.device("cpu")
LOG2_SIZES = range(7, MAX_REGISTER_N.bit_length())  # 128 … 16384
# every (L, n) pair of the register plans: L = next_pow2(taps + 64) ≤ n
PAIRS = [(1 << a, 1 << b) for b in LOG2_SIZES for a in LOG2_SIZES if a <= b]
FLAGS = dict(apply_itd=True, apply_ild=True)


def _compiled_plan(n: int) -> tuple[tuple[int, ...], int, int]:
    """RegPlan's radices and threads and mac_min_blocks, as the CUDA
    source computes them."""
    log2n = n.bit_length() - 1
    passes = (log2n + 3) // 4
    radices = tuple(16 if p + 1 < passes else n >> 4 * (passes - 1)
                    for p in range(passes))
    threads = n // 16
    blocks = 1 if threads >= 768 else min(16, 768 // threads)
    return radices, threads, blocks


@pytest.mark.parametrize("log2n", range(7, 25))
def test_mac_plan(log2n):
    """The register plan matches the compiled constants and fits the
    H100's shared memory exactly up to n_fft 16384, where the layout takes
    the shared mode; at 32768 … 131072 with L == n the cluster plan (n/16384
    blocks of 1024 threads, one block's share) fits too; every other shape
    above 16384 takes the split mode with 1024 threads."""
    n = 1 << log2n
    for taps in {1, n // 2 - DELAY_PAD + 1, n - DELAY_PAD}:
        p = mac_plan(taps, n)
        assert (p.taps, p.n, p.t_pad) == (taps, n, taps + DELAY_PAD)
        assert p.L == 1 << math.ceil(math.log2(taps + DELAY_PAD)) <= n
        assert math.prod(p.radices_L) == p.L and math.prod(p.radices_n) == n
        register = n <= MAX_REGISTER_N
        assert (p.body == REGISTER) == register
        cluster = MAX_REGISTER_N < n <= 1 << 17 and p.L == n
        assert (p.body == CLUSTER) == cluster
        assert p.ranks == (n // MAX_REGISTER_N if cluster else 0)
        fits = p.shared_f2 * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES
        assert fits == (register or cluster)
        mode, work = _layout.launch_mode(p.body, p.shared_f2, n,
                                         H100_SHARED_BYTES)
        assert work == (0 if register or cluster else _layout.SPLIT_WORK)
        assert mode == (p.body if work == 0 else _layout.SPLIT)
        assert p.scratch_f2 == n + 2 * p.L + 4 * (n // 2 + 1)
        if register:
            radices, threads, blocks = _compiled_plan(n)
            assert p.radices_n == radices
            assert p.radices_L == _compiled_plan(p.L)[0]
            assert (p.threads, p.blocks_per_sm) == (threads, blocks)
            carry = 18 * threads if n < MAX_REGISTER_N else 0
            assert p.shared_f2 == n + n // 16 + carry
            # the blocks __launch_bounds__ asks for fit the SM's shared
            # memory (228 KB, 1 KB of it reserved per block) and keep at
            # least 80 registers a thread
            assert p.blocks_per_sm * (p.shared_f2 * 8 + 1024) <= 228 * 1024
            assert 65536 // (p.threads * p.blocks_per_sm) >= min(
                80, 65536 // p.threads)
        elif cluster:
            assert (p.threads, p.blocks_per_sm) == (1024, 1)
            assert p.radices_n == p.radices_L == (p.ranks, 16, 16, 16, 4)
            assert p.shared_f2 == 16384 + 1024
        else:
            assert (p.threads, p.blocks_per_sm) == (SPLIT_THREADS, 1)


def test_mac_plan_rejects_bad_sizes():
    for taps, n in ((128, 96), (128, 128), (0, 128), (4040, 4096)):
        with pytest.raises(ValueError):
            mac_plan(taps, n)


def test_run_length_fills_the_concurrent_blocks():
    """At most RUN_WAVES · slots runs of equal length, the shortest that
    do: (k)'s 8192 rows and (l)'s 4096 on 132 SMs × 3 blocks; in the
    cluster mode, where a slot is a cluster, (j)'s 128 rows on the H100's
    66 clusters of 2 run 2 at a time (64 clusters, 192 assemblies in one
    wave, where runs of 1 take 256 in two), and 128 rows on 30 clusters
    of 4 run 5 at a time."""
    for rows, slots in ((8192, 396), (4096, 396), (3001, 396), (128, 132),
                        (7, 396), (100, 1), (128, 66), (128, 30), (131, 66)):
        run = am.run_length(rows, slots)
        runs = -(-rows // run)
        assert runs <= _layout.RUN_WAVES * slots
        assert run == 1 or -(-rows // (run - 1)) > _layout.RUN_WAVES * slots
    assert am.run_length(128, 66) == 2 and am.run_length(128, 30) == 5


def test_ramp_taper_table():
    """1 exactly up to fnorm 0.40, the half cosine to 0 at 0.475, within
    one float32 ulp of float64; built once per (device, L)."""
    for log2 in LOG2_SIZES:
        L = 1 << log2
        tab = ramp_taper(L, CPU)
        assert tab.dtype == torch.float32 and tab.shape == (L // 2 + 1,)
        assert ramp_taper(L, CPU) is tab
        fnorm = np.arange(L // 2 + 1) / L
        ref = 0.5 * (1 + np.cos(np.pi * np.clip((fnorm - 0.40) / 0.075, 0, 1)))
        got = tab.numpy().astype(np.float64)
        assert (got[fnorm <= 0.40] == 1.0).all()
        assert (got[fnorm >= 0.475] == 0.0).all()
        assert (np.abs(got - ref) <= np.spacing(np.float32(1.0))).all()


def _ramp(q: np.ndarray, L: int, d: np.float32, twL: np.ndarray,
          taper: np.ndarray) -> np.ndarray:
    """The kernel's `ramp_bin` in float32 at bins q for the clipped shift
    d: the integer phase and sin θ, cos θ from the L-point twiddle table,
    the taper from its table, atan2 only where w < 1, the rest of the
    phase in units of π."""
    f32 = np.float32
    di = np.floor(d)
    frac = f32(d - di)
    e = twL[(q * int(di)) & (L - 1)]
    c = twL[q]
    wt = taper[q]
    ph = wt * (f32(-2) * (q.astype(f32) / f32(L))) * frac
    psi = np.arctan2(-frac * c.imag, (f32(1) - frac) + frac * c.real)
    ph = np.where(wt < 1, ph + (f32(1) - wt) * (psi * f32(1 / np.pi)), ph)
    ph = ph.astype(np.float64) * np.pi
    return (np.conj(e) * (np.cos(ph) + 1j * np.sin(ph))).astype(np.complex64)


@pytest.mark.parametrize("log2L", LOG2_SIZES)
def test_table_ramp_matches_delay_ramp(log2L):
    """The model's table-driven ramp against `filters.delay_ramp` in
    float64, over clipped shifts from −8 (the guard) to 48, integer and
    fractional."""
    L = 1 << log2L
    twL = twiddles(L, CPU).numpy()
    taper = ramp_taper(L, CPU).numpy()
    q = np.arange(L // 2 + 1)
    shifts = np.concatenate([[-ALIGN_GUARD, -3.0, 0.0, 17.0, MAX_RENDER_SHIFT],
                             np.random.default_rng(log2L).uniform(
                                 -ALIGN_GUARD, MAX_RENDER_SHIFT, 11)])
    for d in shifts.astype(np.float32):
        got = _ramp(q, L, d, twL, taper)
        ref = delay_ramp(L, torch.tensor(float(d), dtype=torch.float64)).numpy()
        assert np.abs(got - ref).max() < 4e-6, (L, d)


def _exchange(size: int, pos: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """One exchange: write vals at pos in a buffer of ``size`` complex64,
    each position once."""
    pos = pos.ravel()
    assert pos.min() >= 0 and pos.max() < size
    assert np.unique(pos).size == pos.size
    buf = np.full(size, np.nan + 0j, np.complex64)
    buf[pos] = vals.ravel()
    return buf


def _read(buf: np.ndarray, pos: np.ndarray) -> np.ndarray:
    x = buf[pos]
    assert not np.isnan(x).any()  # read back only what was written
    return x


def _reg_passes(v: np.ndarray, radices, n: int, tw: np.ndarray) -> np.ndarray:
    """`reg_passes` for one row of T = n/16 threads: v (T, 16) holds pass
    0's output; → the last pass's, each exchange in the padded buffer."""
    T = n // 16
    lane = np.arange(T)
    strides = [math.prod(radices[:p]) for p in range(len(radices))]
    for p in range(1, len(radices)):
        Rq, Nq = radices[p - 1], strides[p - 1]
        j = lane[:, None] + np.arange(16 // Rq)[None, :] * T
        pos = ((j // Nq) * Nq * Rq + j % Nq)[..., None] + np.arange(Rq) * Nq
        buf = _exchange(n + n // 16, _pad(pos.reshape(T, 16)), v)
        R, Ns = radices[p], strides[p]
        j = lane[:, None] + np.arange(16 // R)[None, :] * T
        x = _read(buf, _pad(j[..., None] + np.arange(R) * (n // R)))
        m = np.arange(R) * (j % Ns)[..., None] * (n // (Ns * R))
        v = _dft(x * tw[m], R).reshape(T, 16)
    return v


def _last_positions(radices, n: int) -> np.ndarray:
    """(T, 16): the bin or sample that v[lane, s·R + q] holds after the
    last pass of radix R: j + q·n/R, j = lane + s·T."""
    T, R = n // 16, radices[-1]
    j = np.arange(T)[:, None] + np.arange(16 // R)[None, :] * T
    return (j[..., None] + np.arange(R) * (n // R)).reshape(T, 16)


def _unpack(Z: np.ndarray, Zm: np.ndarray):
    """common.cuh unpack_pair: rfft of both halves of a packed pair."""
    A = 0.5 * (Z.real + Zm.real) + 0.5j * (Z.imag - Zm.imag)
    B = 0.5 * (Z.imag + Zm.imag) + 0.5j * (Zm.real - Z.real)
    return A.astype(np.complex64), B.astype(np.complex64)


def _delays_gains(r: int, arrays):
    """Row r's clipped delays and gains of both ears, in the kernel's
    order of float32 operations."""
    idx, w, h, delays, gains = arrays
    f32 = np.float32
    rows, wk = idx[r], w[r]
    d, g = [], []
    for e in range(2):
        dv, gv = f32(0), f32(0)
        for k in range(4):
            dv = f32(dv + wk[k] * delays[rows[k], e])
            gv = f32(gv + wk[k] * gains[rows[k], e])
        d.append(f32(min(max(dv - f32(ALIGN_GUARD), f32(-ALIGN_GUARD)),
                         f32(MAX_RENDER_SHIFT))))
        g.append(gv)
    return d, g


def _gathered(r: int, arrays, p) -> np.ndarray:
    """conj(h0 + i·h1) of row r at t = lane + m·TL on TL = L/16 threads,
    after the first pass: (TL, 16)."""
    idx, w, h = arrays[:3]
    TL = p.L // 16
    rows, wk = idx[r], w[r]
    t = np.arange(TL)[:, None] + np.arange(16)[None, :] * TL
    z = np.zeros((2, TL, 16), np.float32)
    live = t < p.taps
    for k in range(4):
        z[:, live] += wk[k] * h[rows[k]][:, t[live]]
    return _dft((z[0] - 1j * z[1]).astype(np.complex64), 16)


def _ramp_pack(X: np.ndarray, L: int, d, g, off: int = 0):
    """The ramp pass over the bins q ≤ L/2 of an L-point spectrum at
    X[off + q]: unpack, ramp, gain, and pack Z[q] and Z[L − q], each bin
    once; → the exchange holding Z at off + q."""
    twL, taper = twiddles(L, CPU).numpy(), ramp_taper(L, CPU).numpy()
    q = np.arange(L // 2 + 1)  # = lane + i·stride over the iterations
    qm = (L - q) & (L - 1)
    G0, G1 = _unpack(_read(X, off + q), _read(X, off + qm))
    G0 = (G0 * _ramp(q, L, d[0], twL, taper)) * g[0]
    G1 = (G1 * _ramp(q, L, d[1], twL, taper)) * g[1]
    edge = (q == 0) | (q == L // 2)
    G0 = np.where(edge, G0.real, G0)
    G1 = np.where(edge, G1.real, G1)
    mid = ~edge
    return np.concatenate([off + q, off + qm[mid]]), np.concatenate([
        (G0.real - G1.imag) + 1j * (G0.imag + G1.real),
        ((G0.real + G1.imag) + 1j * (G1.real - G0.imag))[mid]])


def _model_row(r: int, arrays, p):
    """One row's chain: → H at the bins kb (T, 8) each thread owns, both
    ears (A, B), and at n/2 (lane 0)."""
    n, L, T, TL = p.n, p.L, p.threads, p.L // 16
    f32 = np.float32
    twL, twN = twiddles(L, CPU).numpy(), twiddles(n, CPU).numpy()
    d, g = _delays_gains(r, arrays)
    # gather conj(h0 + i·h1) at t = lane + m·TL on the first TL threads
    t = np.arange(TL)[:, None] + np.arange(16)[None, :] * TL
    v = _gathered(r, arrays, p)
    v = _reg_passes(v, p.radices_L, L, twL)  # conj(rfft_L)
    X = _exchange(n + n // 16, _last_positions(p.radices_L, L), np.conj(v))
    # unpack, ramp, gain and pack in place: bins q = lane + i·T ≤ L/2 on
    # all T threads, each writing q and L − q
    Z = _exchange(n + n // 16, *_ramp_pack(X, L, d, g))
    v = _read(Z, t)  # the inverse's first pass: Z[lane + m·TL]
    v = _dft(v.astype(np.complex64), 16)
    v = _reg_passes(v, p.radices_L, L, twL)  # L·(h0 + i·h1)
    # truncate to t_pad, scale, hand off to rfft_n's first pass, which
    # takes t = lane + m·T on all T threads
    tpos = _last_positions(p.radices_L, L)
    want = np.arange(T)[:, None] + np.arange(16)[None, :] * T
    hv = np.where(tpos < p.t_pad, v * f32(1 / L), 0).astype(np.complex64)
    if L == n:  # in registers: m = s + q·(16/R)
        R = p.radices_L[-1]
        s, qq = np.divmod(np.arange(16), R)
        perm = np.empty(16, int)
        perm[s + qq * (16 // R)] = np.arange(16)
        assert (tpos[:, perm] == want).all()
        x = hv[:, perm]
    else:
        keep = tpos < p.t_pad
        buf = _exchange(n + n // 16, tpos[keep], hv[keep])
        x = np.zeros((T, 16), np.complex64)
        x[want < p.t_pad] = _read(buf, want[want < p.t_pad])
    v = _dft(np.conj(x), 16)
    v = _reg_passes(v, p.radices_n, n, twN)  # conj(rfft_n)
    Z = _exchange(n + n // 16, _last_positions(p.radices_n, n), np.conj(v))
    assert not np.isnan(Z[:n]).any()
    kb = np.arange(T)[:, None] + np.arange(8)[None, :] * T
    A, B = _unpack(_read(Z, kb), _read(Z, (n - kb) & (n - 1)))
    Aq, Bq = _unpack(_read(Z, np.array([n // 2])), _read(Z, np.array([n // 2])))
    return kb, A, B, Aq[0], Bq[0]


def _model_mac(idx, w, table, Xu, Xd, first, n, run, crossfade):
    """The kernel's map by its index maps, one CUDA block per run of rows:
    → Y (rows, 2, F) complex64."""
    p = mac_plan(table.taps, n)
    arrays = (idx.numpy(), w.numpy(), table.h.reshape(-1, 2, table.taps).numpy(),
              table.delays.reshape(-1, 2).numpy(),
              table.gains.reshape(-1, 2).numpy())
    Xu, Xd, first = Xu.numpy(), Xd.numpy(), first.numpy()
    rows, F = idx.shape[0], n // 2 + 1
    Y = np.full((rows, 2, F), np.nan + 0j, np.complex64)
    writes = np.zeros((rows, 2, F), int)
    for r0 in range(0, rows, run):
        r1 = min(rows, r0 + run)
        prev = crossfade and r0 > 0 and first[r0] < 0.5
        hp = None  # each thread's bins of H_prev: (A, B, Aq, Bq)
        for r in range(r0 - 1 if prev else r0, r1):
            kb, A, B, Aq, Bq = _model_row(r, arrays, p)
            if r >= r0:
                own = r == 0 or first[r] > 0.5
                assert own or not crossfade or hp is not None
                for kk, a, b, pa, pb in ((kb, A, B, *(hp[:2] if hp else (A, B))),
                                         (n // 2, Aq, Bq,
                                          *(hp[2:] if hp else (Aq, Bq)))):
                    y0, y1 = Xu[r, kk] * a, Xu[r, kk] * b
                    if crossfade:
                        y0 = y0 + Xd[r, kk] * (a if own else pa)
                        y1 = y1 + Xd[r, kk] * (b if own else pb)
                    Y[r, 0, kk], Y[r, 1, kk] = y0, y1
                    np.add.at(writes[r, 0], kk, 1)
                    np.add.at(writes[r, 1], kk, 1)
            hp = (A, B, Aq, Bq)
    assert (writes == 1).all()  # every output bin written once
    return Y


def _table(taps: int, seed: int, device: torch.device = CPU) -> TorchTable:
    """A random 2 × 4-cell table of any length: decaying shapes, delays
    0 … 56 samples (clipped shifts −8 … 48), gains 0.5 … 1.5."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, 4, 2, taps)) * np.exp(-np.arange(taps) / (
        0.3 * taps + 4))
    return TorchTable.from_arrays(
        h, rng.uniform(0, 56, (2, 4, 2)), rng.uniform(0.5, 1.5, (2, 4, 2)),
        np.array([0.0, 30.0]), np.array([4, 4]), np.ones((2, 4)),
        sample_rate=44100, decomposed=True, device=device)


def _inputs(table, rows: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, 8, (rows, 4)).astype(np.int32))
    w = rng.uniform(0.1, 1.0, (rows, 4))
    w = torch.from_numpy((w / w.sum(1, keepdims=True)).astype(np.float32))
    F = n // 2 + 1
    X = torch.from_numpy((rng.standard_normal((2, rows, F)) + 1j
                          * rng.standard_normal((2, rows, F))).astype(
                              np.complex64))
    return idx, w, X[0], X[1]


def _snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    err = np.abs(ref - test) ** 2
    return float(10 * np.log10((np.abs(ref) ** 2).sum() / err.sum()))


@pytest.mark.parametrize("L,n", PAIRS)
def test_model_matches_reference(L, n):
    """The model against the float64 `assembly_mac_reference` at every
    (L, n) pair of the shared plan, n_fft 128 … 16384: 7 rows in runs of
    1 to 3, `first` at a run's start and inside a run, row 0 passed as 0,
    t_pad just above L/2 or just below L; ≥ 100 dB."""
    i = PAIRS.index((L, n))
    taps = L - DELAY_PAD - 3 if i % 2 else max(1, L // 2 - DELAY_PAD + 1)
    assert mac_plan(taps, n).L == L
    table = _table(taps, seed=i)
    rows, run = 7, 1 + i % 3
    idx, w, Xu, Xd = _inputs(table, rows, n, seed=i)
    first = torch.zeros(rows)
    first[[3, 5]] = 1.0
    got = _model_mac(idx, w, table, Xu, Xd, first, n, run, crossfade=True)
    ref = am.assembly_mac_reference(idx, w.double(), table,
                                    Xu.to(torch.complex128),
                                    Xd.to(torch.complex128), first, n,
                                    crossfade=True, **FLAGS).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _snr_db(ref, got) >= 100, _snr_db(ref, got)


@pytest.mark.parametrize("run", [1, 4])
def test_model_without_crossfade(run):
    """Without crossfade no predecessor is assembled and Xd is unread."""
    table = _table(128, seed=run)
    idx, w, Xu, Xd = _inputs(table, 6, 4096, seed=run)
    first = torch.zeros(6)
    got = _model_mac(idx, w, table, Xu, Xd * np.nan, first, 4096, run,
                     crossfade=False)
    ref = am.assembly_mac_reference(idx, w.double(), table,
                                    Xu.to(torch.complex128), Xd, first, 4096,
                                    crossfade=False, **FLAGS).numpy()
    assert _snr_db(ref, got) >= 100

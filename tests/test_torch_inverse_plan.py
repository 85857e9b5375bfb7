"""Kernel `spectra_inverse`'s launch plan and twiddle table, and a numpy
model of its register FFT, on the CPU.

The model (`_model_inverse`) follows ``csrc/spectra_inverse.cu`` and
``csrc/fft_reg.cuh`` index by index. It covers the load and pack of both
ears from bin k or its mirror n − k, each pass's in-register transform as
the kernel factors it, the twiddles read from the table, and the exchange
positions in the padded shared buffer of a block of rows. It ends with the
store of the frames. It checks that every exchange writes each position
once and reads back exactly what was written, and that the store covers
each sample once. Held against `np.fft.irfft`, it pins the index maps
before a card runs them.
"""

import math

import numpy as np
import pytest
import torch

from tinaural_torch.ops import _layout
from tinaural_torch.ops.spectra_inverse import (BLOCK_THREADS, MAX_CLUSTER_N,
                                                MAX_RADIX, MAX_REGISTER_N,
                                                inverse_plan, twiddles)

torch.set_num_threads(1)

# one block's opt-in shared memory on the H100 (227 KB)
H100_SHARED_BYTES = 232_448
REGISTER_LOG2N = range(1, MAX_REGISTER_N.bit_length())
W16 = np.exp(2j * np.pi * np.arange(16) / 16).astype(np.complex64)


def _snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    return float(10 * np.log10((ref ** 2).sum() / ((ref - test) ** 2).sum()))


@pytest.mark.parametrize("log2n", range(1, 25))
def test_inverse_plan(log2n):
    """The radices multiply to n, the block holds at most 1024 threads,
    and one block's shared buffers fit the H100 exactly when n ≤ 131072:
    up to 16384 a row's whole exchange buffer, above it (the cluster mode)
    that of one 16384-point share on each of C = n/16384 blocks of 1024
    threads. From 2^18 on the layout takes the split mode."""
    n = 1 << log2n
    p = inverse_plan(n)
    assert p.n == n and math.prod(p.radices) == n
    assert p.points * p.threads * p.ranks == n
    assert p.rows_per_block * p.threads <= 1024
    register = n <= MAX_REGISTER_N
    cluster = MAX_REGISTER_N < n <= MAX_CLUSTER_N
    fits = p.shared_f2 * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES
    assert fits == (register or cluster)
    mode, work = _layout.launch_mode(p.body, p.shared_f2, n,
                                     H100_SHARED_BYTES)
    assert work == (0 if fits else _layout.SPLIT_WORK)
    assert mode == (p.body if fits else _layout.SPLIT)
    assert p.ranks == (n // MAX_REGISTER_N if cluster else 1)
    if cluster:  # a radix-C step, then each block's 16384-point plan
        assert (p.points, p.threads, p.rows_per_block) == (16, 1024, 1)
        assert p.radices == (p.ranks, *inverse_plan(MAX_REGISTER_N).radices)
        assert p.shared_f2 * 8 == 139_264
    if register:
        assert all(r == MAX_RADIX for r in p.radices[:-1])
        assert 2 <= p.radices[-1] <= MAX_RADIX
        assert p.points == p.radices[0] == min(n, MAX_RADIX)
        assert p.rows_per_block * p.threads == max(BLOCK_THREADS, p.threads)
        row_f2 = n + n // 16 if len(p.radices) > 1 else 0
        assert p.shared_f2 == p.rows_per_block * row_f2


def test_inverse_plan_rejects_bad_sizes():
    for n in (0, 1, 3, 48):
        with pytest.raises(ValueError):
            inverse_plan(n)


def test_twiddles_within_one_ulp():
    """The cached table against float64 exp(2πik/n), within one float32
    ulp per component, built once per (device, n)."""
    cpu = torch.device("cpu")
    for log2n in REGISTER_LOG2N:
        n = 1 << log2n
        tab = twiddles(n, cpu)
        assert tab.dtype == torch.complex64 and tab.shape == (n,)
        assert twiddles(n, cpu) is tab
        got = tab.numpy()
        ref = np.exp(2j * np.pi * np.arange(n) / n)
        for g, r in ((got.real, ref.real), (got.imag, ref.imag)):
            ulp = np.spacing(np.abs(r).astype(np.float32))
            assert (np.abs(g.astype(np.float64) - r) <= ulp).all(), n


def _dft(x: np.ndarray, R: int) -> np.ndarray:
    """The kernel's in-register inverse DFT over the last axis (`dft<R>`):
    radix 2 and 4 directly, 8 and 16 as 4 × R/4 with the W16 twiddles."""
    if R == 2:
        return np.stack([x[..., 0] + x[..., 1], x[..., 0] - x[..., 1]], -1)
    if R == 4:
        s02, d02 = x[..., 0] + x[..., 2], x[..., 0] - x[..., 2]
        s13, d13 = x[..., 1] + x[..., 3], x[..., 1] - x[..., 3]
        i13 = (-d13.imag + 1j * d13.real).astype(np.complex64)
        return np.stack([s02 + s13, d02 + i13, s02 - s13, d02 - i13], -1)
    R2 = R // 4
    # y[n2, k1] = dft4 over n1 of x[R2·n1 + n2], times W_R^(n2·k1)
    y = _dft(x.reshape(*x.shape[:-1], 4, R2).swapaxes(-1, -2), 4)
    q = np.arange(R2)[:, None] * np.arange(4)[None, :] * (16 // R) % 16
    y = y * W16[q]
    # X[k1 + 4·k2] = dft_R2 over n2 of y[n2, k1]
    X = _dft(y.swapaxes(-1, -2), R2)
    return X.swapaxes(-1, -2).reshape(x.shape)


def _pad(i: np.ndarray) -> np.ndarray:
    return i + (i >> 4)


def _model_inverse(Y: np.ndarray, plan) -> np.ndarray:
    """The kernel's map, by its index maps: Y (terms, rows, 2, F) →
    frames (rows, 2, n) float32, the irfft of each ear of Σ_t Y[t]."""
    n, T, PT, R = plan.n, plan.threads, plan.points, plan.rows_per_block
    row_f2 = plan.shared_f2 // R  # one row's padded exchange buffer
    terms, rows = Y.shape[:2]
    Y = Y.astype(np.complex64)
    tw = twiddles(n, torch.device("cpu")).numpy()
    lane = np.arange(T)
    strides = [math.prod(plan.radices[:p]) for p in range(len(plan.radices))]
    frames = np.full((rows, 2, n), np.nan, np.float32)
    for first in range(0, rows, R):  # one CUDA block of R rows
        row = first + np.arange(R)
        live = row < rows
        # load and pack Z[k], k = lane + r·T, from bin k or its mirror n − k
        k = lane[:, None] + np.arange(PT)[None, :] * T
        mirror = k > n // 2
        q = np.where(mirror, n - k, k)
        a = np.zeros((R, T, PT), np.complex64)
        b = np.zeros((R, T, PT), np.complex64)
        for t in range(terms):  # in order of t
            a[live] += Y[t, row[live], 0][:, q]
            b[live] += Y[t, row[live], 1][:, q]
        edge = (q == 0) | (q == n // 2)
        a = np.where(edge, a.real, a).astype(np.complex64)
        b = np.where(edge, b.real, b).astype(np.complex64)
        v = np.where(mirror, (a.real + b.imag) + 1j * (b.real - a.imag),
                     (a.real - b.imag) + 1j * (a.imag + b.real))
        v = _dft(v.astype(np.complex64), plan.radices[0])
        for p in range(1, len(plan.radices)):
            # pass p − 1 stores sub-DFT j = lane + s·T, slot r at
            # (j div Ns)·Ns·R + (j mod Ns) + r·Ns in the row's padded buffer
            Rq, Nq = plan.radices[p - 1], strides[p - 1]
            j = lane[:, None] + np.arange(PT // Rq)[None, :] * T
            pos = ((j // Nq) * Nq * Rq + j % Nq)[..., None] \
                + np.arange(Rq) * Nq
            at = np.arange(R)[:, None, None] * row_f2 \
                + _pad(pos.reshape(T, PT))
            assert np.unique(at).size == at.size and at.max() < plan.shared_f2
            buf = np.full(plan.shared_f2, np.nan + 0j, np.complex64)
            buf[at] = v
            # pass p loads slot r of sub-DFT j from j + r·n/R, times the
            # twiddle exp(2πi·r·(j mod Ns)/(Ns·R)) from the table
            Rp, Ns = plan.radices[p], strides[p]
            j = lane[:, None] + np.arange(PT // Rp)[None, :] * T
            pos = j[..., None] + np.arange(Rp) * (n // Rp)
            x = buf[np.arange(R)[:, None, None, None] * row_f2 + _pad(pos)]
            assert not np.isnan(x).any()
            m = np.arange(Rp) * (j % Ns)[..., None] * (n // (Ns * Rp))
            v = _dft(x * tw[m], Rp).reshape(R, T, PT)
        # the last pass's sub-DFT j writes sample j + r·Ns
        RL = plan.radices[-1]
        j = lane[:, None] + np.arange(PT // RL)[None, :] * T
        pos = (j[..., None] + np.arange(RL) * (n // RL)).reshape(T, PT)
        assert (np.sort(pos.ravel()) == np.arange(n)).all()
        inv_n = np.float32(1.0 / n)
        for i in np.flatnonzero(live):
            frames[row[i], 0, pos] = v[i].real * inv_n
            frames[row[i], 1, pos] = v[i].imag * inv_n
    return frames


@pytest.mark.parametrize("terms", [1, 3])
@pytest.mark.parametrize("log2n", REGISTER_LOG2N)
def test_model_matches_irfft(log2n, terms):
    """The model of the kernel against np.fft.irfft of the summed spectra
    in float64, on 3 rows: ≥ 120 dB at every power of two 2 … 16384."""
    n = 1 << log2n
    F = n // 2 + 1
    rng = np.random.default_rng(log2n * 10 + terms)
    Y = (rng.standard_normal((terms, 3, 2, F))
         + 1j * rng.standard_normal((terms, 3, 2, F))).astype(np.complex64)
    got = _model_inverse(Y, inverse_plan(n))
    ref = np.fft.irfft(Y.astype(np.complex128).sum(0), n=n)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _snr_db(ref, got) >= 120, _snr_db(ref, got)

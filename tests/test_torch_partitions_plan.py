"""The launch plan of `assemble_partitions`' shared-mode register body, and
a numpy model of that body, on the CPU.

The model follows ``csrc/assemble_partitions.cu`` and ``csrc/fft_reg.cuh``
index by index, one CUDA block of G rows at a time, in one array of the
block's shared memory: the G rows' L-point chains at once, each group of
L/16 threads in its own padded slice (the stages of
``csrc/assembly_stages.cuh``, modelled as `test_torch_block_render_plan`
models them for `assemble_filters`), the hand-off of conj(h_eff) truncated
to t_pad at g·t_pad, then the block's G·P partitions in rounds of T/(2B/16)
slots: each slot's B samples into its first pass's registers, the
2B-point passes through the slot's exchange buffer above h_eff, the
conjugated bins in natural order, and the ear pair unpacked at bins
lane + i·2B/16 and 2B − k into H's row r0·P + k. Every exchange writes each
position once and reads back only what was written, no exchange touches
h_eff, and every output bin is written once. Held against the float64
`assemble_partitions_reference` and `filters.partition_spectra`, it pins
the index maps before a card runs them; `test_torch_partitions.py` holds
the port's partitioned map against the Pallas kernels in interpret mode.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_block_render_plan import _group_passes
from test_torch_inverse_plan import _dft
from test_torch_mac_plan import (CPU, H100_SHARED_BYTES, _compiled_plan,
                                 _delays_gains, _exchange, _gathered,
                                 _last_positions, _ramp_pack, _read, _snr_db,
                                 _table, _unpack)
from tinaural_torch.data.table import DELAY_PAD
from tinaural_torch.ops import _layout
from tinaural_torch.ops._layout import CLUSTER, REGISTER
from tinaural_torch.ops import partitioned_conv as pc
from tinaural_torch.ops.filters import partition_spectra
from tinaural_torch.ops.partitions_plan import (MAX_CLUSTER_BLOCK,
                                                MAX_REGISTER_L,
                                                MIN_CLUSTER_BLOCK,
                                                REGISTER_THREADS,
                                                SHARED_THREADS, launch,
                                                partitions_plan)
from tinaural_torch.ops.spectra_inverse import twiddles

torch.set_num_threads(1)

FLAGS = dict(apply_itd=True, apply_ild=True)
H100_SMS = 132


# ------------------------------------------------------------------- plans


def _compiled_max_rows(L: int) -> int:
    """partition_max_rows of the CUDA source."""
    return min(16, 512 >> (L.bit_length() - 1 - 4))


def _compiled_threads(L: int, B: int, G: int, P: int) -> int:
    """partition_block_threads of the CUDA source."""
    Tp = 2 * B // 16
    slots = min(G * P, 512 // Tp)
    return max(min(2 * G * (L // 16), 512), slots * Tp, 256)


def _compiled_shared_f2(L: int, B: int, G: int, threads: int,
                        t_pad: int) -> int:
    """partition_shared_f2 of the CUDA source."""
    n2 = 2 * B
    return max(G * (L + L // 16),
               G * t_pad + threads // (n2 // 16) * (n2 + n2 // 16))


def _taps(L: int, i: int) -> list[int]:
    """Filter lengths whose t_pad = taps + DELAY_PAD gives L: the shortest,
    one between and the longest."""
    lo = max(1, L // 2 - DELAY_PAD + 1)
    return sorted({lo, (lo + L - DELAY_PAD) // 2 + i % 3, L - DELAY_PAD})


@pytest.mark.parametrize("log2L", range(7, 14))
def test_shared_mode_plans(log2L):
    """Every L 128 … 8192 and every block 2 … 8192: the register body at
    blocks 64 … 2048 with the compiled constants (radices, most rows,
    threads and shared figure at every G), within the H100's shared memory
    and 512 threads at every G; the radix-2 body at the other blocks,
    in shared memory where it fits, else the split mode."""
    L = 1 << log2L
    for log2B in range(1, 14):
        B = 1 << log2B
        for taps in _taps(L, log2B):
            p = partitions_plan(taps, B, True)
            assert (p.L, p.t_pad, p.ranks) == (L, taps + DELAY_PAD, 0)
            assert p.parts == -(-p.t_pad // B) and p.body != CLUSTER
            reg = MIN_CLUSTER_BLOCK <= B <= MAX_CLUSTER_BLOCK
            assert (p.body == REGISTER) == reg
            # the launch at the most rows per block (no card)
            G, T, f2 = launch(taps, B, 1000, 0, True)
            fits = f2 * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES
            mode, work = _layout.launch_mode(p.body, f2, max(L, 2 * B),
                                             H100_SHARED_BYTES)
            assert work == (0 if fits else _layout.SPLIT_WORK)
            assert mode == (p.body if fits else _layout.SPLIT)
            if not reg:
                assert (p.threads, p.max_rows) == (SHARED_THREADS, 1)
                assert p.shared_f2 == max(L, 2 * B) // 2 + 2 * L + 2 * B
                assert (G, T, f2) == (1, p.threads, p.shared_f2)
                assert launch(taps, B, 1000, H100_SMS, True) == (G, T, f2)
                continue
            assert fits
            assert p.radices_L == _compiled_plan(L)[0]
            assert p.radices_2B == _compiled_plan(2 * B)[0]
            assert math.prod(p.radices_L) == L
            assert math.prod(p.radices_2B) == 2 * B
            assert p.max_rows == _compiled_max_rows(L)
            # the register body's figures come from the launch, not the plan
            assert (p.threads, p.shared_f2) == (0, 0)
            assert (G, T, f2) == (p.max_rows, p.block_threads(p.max_rows),
                                  p.block_shared_f2(p.max_rows))
            G = 1
            while G <= p.max_rows:
                T = p.block_threads(G)
                assert T == _compiled_threads(L, B, G, p.parts)
                assert max(G * L // 16, 256) <= T <= REGISTER_THREADS
                assert T % (2 * B // 16) == 0 and T % G == 0
                f2 = p.block_shared_f2(G)
                assert f2 == _compiled_shared_f2(L, B, G, T, p.t_pad)
                assert f2 * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES
                G *= 2


def test_rows_per_block():
    """G fills the card: render (d)'s 1024 rows at 128 taps take G = 4
    (256 blocks of 256 threads, 64 a row), (g)'s 2048 rows G = 2 (1024
    blocks of 512 threads, its ten partitions in two rounds), (e)'s 64
    rows (blocks of 512 threads, twice the chain's) and (f)'s one G = 1;
    with no card the most rows per block."""
    cases = [((128, 256), 1024, H100_SMS, 4, 256),
             ((2048, 256), 64, H100_SMS, 1, 512),
             ((128, 256), 1, H100_SMS, 1, 256),
             ((2048, 512), 2048, H100_SMS, 2, 512),
             ((128, 256), 1024, 0, 16, 512),
             ((60, 2048), 10, 0, 16, 512),
             ((8000, 64), 7, H100_SMS, 1, 512)]
    for (taps, B), rows, sms, G, T in cases:
        p = partitions_plan(taps, B, True)
        assert p.rows_per_block(rows, sms) == G, (taps, B, rows)
        assert p.block_threads(G) == T
        assert launch(taps, B, rows, sms, True) == (G, T, p.block_shared_f2(G))
    for taps, B in ((128, 64), (2048, 512), (100, 2048), (8000, 64)):
        p = partitions_plan(taps, B, True)
        for rows in (1, 7, 131, 132, 1000, 4096):
            for sms in (0, H100_SMS):
                G = p.rows_per_block(rows, sms)
                assert G & (G - 1) == 0 and 1 <= G <= p.max_rows
                assert G == 1 or -(-rows // G) >= sms
                assert G == p.max_rows or -(-rows // (2 * G)) < sms


def test_cluster_and_split_modes_keep_their_plans():
    """The register body does not reach above MAX_REGISTER_L: L 16384 at
    B 64 … 2048 takes the cluster mode, other blocks there the split
    mode."""
    assert MAX_REGISTER_L == 8192
    for B, cluster in ((32, False), (64, True), (2048, True), (4096, False)):
        p = partitions_plan(9000, B, True)
        assert (p.L, p.body == CLUSTER,
                p.body == REGISTER) == (16384, cluster, False)
        assert p.rows_per_block(5000, H100_SMS) == 1


# ------------------------------------------------------------------ models


def _model_rounds(smem: np.ndarray, r0: int, rows: int, G: int, plan,
                  H: np.ndarray, writes: np.ndarray) -> None:
    """The partition rounds of the block of rows r0 … r0 + G − 1, whose
    conj(h_eff) lies at smem[g·t_pad + t]: H (rows·P, 2, B+1) gains rows
    r0·P … of the live rows, each bin counted in ``writes``."""
    B, P, t_pad = plan.block, plan.parts, plan.t_pad
    n2 = 2 * B
    Tp, row2, size = n2 // 16, n2 + n2 // 16, smem.size
    T = plan.block_threads(G)
    slots = T // Tp
    tw2 = twiddles(n2, CPU).numpy()
    lane = np.arange(Tp)
    for k0 in range(0, G * P, slots):
        k = k0 + np.arange(slots)
        gk = k // P
        on = (k < G * P) & (r0 + gk < rows)
        if not on.any():
            continue
        k, gk, slot = k[on], gk[on], np.arange(slots)[on]
        # each slot's B samples of h_eff from q·B, zero-padded to 2B
        t = ((k - gk * P) * B)[:, None, None] + lane[:, None] + (
            np.arange(8) * Tp)
        inside = t < t_pad
        at = gk[:, None, None] * t_pad + np.minimum(t, t_pad - 1)
        x = np.zeros((k.size, Tp, 16), np.complex64)
        x[..., :8][inside] = _read(smem, at[inside])
        # the passes in each slot's buffer above h_eff, never over it
        offs = G * t_pad + slot * row2
        assert offs.min() >= G * t_pad and offs.max() + row2 <= size
        v = _group_passes(_dft(x, 16), plan.radices_2B, n2, tw2, size, offs)
        # the bins conjugated, natural order; the ear pair at k and 2B − k
        ex = _exchange(size, offs[:, None, None]
                       + _last_positions(plan.radices_2B, n2), np.conj(v))
        kb = np.concatenate([lane[:, None] + np.arange(8) * Tp,
                             np.full((Tp, 1), B)], 1)
        kb = np.broadcast_to(kb, (k.size, Tp, 9))
        first = np.broadcast_to(np.arange(9) < 8, kb.shape) | (
            lane[None, :, None] == 0)  # bin B on lane 0
        A, Bk = _unpack(_read(ex, offs[:, None, None] + kb),
                        _read(ex, offs[:, None, None] + ((n2 - kb) & (n2 - 1))))
        hr = np.broadcast_to((r0 * P + k)[:, None, None], kb.shape)
        H[hr[first], 0, kb[first]] = A[first]
        H[hr[first], 1, kb[first]] = Bk[first]
        np.add.at(writes, (hr[first], 0, kb[first]), 1)
        np.add.at(writes, (hr[first], 1, kb[first]), 1)


def _model_shared(idx, w, table, B: int, G: int) -> np.ndarray:
    """The register body's map by its index maps, G rows per CUDA block:
    → H (rows, P, 2, B+1) complex64."""
    p = partitions_plan(table.taps, B, True)
    assert p.body == REGISTER
    L, P, t_pad = p.L, p.parts, p.t_pad
    TL, size = L // 16, p.block_shared_f2(G)
    arrays = (idx.numpy(), w.numpy(),
              table.h.reshape(-1, 2, table.taps).numpy(),
              table.delays.reshape(-1, 2).numpy(),
              table.gains.reshape(-1, 2).numpy())
    twL = twiddles(L, CPU).numpy()
    rows = idx.shape[0]
    H = np.full((rows * P, 2, B + 1), np.nan + 0j, np.complex64)
    writes = np.zeros(H.shape, int)
    for r0 in range(0, rows, G):
        live = list(range(r0, min(rows, r0 + G)))
        offs = np.arange(len(live)) * (L + L // 16)  # the group slices
        assert G * (L + L // 16) <= size
        dg = [_delays_gains(r, arrays) for r in live]
        v = np.stack([_gathered(r, arrays, p) for r in live])
        v = _group_passes(v, p.radices_L, L, twL, size, offs)  # conj(rfft_L)
        tpos = _last_positions(p.radices_L, L)
        X = _exchange(size, offs[:, None, None] + tpos, np.conj(v))
        pos, vals = zip(*(_ramp_pack(X, L, d, g, off)
                          for (d, g), off in zip(dg, offs)))
        Z = _exchange(size, np.concatenate(pos), np.concatenate(vals))
        t = np.arange(TL)[:, None] + np.arange(16)[None, :] * TL
        v = _dft(_read(Z, offs[:, None, None] + t).astype(np.complex64), 16)
        v = _group_passes(v, p.radices_L, L, twL, size, offs)  # L·h_eff
        # conj(h_eff) truncated and scaled at g·t_pad + t
        keep = np.broadcast_to(tpos < t_pad, v.shape)
        at = (np.arange(len(live)) * t_pad)[:, None, None] + tpos
        smem = _exchange(size, at[keep],
                         np.conj(v * np.float32(1 / L))[keep])
        _model_rounds(smem, r0, rows, G, p, H, writes)
    assert (writes == 1).all()  # every output bin written once
    return H.reshape(rows, P, 2, B + 1)


def _rows(n: int, seed: int):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, 8, (n, 4)).astype(np.int32))
    w = rng.uniform(0.1, 1.0, (n, 4))
    return idx, torch.from_numpy((w / w.sum(1, keepdims=True)).astype(
        np.float32))


# (taps, B): render (d), (e), (g); B = 64, 128 (no Hermitian mirror group),
# 2048; L = 128 (taps ≤ 64) and 8192 (8000 taps); all but the last with
# a t_pad that is not a multiple of B
SHAPES = [(128, 256), (2048, 256), (2048, 512), (300, 64), (1000, 128),
          (2000, 2048), (40, 64), (8000, 512), (448, 256)]


@pytest.mark.parametrize("rows,sms", [(1, H100_SMS), (7, H100_SMS),
                                      ("G+1", 0)])
@pytest.mark.parametrize("taps,B", SHAPES)
def test_shared_model_matches_reference(taps, B, rows, sms):
    """The model against the float64 `assemble_partitions_reference` at
    each shape, on 1 and 7 rows with the card's G and on G + 1 rows with
    the most rows per block (the second block holds one live row): ≥ 100
    dB and no more than 1 dB below the plain float32 version."""
    p = partitions_plan(taps, B, True)
    if rows == "G+1":
        rows = p.rows_per_block(10 ** 6, sms) + 1
    G = p.rows_per_block(rows, sms)
    assert (p.t_pad % B == 0) == (taps == 448)
    table = _table(taps, seed=taps + B)
    idx, w = _rows(rows, seed=B + rows)
    got = _model_shared(idx, w, table, B, G)
    re, im = pc.assemble_partitions_reference(idx, w.double(), table, B,
                                              **FLAGS)
    ref = (re + 1j * im).numpy()
    re, im = pc.assemble_partitions_reference(idx, w, table, B, **FLAGS)
    floor = _snr_db(ref, (re + 1j * im).numpy())
    assert got.shape == ref.shape and np.isfinite(got).all()
    snr = _snr_db(ref, got)
    assert snr >= 100 and snr >= floor - 1, (snr, floor)


@pytest.mark.parametrize("taps,B,G", [(128, 256, 4), (2048, 256, 1),
                                      (2048, 512, 1), (40, 2048, 2),
                                      (8000, 64, 1), (1000, 128, 2)])
def test_partition_rounds_match_partition_spectra(taps, B, G):
    """The partition rounds alone, on random h_eff of G rows laid out at
    g·t_pad as the hand-off leaves it (the last block with one row fewer
    where G > 1), against `filters.partition_spectra` in float64:
    ≥ 120 dB."""
    p = partitions_plan(taps, B, True)
    assert G <= p.max_rows
    rows = max(1, 2 * G - 1)
    rng = np.random.default_rng(taps + B)
    h = (rng.standard_normal((rows, 2, p.t_pad))).astype(np.float32)
    H = np.full((rows * p.parts, 2, B + 1), np.nan + 0j, np.complex64)
    writes = np.zeros(H.shape, int)
    size = p.block_shared_f2(G)
    for r0 in range(0, rows, G):
        live = np.arange(r0, min(rows, r0 + G))
        z = (h[live, 0] - 1j * h[live, 1]).astype(np.complex64)  # conj
        at = (np.arange(live.size) * p.t_pad)[:, None] + np.arange(p.t_pad)
        smem = _exchange(size, at, z)
        _model_rounds(smem, r0, rows, G, p, H, writes)
    assert (writes == 1).all()
    ref = partition_spectra(torch.from_numpy(h).double(), B).numpy()
    got = H.reshape(rows, p.parts, 2, B + 1)
    assert got.shape == ref.shape
    assert _snr_db(ref, got) >= 120, _snr_db(ref, got)

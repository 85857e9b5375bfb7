"""`assemble_partitions` without ITD and ILD, on the CPU.

The identity the kernel's direct body rests on: with both flags off the
effective-filter chain (rfft_L, the delay ramp at d = 0, the gain 1,
irfft_L, truncation to T_pad) returns the lerp of the table rows
zero-padded to T_pad, in the plain torch version within its rounding and
in both golden maps to 1e-12, at L 128 … 65536. Then a numpy model of
the direct body's index map (lane, slot, partition and pass position →
sample; bins → H's row, partition, ear and bin), block by block, held to
`assemble_partitions_reference`, which runs the chain."""

import numpy as np
import pytest
import torch

from tinaural.reference import golden as jgolden
from tinaural_torch.data import TorchTable
from tinaural_torch.data.table import ALIGN_GUARD, DELAY_PAD
from tinaural_torch.ops import _layout, filters
from tinaural_torch.ops import partitioned_conv as pc
from tinaural_torch.ops.interp import gather_rows
from tinaural_torch.ops.partitions_plan import partitions_plan
from tinaural_torch.reference import golden

torch.set_num_threads(1)

NO_FLAGS = dict(apply_itd=False, apply_ild=False)
CELLS = 6  # a 2 × 3-cell raw table


def _raw_table(taps: int, seed: int) -> TorchTable:
    """A seeded table kept whole: random rows, no delays, unit gains."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, 3, 2, taps))
    return TorchTable.from_arrays(
        h, np.zeros((2, 3, 2)), np.ones((2, 3, 2)), np.array([0.0, 30.0]),
        np.array([3, 3]), np.ones((2, 3)), sample_rate=44100,
        decomposed=False, device=torch.device("cpu"))


def _rows(rows: int, seed: int, zeros: int = 0):
    """Random rows and weights summing to 1, the last ``zeros`` of each
    row's four 0 (2 on a one-ring grid, 3 in the nearest lookup)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, CELLS, (rows, 4)).astype(np.int32)
    w = rng.uniform(0.05, 1.0, (rows, 4))
    w[:, 4 - zeros:] = 0.0
    return torch.from_numpy(idx), torch.from_numpy(w / w.sum(1, keepdims=True))


# (taps, B): L 128 … 65536, taps no multiple of B, the last partition
# ragged against T_pad (and one filling its partitions exactly)
IDENTITY = [(60, 64), (100, 64), (500, 128), (2000, 512), (5056, 256),
            (10000, 2048), (30000, 512), (44100, 512)]


@pytest.mark.parametrize("taps,B", IDENTITY)
def test_chain_without_itd_and_ild_is_the_identity(taps, B):
    """gather_rows with both flags off gives d = ALIGN_GUARD (a clipped
    shift of 0) and g = 1, and the chain returns the lerped rows
    zero-padded to T_pad: float64 to 1e-12 of the peak, float32 within
    its rounding (2e-6 of the peak), both golden maps to 1e-12."""
    t_pad = taps + DELAY_PAD
    L = filters.next_pow2(t_pad)
    assert L == partitions_plan(taps, B, True).L and taps % B
    table = _raw_table(taps, seed=taps)
    idx, w = _rows(5, seed=B)
    h, d, g = gather_rows(table, idx, w, **NO_FLAGS)
    assert torch.all(d == ALIGN_GUARD) and torch.all(g == 1)
    want = torch.nn.functional.pad(h, (0, DELAY_PAD))  # (5, 2, t_pad)
    peak = float(want.abs().max())
    got = filters.effective_filter(h, d, g, taps)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12 * peak
    got32 = filters.effective_filter(h.float(), d.float(), g.float(), taps)
    assert float((got32.double() - want).abs().max()) <= 2e-6 * peak
    hn, dn, gn, wn = (a.numpy() for a in (h, d, g, want))
    for gold in (golden, jgolden):
        for i in range(5):
            e = gold.effective_filter(hn[i], dn[i], gn[i], taps)
            assert np.abs(e - wn[i]).max() <= 1e-12


def _unpack_pair(Z, Zm):
    """csrc/common.cuh unpack_pair: the spectra of the two real ears of a
    packed transform at bins k (Z) and 2B − k (Zm)."""
    A = 0.5 * (Z.real + Zm.real) + 0.5j * (Z.imag - Zm.imag)
    Bk = 0.5 * (Z.imag + Zm.imag) + 0.5j * (Zm.real - Z.real)
    return A, Bk


def direct_model(table: TorchTable, idx, w, B: int, S: int):
    """The direct body in numpy float64, block by block: slot `slot` of
    block b runs unit u = b·S + slot (row u // P, partition u % P); lane
    `lane` loads v[m] = conj(Σ_k w·(h0 + i·h1)) at t = qB + lane + m·Tp,
    over the rows k of weight w ≠ 0, for m < 8 (0 from t = taps on; 0 for
    m ≥ 8) into the first pass's position lane + m·Tp of a 2B-point
    inverse, whose conjugate is the forward transform; then the lane
    unpacks the ears at bins lane + i·Tp
    (i < 8; lane 0 also bin B) and writes H at u·2·F2 + k (ear 0) and
    u·2·F2 + F2 + k (ear 1). → (re, im) (rows, P, 2, B+1) and how often
    each position was written."""
    taps = table.taps
    h = table.h.reshape(-1, 2, taps).double().numpy()
    idx, w = idx.numpy(), w.double().numpy()
    rows, P = idx.shape[0], filters.n_parts(taps, B)
    n2, F2 = 2 * B, B + 1
    Tp = n2 // 16
    units = rows * P
    re = np.full(units * 2 * F2, np.nan)
    im = np.full(units * 2 * F2, np.nan)
    hits = np.zeros(units * 2 * F2, dtype=int)
    lane = np.arange(Tp)
    slots_k = (lane[:, None] + Tp * np.arange(8)[None, :]).ravel()
    bins = np.concatenate([slots_k, [B]])  # lane 0 writes bin B too
    for blk in range(-(-units // S)):
        for slot in range(S):
            u = blk * S + slot
            if u >= units:
                continue
            r, q = divmod(u, P)
            v = np.zeros((16, Tp), dtype=complex)
            for m in range(8):
                t = q * B + lane + m * Tp
                ok = t < taps
                tt = np.where(ok, t, 0)
                z = sum(w[r, k] * (h[idx[r, k], 0, tt] + 1j * h[idx[r, k], 1, tt])
                        for k in range(4) if w[r, k] != 0)
                v[m] = np.where(ok, np.conj(z), 0)
            x = np.zeros(n2, dtype=complex)
            x[lane[None, :] + Tp * np.arange(16)[:, None]] = v
            buf = np.conj(np.fft.ifft(x) * n2)
            A, Bk = _unpack_pair(buf[bins], buf[(n2 - bins) & (n2 - 1)])
            o = u * 2 * F2
            for off, e in ((o, A), (o + F2, Bk)):
                re[off + bins] = e.real
                im[off + bins] = e.imag
                hits[off + bins] += 1
    shape = (rows, P, 2, F2)
    return re.reshape(shape), im.reshape(shape), hits


@pytest.mark.parametrize("taps,B,rows,sms,zeros", [
    (300, 512, 5, 0, 0),  # P 1; one unit a block at B 512
    (2000, 512, 3, 0, 2),  # P 5
    (2000, 128, 3, 20, 0),  # P 17, S shrunk from 4 to 2 for 20 SMs
    (150, 64, 7, 0, 3),  # B 64, P 4; 28 units in blocks of 8
    (150, 64, 7, 28, 0),  # one unit a block for 28 SMs
    (700, 64, 5, 0, 2),  # P 12, the last partition ragged
])
def test_direct_model_matches_plain(taps, B, rows, sms, zeros):
    """The numpy model of the direct body writes every position of H once
    and equals the float64 plain version (which runs the chain and reads
    every row) to 1e-12 of the peak, at B 64 and 512, P 1 and ≥ 3, rows
    no multiple of the block's slots, with 0, 2 and 3 rows of weight 0."""
    plan = partitions_plan(taps, B, False)
    assert plan.body == _layout.DIRECT
    units = rows * plan.parts
    S = plan.direct_slots(units, sms)
    assert units % S or S == 1
    assert S == {(2000, 128): 2, (150, 64): 8 if sms == 0 else 1,
                 (700, 64): 8}.get((taps, B), 1)
    table = _raw_table(taps, seed=taps + B)
    idx, w = _rows(rows, seed=rows, zeros=zeros)
    re, im, hits = direct_model(table, idx, w, B, S)
    assert np.all(hits == 1)
    r64, i64 = pc.assemble_partitions_reference(idx, w, table, B, **NO_FLAGS)
    want = r64.numpy() + 1j * i64.numpy()
    assert re.shape == want.shape
    err = np.abs(re + 1j * im - want).max()
    assert err <= 1e-12 * np.abs(want).max(), err

"""The launch plans of the block render's register kernels,
`assemble_filters` and `block_spectra_mix_inverse`, and numpy models of
both, on the CPU.

The models follow ``csrc/assemble_filters.cu``, ``csrc/block_mix_inverse.cu``
and ``csrc/fft_reg.cuh`` index by index. `_model_filters` runs a CUDA
block's G rows: their L-point chains at once, each group of L/16 threads
in its own slice of the block's one exchange buffer (every exchange writes
each position once across all groups and reads back only what was
written), the hand-off of h_eff at g·L, the 16/G first-pass inputs each
thread holds per row, then each row's rfft_n on the whole block and its
bins written once. `_model_mix` runs one output block per CUDA block: the
forward transform by conjugation, the bins each thread owns, the MAC over
the sources in order, the packed inverse and the store of the frames.
Held against the float64 plain versions, and chained through the
overlap-add against the JAX package's `fused_block_render` in interpret
mode, they pin the index maps before a card runs them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinaural
from test_torch_block_render import _inputs as _render_inputs
from test_torch_inverse_plan import _dft, _pad
from test_torch_mac_plan import (CPU, H100_SHARED_BYTES, LOG2_SIZES, PAIRS,
                                 _compiled_plan, _delays_gains, _exchange,
                                 _gathered, _last_positions, _model_row,
                                 _ramp_pack, _read, _reg_passes, _snr_db,
                                 _table, _unpack)
from tinaural.ops.pallas_kernels import fused_block_render, gather_tables
from tinaural_torch.data import TorchTable
from tinaural_torch.data.table import DELAY_PAD
from tinaural_torch.models.renderer import _n_fft
from tinaural_torch.ops import _layout
from tinaural_torch.ops._layout import CLUSTER, REGISTER
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops.ola import overlap_add
from tinaural_torch.ops.render_plan import (FILTERS_SPLIT_THREADS,
                                            MIX_SPLIT_THREADS, filters_plan,
                                            mix_groups, mix_plan)
from tinaural_torch.ops.spectra_inverse import (MAX_CLUSTER_N,
                                                MAX_REGISTER_N, twiddles)

torch.set_num_threads(1)

FLAGS = dict(apply_itd=True, apply_ild=True)


def _compiled_rows(n: int, L: int) -> int:
    """filters_rows of the CUDA source."""
    return min(n // L, 16)


def _compiled_min_blocks(threads: int) -> int:
    """filters_min_blocks of the CUDA source."""
    return 1 if threads >= 256 else min(32, 256 // threads)


@pytest.mark.parametrize("log2n", range(7, 25))
def test_filters_and_mix_plans(log2n):
    """Both plans match the compiled constants and fit the H100's shared
    memory exactly up to n_fft 16384, where the layout takes the shared
    mode; from 32768 to 131072 the cluster mode's share (the filters' only
    where L == n_fft); above, and for the filters' shorter L, the split
    mode's radix-2 launch."""
    n = 1 << log2n
    register = n <= MAX_REGISTER_N
    clusters = MAX_REGISTER_N < n <= MAX_CLUSTER_N
    for taps in {1, n // 2 - DELAY_PAD + 1, n - DELAY_PAD}:
        p = filters_plan(taps, n)
        assert (p.taps, p.n, p.t_pad) == (taps, n, taps + DELAY_PAD)
        assert p.L == 1 << (taps + DELAY_PAD - 1).bit_length() <= n
        assert (p.body == REGISTER) == register
        assert (p.body == CLUSTER) == (clusters and p.L == n)
        fits = p.shared_f2 * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES
        assert fits == (register or p.body == CLUSTER)
        assert _layout.launch_mode(p.body, p.shared_f2, n, H100_SHARED_BYTES
                                   ) == ((p.body, 0) if fits else
                                         (_layout.SPLIT, _layout.SPLIT_WORK))
        assert p.scratch_f2 == n + 2 * p.L
        if p.body == CLUSTER:
            assert p.ranks == n // MAX_REGISTER_N
            assert (p.threads, p.rows_per_block, p.blocks_per_sm) == (
                1024, 1, 1)
            assert p.shared_f2 == MAX_REGISTER_N + MAX_REGISTER_N // 16
        elif register:
            radices, threads, _ = _compiled_plan(n)
            assert p.radices_n == radices
            assert p.radices_L == _compiled_plan(p.L)[0]
            assert p.threads == threads == n // 16
            assert p.rows_per_block == _compiled_rows(n, p.L)
            assert p.blocks_per_sm == _compiled_min_blocks(threads)
            assert p.shared_f2 == n + n // 16
            # G groups of L/16 threads and their padded slices fit the
            # block and its one buffer; each row gives each thread ≥ 1
            # first-pass input of rfft_n
            G = p.rows_per_block
            assert G * p.L // 16 <= p.threads
            assert G * (p.L + p.L // 16) <= p.shared_f2
            assert 16 % G == 0 and G * p.L <= n
        else:
            assert (p.threads, p.rows_per_block) == (FILTERS_SPLIT_THREADS, 1)
    m = mix_plan(n)
    assert (m.body == REGISTER) == register
    assert (m.body == CLUSTER) == clusters
    fits = m.group_f2 * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES
    assert fits == (register or clusters)
    assert m.scratch_f2 == n + 2 * (n // 2 + 1)
    if clusters:
        assert m.ranks == n // MAX_REGISTER_N
        assert (m.threads, m.max_groups, m.blocks_per_sm) == (1024, 1, 1)
        assert m.group_f2 == MAX_REGISTER_N + MAX_REGISTER_N // 16
    elif register:
        radices, threads, _ = _compiled_plan(n)
        assert (m.radices, m.threads) == (radices, threads)
        # mix_group_f2, mix_max_groups and mix_min_blocks: the
        # accumulators' slices beside the buffer below 16384; a block of at
        # most 512 threads' worth fits the H100's shared memory; 64
        # registers a thread
        acc = 18 * threads if n < MAX_REGISTER_N else 0
        assert m.group_f2 == n + n // 16 + acc
        assert m.max_groups == (1 if threads >= 512 else 512 // threads)
        assert m.blocks_per_sm == (1 if threads >= 1024 else 2)
        assert (m.max_groups * m.group_f2 * 8 + _layout._STATIC_SMEM
                <= H100_SHARED_BYTES)
        assert 65536 // (m.blocks_per_sm * m.max_groups * threads) == 64
    else:
        assert (m.threads, m.max_groups) == (MIX_SPLIT_THREADS, 1)


def test_mix_groups_fill_the_card():
    """One group where the blocks fill the card (render (a), (m)); powers
    of two up to the plan's, and at most S, where they do not: 4 at the
    scene check's 64 sources × 128 blocks on 132 SMs; 1 with no card."""
    p = mix_plan(2048)
    assert mix_groups(1, 8192, p, 132) == 1
    assert mix_groups(16, 1024, p, 132) == 1
    assert mix_groups(64, 128, p, 132) == 4
    assert mix_groups(3, 40, p, 132) == 2
    assert mix_groups(64, 128, p, 0) == 1
    assert mix_groups(64, 1, mix_plan(16384), 132) == 1
    for S, nb in ((64, 1), (5, 17), (200, 3)):
        g = mix_groups(S, nb, mix_plan(512), 132)
        assert g & (g - 1) == 0 and g <= min(S, mix_plan(512).max_groups)


def test_plans_reject_bad_sizes():
    for taps, n in ((128, 96), (128, 128), (0, 128), (4040, 4096)):
        with pytest.raises(ValueError):
            filters_plan(taps, n)
    for n in (64, 96, 3000):
        with pytest.raises(ValueError):
            mix_plan(n)


def _group_passes(v, radices, n: int, tw, size: int, offs):
    """`reg_passes` of G rows at once, row g's exchange buffer at offs[g]
    of one shared array of ``size``: v (G, T, 16) → the last pass's."""
    G, T = v.shape[:2]
    lane = np.arange(T)
    strides = [int(np.prod(radices[:p])) for p in range(len(radices))]
    offs = np.asarray(offs)[:, None, None]
    for p in range(1, len(radices)):
        Rq, Nq = radices[p - 1], strides[p - 1]
        j = lane[:, None] + np.arange(16 // Rq)[None, :] * T
        pos = ((j // Nq) * Nq * Rq + j % Nq)[..., None] + np.arange(Rq) * Nq
        buf = _exchange(size, offs + _pad(pos.reshape(T, 16)), v)
        R, Ns = radices[p], strides[p]
        j = lane[:, None] + np.arange(16 // R)[None, :] * T
        at = _pad(j[..., None] + np.arange(R) * (n // R)).reshape(T, 16)
        x = _read(buf, offs + at).reshape(G, T, 16 // R, R)
        m = np.arange(R) * (j % Ns)[..., None] * (n // (Ns * R))
        v = _dft(x * tw[m], R).reshape(G, T, 16)
    return v


def _model_filters(idx, w, table, n: int, apply_itd: bool = True,
                   apply_ild: bool = True) -> np.ndarray:
    """`assemble_filters`' map by its index maps, G rows per CUDA block:
    → H (rows, 2, F) complex64. With ITD and ILD on, each row's H must
    equal `_model_row`'s (the same arithmetic, other exchanges) bit for
    bit; without, the delays clip to 0 and the gains are 1."""
    p = filters_plan(table.taps, n)
    arrays = (idx.numpy(), w.numpy(), table.h.reshape(-1, 2, table.taps).numpy(),
              table.delays.reshape(-1, 2).numpy(),
              table.gains.reshape(-1, 2).numpy())
    L, T, G = p.L, p.threads, p.rows_per_block
    TL, M, size, F = L // 16, 16 // G, n + n // 16, n // 2 + 1
    twL, twN = twiddles(L, CPU).numpy(), twiddles(n, CPU).numpy()
    rows = idx.shape[0]
    H = np.full((rows, 2, F), np.nan + 0j, np.complex64)
    writes = np.zeros((rows, 2, F), int)
    lane = np.arange(T)
    for r0 in range(0, rows, G):
        live = list(range(r0, min(rows, r0 + G)))
        offs = np.arange(len(live)) * (L + L // 16)  # the group slices
        dg = [_delays_gains(r, arrays) if apply_itd and apply_ild else (
            [np.float32(0)] * 2, [np.float32(1)] * 2) for r in live]
        assert apply_itd == apply_ild
        v = np.stack([_gathered(r, arrays, p) for r in live])
        v = _group_passes(v, p.radices_L, L, twL, size, offs)  # conj(rfft_L)
        tpos = _last_positions(p.radices_L, L)
        X = _exchange(size, offs[:, None, None] + tpos, np.conj(v))
        # the ramp pass of each group over its own slice, each bin once
        pos, vals = zip(*(_ramp_pack(X, L, d, g, off)
                          for (d, g), off in zip(dg, offs)))
        Z = _exchange(size, np.concatenate(pos), np.concatenate(vals))
        t = np.arange(TL)[:, None] + np.arange(16)[None, :] * TL
        v = _dft(_read(Z, offs[:, None, None] + t).astype(np.complex64), 16)
        v = _group_passes(v, p.radices_L, L, twL, size, offs)  # L·h_eff
        # h_eff truncated and scaled at g·L + t, then each thread holds
        # conj(h_eff_g[lane + m·T]) for m < 16/G
        keep = np.broadcast_to(tpos < p.t_pad, v.shape)
        at = (np.arange(len(live)) * L)[:, None, None] + tpos
        hbuf = _exchange(size, at[keep], (v * np.float32(1 / L))[keep])
        th = lane[:, None] + np.arange(M)[None, :] * T
        assert M * T >= L  # the rest of rfft_n's input is zero: t ≥ L
        for g, r in enumerate(live):
            x = np.zeros((T, 16), np.complex64)
            x[:, :M] = np.where(th < p.t_pad, np.conj(_read(
                hbuf, g * L + np.minimum(th, p.t_pad - 1))), 0)
            v = _reg_passes(_dft(x, 16), p.radices_n, n, twN)  # conj(rfft_n)
            Zn = _exchange(size, _last_positions(p.radices_n, n), np.conj(v))
            kb = lane[:, None] + np.arange(8)[None, :] * T
            A, B = _unpack(_read(Zn, kb), _read(Zn, (n - kb) & (n - 1)))
            Aq, Bq = _unpack(_read(Zn, np.array([n // 2])),
                             _read(Zn, np.array([n // 2])))
            for e, val, valq in ((0, A, Aq[0]), (1, B, Bq[0])):
                H[r, e, kb], H[r, e, n // 2] = val, valq
                np.add.at(writes[r, e], kb, 1)
                writes[r, e, n // 2] += 1
            if apply_itd:
                want = _model_row(r, arrays, p)
                assert all(np.array_equal(a, b) for a, b in zip(
                    (kb, A, B, Aq[0], Bq[0]), want))
    assert (writes == 1).all()  # every output bin written once
    return H


@pytest.mark.parametrize("L,n", PAIRS)
def test_filters_model_matches_reference(L, n):
    """The model against the float64 `assemble_filters_reference` at every
    (L, n) pair of the shared plan, n_fft 128 … 16384: G + 1 rows, so the
    second block holds one live row, t_pad just above L/2 or just below L;
    ≥ 100 dB."""
    i = PAIRS.index((L, n))
    taps = L - DELAY_PAD - 3 if i % 2 else max(1, L // 2 - DELAY_PAD + 1)
    assert filters_plan(taps, n).L == L
    table = _table(taps, seed=i)
    rows = filters_plan(taps, n).rows_per_block + 1
    rng = np.random.default_rng(i)
    idx = torch.from_numpy(rng.integers(0, 8, (rows, 4)).astype(np.int32))
    w = rng.uniform(0.1, 1.0, (rows, 4))
    w = torch.from_numpy((w / w.sum(1, keepdims=True)).astype(np.float32))
    got = _model_filters(idx, w, table, n)
    ref = br.assemble_filters_reference(idx, w.double(), table, n,
                                        **FLAGS).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _snr_db(ref, got) >= 100, _snr_db(ref, got)


def _model_mix(xbs: np.ndarray, H: np.ndarray, n: int, crossfade: bool,
               groups: int = 1) -> np.ndarray:
    """`block_spectra_mix_inverse`' map by its index maps, one output block
    per CUDA block of ``groups`` groups, group g summing sources g,
    g + groups, … and group 0 adding the groups' sums in order: xbs (S,
    nb, B) f32, H (S, nb, 2, F) complex64 → frames (nb, 2, n) f32."""
    p = mix_plan(n)
    T, size, f32 = p.threads, n + n // 16, np.float32
    S, nb, B = xbs.shape
    tw = twiddles(n, CPU).numpy()
    lane = np.arange(T)
    t = lane[:, None] + np.arange(16)[None, :] * T
    kb = lane[:, None] + np.arange(8)[None, :] * T  # each thread's bins
    u = ((t + f32(0.5)) * f32(1 / B)).astype(f32)
    frames = np.full((nb, 2, n), np.nan, np.float32)
    for b in range(nb):
        acc = np.zeros((groups, 2, T, 8), np.complex64)
        accq = np.zeros((groups, 2), np.complex64)  # bin n/2 on lane 0
        for s in range(S):  # each group's in order
            x = np.where(t < B, xbs[s, b][np.minimum(t, B - 1)], f32(0))
            if crossfade:  # conj(x·u + i·x·(1−u))
                xu = (x * u).astype(f32)
                z = xu + 1j * (xu - x)
            else:
                z = x + 0j
            v = _reg_passes(_dft(z.astype(np.complex64), 16), p.radices, n, tw)
            X = _exchange(size, _last_positions(p.radices, n), np.conj(v))
            Hc, Hp = H[s, b], H[s, max(b - 1, 0)]
            for k, sl in ((kb, np.s_[:, :]), (np.array(n // 2), None)):
                if crossfade:
                    Xu, Xd = _unpack(_read(X, k), _read(X, (n - k) & (n - 1)))
                    y = Xu * Hc[:, k] + Xd * Hp[:, k]
                else:
                    y = _read(X, k) * Hc[:, k]
                if sl is None:
                    accq[s % groups] += y
                else:
                    acc[s % groups] += y
        # group 0 adds the others' sums in order, then packs Z = A + i·B at
        # k and n − k, DC and Nyquist real
        for g in range(1, groups):
            acc[0] += acc[g]
            accq[0] += accq[g]
        A, Bv = acc[0]
        A = np.where(kb == 0, A.real, A)
        Bv = np.where(kb == 0, Bv.real, Bv)
        Aq, Bq = accq[0].real
        mid = kb != 0
        Z = _exchange(size, np.concatenate([kb.ravel(), [n // 2],
                                            (n - kb)[mid]]),
                      np.concatenate([
                          ((A.real - Bv.imag) + 1j * (A.imag + Bv.real)).ravel(),
                          [Aq + 1j * Bq],
                          ((A.real + Bv.imag) + 1j * (Bv.real - A.imag))[mid]]))
        v = _reg_passes(_dft(_read(Z, t).astype(np.complex64), 16),
                        p.radices, n, tw)
        pos = _last_positions(p.radices, n)
        assert (np.sort(pos.ravel()) == np.arange(n)).all()
        frames[b, 0, pos] = v.real * f32(1 / n)
        frames[b, 1, pos] = v.imag * f32(1 / n)
    return frames


def _mix_inputs(S: int, nb: int, B: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    F = n // 2 + 1
    xbs = rng.standard_normal((S, nb, B)).astype(np.float32)
    H = (rng.standard_normal((S, nb, 2, F))
         + 1j * rng.standard_normal((S, nb, 2, F))).astype(np.complex64)
    return xbs, H


@pytest.mark.parametrize("crossfade", [True, False])
@pytest.mark.parametrize("S,groups", [(1, 1), (3, 1), (3, 2)])
@pytest.mark.parametrize("log2n", LOG2_SIZES)
def test_mix_model_matches_reference(log2n, S, groups, crossfade):
    """The model against the float64 `block_spectra_mix_inverse_reference`
    at n_fft 128 … 16384, over 3 output blocks (block 0 takes its own
    filter as the previous one), B = n/2, with one group or two (where the
    plan takes two: the second idles in the last round): ≥ 120 dB."""
    n = 1 << log2n
    groups = min(groups, mix_plan(n).max_groups)
    xbs, H = _mix_inputs(S, 3, n // 2, n, seed=log2n * 10 + S)
    got = _model_mix(xbs, H, n, crossfade, groups)
    ref = br.block_spectra_mix_inverse_reference(
        torch.from_numpy(xbs).double(), torch.from_numpy(H).to(
            torch.complex128), n, crossfade=crossfade).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _snr_db(ref, got) >= 120, _snr_db(ref, got)


@pytest.mark.parametrize("decompose", [True, False])
def test_models_chained_match_pallas_kernel(decompose):
    """Both models chained through the overlap-add against the JAX
    package's `fused_block_render` in interpret mode, on
    `test_torch_block_render.py`'s inputs (S = 2, nb = 6, B = 256, n_fft
    512), ITD and ILD on and off: ≥ 90 dB."""
    arrays = tinaural.load_hrir_set("synthetic", decompose=decompose)
    t = TorchTable.from_hrir_table(arrays, "cpu")
    xbs, idx, w = _render_inputs(t, seed=20 + decompose)
    S, nb, B = xbs.shape
    n_fft = _n_fft(t, B)
    assert n_fft == 512
    flags = dict(apply_itd=decompose, apply_ild=decompose)
    H = _model_filters(idx.reshape(S * nb, 4), w.reshape(S * nb, 4), t,
                       n_fft, **flags).reshape(S, nb, 2, -1)
    frames = _model_mix(xbs.numpy(), H, n_fft, crossfade=True)
    ours = overlap_add(torch.from_numpy(frames).transpose(0, 1), B).numpy()
    ht, dg = gather_tables(jnp.asarray(arrays.h), jnp.asarray(arrays.delays),
                           jnp.asarray(arrays.gains), t.taps, n_fft)
    theirs = np.asarray(fused_block_render(
        None, None, None, jnp.asarray(xbs.numpy()), t.taps, n_fft,
        idx=jnp.asarray(idx.numpy().astype(np.float32)),
        w=jnp.asarray(w.numpy()), ht=ht, dg=dg, interpret=True,
        crossfade=True, **flags))
    assert ours.shape == theirs.shape == (2, (nb - 1) * B + n_fft)
    assert _snr_db(theirs.astype(np.float64), ours) >= 90

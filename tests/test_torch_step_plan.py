"""The launch plans of the block-step kernels' register bodies,
`block_spectra` and `block_spectra_mix`, and numpy models of both, on the
CPU.

The models follow ``csrc/block_step.cu`` and ``csrc/fft_reg.cuh`` index by
index. `_model_spectra` runs a CUDA block's G rows at once, each group of
T = n/16 threads in its own slice of the block's one shared array: the
first pass's input conjugated (the packed ramps z = x·u + i·x·(1−u)), the
register passes (every exchange writes each position once across all
groups and reads back only what was written), the exchange to natural
order, then each live row's bins lane + i·T and n/2 unpacked, multiplied
by its filter rows ⌊b/k⌋ and ⌊(b−1)/k⌋ and written once. `_model_mix`
runs one (chunk, output block) per CUDA block in ``groups`` groups, group
j taking the chunk's sources j, j + groups, … in rounds, its 18 sums a
thread in its slice beside its buffer, then the block's threads adding
the groups' slots in order into P, value by value as the kernel's flat
loop addresses them. Held against the float64 plain versions, and chained
through the inverse and the overlap-add against the JAX package's
`fused_block_step` and `fused_block_step_mix` + `fused_epilogue` in
interpret mode, they pin the index maps before a card runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from test_torch_block_render_plan import _group_passes
from test_torch_inverse_plan import _dft
from test_torch_mac_plan import (CPU, H100_SHARED_BYTES, LOG2_SIZES,
                                 _compiled_plan, _exchange, _last_positions,
                                 _read, _snr_db, _unpack)
from tinaural_torch.data import TorchTable
from tinaural_torch.models.renderer import _n_fft, _neighbours
from tinaural_torch.ops import _layout
from tinaural_torch.ops._layout import REGISTER
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops import block_step as bs
from tinaural_torch.ops.block_render import filter_rows
from tinaural_torch.ops.ola import overlap_add
from tinaural_torch.ops.spectra_inverse import MAX_REGISTER_N, twiddles
from tinaural_torch.ops.step_plan import (RADIX2_THREADS, mix_groups,
                                          mix_launch, pruned_plan,
                                          radix2_plan, spectra_rows,
                                          step_plan)

torch.set_num_threads(1)

f32 = np.float32


def _compiled_max_per_block(threads: int) -> int:
    """step_max_per_block of the CUDA source."""
    return 1 if threads >= 512 else 512 // threads


def _compiled_min_blocks(threads: int) -> int:
    """step_min_blocks of the CUDA source."""
    return 1 if threads >= 1024 else 2


def _compiled_unit_f2(n: int, mix: bool) -> int:
    """step_unit_f2 of the CUDA source: RegPlan::row_f2, and the mix
    kernel's 18 sums a thread below n_fft 16384."""
    return n + n // 16 + (18 * (n // 16) if mix and n < 16384 else 0)


@pytest.mark.parametrize("mix", [False, True])
@pytest.mark.parametrize("log2n", range(7, 25))
def test_step_plans(log2n, mix):
    """Both plans match the compiled constants: the register body at
    n_fft 128 … 16384, whose largest block fits the H100's shared memory,
    so the layout takes the shared mode; above, the pruned body at block
    1024 (Q 1024, `tests/test_torch_step_pruned_plan.py`), whose block
    fits too, so the layout takes the pruned mode, and beside it the
    radix-2 body of the split mode, whose shared figure does not fit."""
    n = 1 << log2n
    p = step_plan(n, mix)
    register = n <= MAX_REGISTER_N
    assert (p.body == REGISTER) == register and p.n == n
    F = n // 2 + 1
    assert p.scratch_f2 == n + (2 * F if mix else 0)
    if register:
        radices, threads, _ = _compiled_plan(n)
        assert (p.radices, p.threads) == (radices, threads)
        assert p.max_per_block == _compiled_max_per_block(threads)
        assert p.blocks_per_sm == _compiled_min_blocks(threads)
        assert p.unit_f2 == _compiled_unit_f2(n, mix)
        assert p.max_per_block * threads <= 512 or threads == 1024
        big = p.shared_f2(p.max_per_block)
        assert big * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES
        assert _layout.launch_mode(p.body, big, n,
                                   H100_SHARED_BYTES) == (REGISTER, 0)
        # 64 registers a thread under __launch_bounds__
        assert 65536 // (p.blocks_per_sm * p.max_per_block * threads) == 64
    else:
        q = pruned_plan(n, mix, 1024)
        assert q is not None and (q.Q, q.P) == (1024, n // 1024)
        assert q.radices == _compiled_plan(1024)[0]
        assert _layout.launch_mode(q.body, q.shared_f2, n,
                                   H100_SHARED_BYTES) == (_layout.PRUNED, 0)
        assert q.scratch_f2 == p.scratch_f2
        assert p == radix2_plan(n, mix)
        assert (p.threads, p.max_per_block, p.blocks_per_sm) == (
            RADIX2_THREADS, 1, 1)
        assert p.unit_f2 == n // 2 + n + (2 * F if mix else 0)
        assert _layout.launch_mode(p.body, p.shared_f2(1), n,
                                   H100_SHARED_BYTES) == (_layout.SPLIT,
                                                          _layout.SPLIT_WORK)


@pytest.mark.parametrize("n", [2, 16, 64])
def test_small_sizes_take_the_radix2_body(n):
    """Below n_fft 128 both kernels run the radix-2 body in shared
    memory."""
    for mix in (False, True):
        p = step_plan(n, mix)
        assert p.body != REGISTER and p.threads == RADIX2_THREADS
        assert _layout.launch_mode(p.body, p.shared_f2(1), n,
                                   H100_SHARED_BYTES) == (_layout.RADIX2, 0)
    with pytest.raises(ValueError):
        step_plan(96, False)


def test_launch_rules():
    """block_spectra's G: the fewest rows of 128 threads while the blocks
    fill ROW_FILL an SM (one row at n_fft 2048 up: (i)'s 8192 rows and
    (h)'s 4096; 16 of 8 threads at 128, fewer where the rows are few).
    block_spectra_mix: the blocks an SM holds at once
    by the H100's limits (6 groups of 128 threads at n_fft 2048, 5 KB of
    shared memory left), and (b)'s 64 × 128 on 3 chunks of 2 groups: 384
    blocks, one wave of 11 sources a group."""
    p = step_plan(2048, False)
    assert spectra_rows(p, 8192, 132) == spectra_rows(p, 4096, 132) == 1
    assert spectra_rows(p, 32, 0) == 1
    assert spectra_rows(step_plan(16384, False), 4096, 132) == 1
    p = step_plan(128, False)
    assert spectra_rows(p, 8192, 132) == 16
    assert spectra_rows(p, 8192, 0) == 16
    assert spectra_rows(p, 1000, 132) == 2
    assert spectra_rows(step_plan(512, False), 8192, 132) == 4
    m = step_plan(2048, True)
    assert [m.resident_blocks(g) for g in (1, 2, 4)] == [6, 3, 1]
    assert mix_launch(64, 128, 2048, 132, 1024, True) == (22, 2)
    assert mix_groups(m, 22, 3 * 128, 132) == 2
    assert mix_groups(m, 22, 3 * 128, 0) == 1
    assert mix_groups(radix2_plan(2048, True), 22, 384, 132) == 1
    for S, nb, n in ((64, 128, 2048), (16, 1024, 2048), (5, 40, 512),
                     (200, 3, 128), (7, 9, 16384)):
        chunk, groups = mix_launch(S, nb, n, 132, n // 2, True)
        plan = step_plan(n, True)
        assert 1 <= chunk <= S and groups & (groups - 1) == 0
        assert groups <= min(chunk, plan.max_per_block)
        assert groups == mix_groups(plan, chunk, -(-S // chunk) * nb, 132)


def _first_pass(x: np.ndarray, B: int, n: int, crossfade: bool) -> np.ndarray:
    """A group's first-pass input: conj(z[t]) at v[lane, m], t = lane +
    m·T, zeros past B (x None: all zeros, an idle row)."""
    T = n // 16
    t = np.arange(T)[:, None] + np.arange(16)[None, :] * T
    if x is None:
        return np.zeros((T, 16), np.complex64)
    v = np.where(t < B, x[np.minimum(t, B - 1)], f32(0)).astype(f32)
    if crossfade:  # conj(x·u + i·x·(1−u)), u = (t + 0.5)·(1/B) in float32
        u = ((t + f32(0.5)) * f32(1 / B)).astype(f32)
        xu = (v * u).astype(f32)
        return (xu + 1j * (xu - v)).astype(np.complex64)
    return v.astype(np.complex64)


def _forward(xs: list, B: int, n: int, crossfade: bool, size: int,
             offs) -> np.ndarray:
    """The forward transforms of len(xs) groups at once in one shared
    array of ``size`` complex64, group g's buffer at offs[g]: → the array
    after the exchange to natural order (bin k of group g at offs[g] +
    k)."""
    p = step_plan(n, False)
    tw = twiddles(n, CPU).numpy()
    v = _dft(np.stack([_first_pass(x, B, n, crossfade) for x in xs]), 16)
    v = _group_passes(v, p.radices, n, tw, size, offs)
    pos = np.asarray(offs)[:, None, None] + _last_positions(p.radices, n)
    return _exchange(size, pos, np.conj(v))


def _filter_rows(b: int, k: int) -> tuple[int, int]:
    """Block b's filter row and its predecessor's (filter_row)."""
    hc = b // k
    return hc, hc - 1 if b > 0 and b == hc * k else hc


def _bins(X: np.ndarray, off: int, n: int, crossfade: bool, Hc, Hp):
    """Thread lane's bins k = lane + i·T (T, 8) and lane 0's n/2: (k, y)
    of both ears, as mac_bin computes them."""
    T = n // 16
    out = []
    for k in (np.arange(T)[:, None] + np.arange(8)[None, :] * T,
              np.array([n // 2])):
        if crossfade:
            Xu, Xd = _unpack(_read(X, off + k), _read(X, off + ((n - k) & (n - 1))))
            y = Xu * Hc[:, k] + Xd * Hp[:, k]
        else:
            y = _read(X, off + k) * Hc[:, k]
        out.append((k, y.astype(np.complex64)))
    return out


def _model_spectra(xbs: np.ndarray, H: np.ndarray, n: int, crossfade: bool,
                   dir_rate: int, G: int) -> np.ndarray:
    """`block_spectra`' register body by its index maps, G rows per CUDA
    block: xbs (S, nb, B) f32, H (S, ⌈nb/k⌉, 2, F) complex64 → Y (S, nb, 2,
    F) complex64, every bin written once."""
    p = step_plan(n, False)
    S, nb, B = xbs.shape
    F, rows = n // 2 + 1, S * nb
    Y = np.full((rows, 2, F), np.nan + 0j, np.complex64)
    writes = np.zeros((rows, 2, F), int)
    offs = np.arange(G) * p.unit_f2
    for blk in range(-(-rows // G)):
        r = blk * G + np.arange(G)
        live = r < rows
        xs = [xbs.reshape(rows, B)[q] if ok else None
              for q, ok in zip(r, live)]
        X = _forward(xs, B, n, crossfade, G * p.unit_f2, offs)
        for g in np.flatnonzero(live):
            s, b = divmod(int(r[g]), nb)
            hc, hp = _filter_rows(b, dir_rate)
            for k, y in _bins(X, offs[g], n, crossfade, H[s, hc], H[s, hp]):
                Y[r[g]][:, k] = y
                np.add.at(writes[r[g]], (slice(None), k), 1)
    assert (writes == 1).all()
    return Y.reshape(S, nb, 2, F)


def _model_mix(xbs: np.ndarray, H: np.ndarray, n: int, crossfade: bool,
               dir_rate: int, chunk: int, groups: int) -> np.ndarray:
    """`block_spectra_mix`' register body by its index maps, one (chunk c,
    block b) per CUDA block in ``groups`` groups, each thread's sums in its
    slots beside its group's buffer (below n_fft 16384) and the block's
    threads adding the groups' slots in order: → P (⌈S/chunk⌉, nb, 2, F)
    complex64, every value written once."""
    p = step_plan(n, True)
    T, unit, row = p.threads, p.unit_f2, n + n // 16
    S, nb, B = xbs.shape
    F, C = n // 2 + 1, -(-S // chunk)
    size = groups * unit
    offs = np.arange(groups) * unit
    # at n_fft 16384 (one group) the sums are in registers: the same
    # slots, past the buffer
    slots = size if n < MAX_REGISTER_N else row + 18 * T
    lane = np.arange(T)
    P = np.full((C * nb, 2 * F), np.nan + 0j, np.complex64)
    writes = np.zeros((C * nb, 2 * F), int)
    for blk in range(C * nb):
        c, b = divmod(blk, nb)
        s0, s_end = c * chunk, min(S, c * chunk + chunk)
        # the slots: group g's slot j of lane l at g·unit + row + j·T + l,
        # lane 0's slots 16, 17 (bin n/2) the only ones of i = 8 read
        acc = np.full(slots, np.nan + 0j, np.complex64)
        slot = lambda g, j, l: offs[g] + row + j * T + l
        for g in range(groups):
            for j in range(18):
                acc[slot(g, j, lane)] = 0
        for rnd in range(-(-(s_end - s0) // groups)):
            s = s0 + rnd * groups + np.arange(groups)
            live = s < s_end
            xs = [xbs[q, b] if ok else None for q, ok in zip(s, live)]
            X = _forward(xs, B, n, crossfade, size, offs)
            # the exchange buffers never reach the slots
            assert all(np.isnan(X[offs[g] + row:offs[g] + unit]).all()
                       for g in range(groups))
            for g in np.flatnonzero(live):
                hc, hp = _filter_rows(b, dir_rate)
                for (k, y), lanes, i in zip(
                        _bins(X, offs[g], n, crossfade, H[s[g], hc],
                              H[s[g], hp]),
                        (lane[:, None], np.array([0])),
                        (np.arange(8)[None, :], np.array([8]))):
                    for e in range(2):
                        at = slot(g, 2 * i + e, lanes)
                        acc[at] = (acc[at] + y[e]).astype(np.complex64)
        # the flat loop over P's 2F values: v = e·F + k, slot 2(k / T) + e
        # of lane k % T, the groups added in order
        v = np.arange(2 * F)
        e, k = v // F, v % F
        at = row + (2 * (k // T) + e) * T + k % T
        total = _read(acc, at)
        for g in range(1, groups):
            total = (total + _read(acc, offs[g] + at)).astype(np.complex64)
        P[blk, v] = total
        writes[blk, v] += 1
    assert (writes == 1).all()
    return P.reshape(C, nb, 2, F)


def _inputs(S: int, nb: int, B: int, n: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    F = n // 2 + 1
    xbs = rng.standard_normal((S, nb, B)).astype(np.float32)
    fnb = filter_rows(nb, k)
    H = (rng.standard_normal((S, fnb, 2, F))
         + 1j * rng.standard_normal((S, fnb, 2, F))).astype(np.complex64)
    return xbs, H


def _f64(a):
    return torch.from_numpy(a).to(torch.complex128 if np.iscomplexobj(a)
                                  else torch.float64)


@pytest.mark.parametrize("crossfade", [True, False])
@pytest.mark.parametrize("log2n", LOG2_SIZES)
def test_spectra_model_matches_reference(log2n, crossfade):
    """The model against the float64 `block_spectra_reference` at every
    n_fft 128 … 16384, B = n/2, G the plan's most: at dir_rate 1 (2
    sources × 3 blocks, so at G 4 the second CUDA block holds 2 idle rows
    and at n_fft 128 one block 58 of its 64), dir_rate 4 over nb = 7 (not
    a multiple of 4) and dir_rate ≥ nb (one filter a source): ≥ 110 dB."""
    n = 1 << log2n
    p = step_plan(n, False)
    G = p.max_per_block
    for S, nb, k in ((2, 3, 1), (1, 7, 4), (2, 2, 5)):
        xbs, H = _inputs(S, nb, n // 2, n, k, seed=log2n * 10 + k)
        got = _model_spectra(xbs, H, n, crossfade, k, G)
        ref = bs.block_spectra_reference(_f64(xbs), _f64(H), n,
                                         crossfade=crossfade,
                                         dir_rate=k).numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert _snr_db(ref, got) >= 110, (n, S, nb, k, _snr_db(ref, got))


@pytest.mark.parametrize("crossfade", [True, False])
@pytest.mark.parametrize("log2n", LOG2_SIZES)
def test_mix_model_matches_reference(log2n, crossfade):
    """The model against the float64 `block_spectra_mix_reference` at
    every n_fft 128 … 16384, B = n/2: 5 sources in chunks of 2 (the last
    chunk one source) on one group and on two (where the plan takes two:
    the second idles in the last chunk's round), 3 blocks at dir_rate 1
    and 2 (the crossfade across a group boundary, nb no multiple of k),
    and one chunk of all 5 on the most groups the plan takes at dir_rate
    4 ≥ nb (one filter a source): ≥ 110 dB."""
    n = 1 << log2n
    most = step_plan(n, True).max_per_block
    for chunk, groups, k in ((2, 1, 1), (2, min(2, most), 2),
                             (5, min(4, most), 4)):
        xbs, H = _inputs(5, 3, n // 2, n, k, seed=log2n * 10 + groups + k)
        got = _model_mix(xbs, H, n, crossfade, k, chunk, groups)
        ref = bs.block_spectra_mix_reference(
            _f64(xbs), _f64(H), n, crossfade=crossfade, chunk=chunk,
            dir_rate=k).numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert _snr_db(ref, got) >= 110, (n, chunk, groups, k)


@pytest.mark.parametrize("crossfade", [True, False])
def test_models_chained_match_pallas_kernels(crossfade):
    """Both models chained through the plain inverse and overlap-add
    against the JAX package's `fused_block_step` + `fused_epilogue` and
    `fused_block_step_mix` + `fused_epilogue` in interpret mode, on
    filters the port's plain `assemble_filters` made from the same
    directions (S = 3, nb = 5, B = 256, n_fft 512), time-domain stereo:
    ≥ 90 dB (the bar the port's plain spectra meet against the JAX
    package's, `tests/test_torch_batch.py`)."""
    from tinaural.models.renderer import (_fused_ola_from_planes,
                                          _scene_spectra_fused,
                                          _trajectory_spectra_scrambled)

    arrays = tinaural.load_hrir_set("synthetic")
    t = TorchTable.from_hrir_table(arrays, "cpu")
    B, S, nb = 256, 3, 5
    n_fft = _n_fft(t, B)
    assert n_fft == 512
    rng = np.random.default_rng(30 + crossfade)
    xbs = rng.standard_normal((S, nb, B)).astype(np.float32)
    dirs = rng.uniform(0, 360, (S, nb, 2)).astype(np.float32)
    idx, w = _neighbours(t, torch.from_numpy(dirs),
                         tinaural_torch.RenderConfig())
    H = br.assemble_filters_reference(idx, w, t, n_fft, apply_itd=True,
                                      apply_ild=True).numpy()
    jcfg = tinaural.RenderConfig(block_size=B, use_pallas=True,
                                 pallas_interpret=True, crossfade=crossfade)
    tb = jax.device_put(arrays)

    G = spectra_rows(step_plan(n_fft, False), S * nb, 0)
    Y = _model_spectra(xbs, H, n_fft, crossfade, 1, G)
    frames = bs.spectra_inverse_reference(torch.from_numpy(Y), n_fft)
    ours = overlap_add(frames.transpose(1, 2), B).numpy()
    theirs = np.asarray(_fused_ola_from_planes(
        *_trajectory_spectra_scrambled(tb, jnp.asarray(xbs),
                                       jnp.asarray(dirs), jcfg),
        n_fft, B, jcfg))
    assert ours.shape == theirs.shape == (S, 2, (nb - 1) * B + n_fft)
    assert _snr_db(theirs.astype(np.float64), ours) >= 90

    P = _model_mix(xbs, H, n_fft, crossfade, 1, chunk=2, groups=2)
    mixed = torch.from_numpy(P[0] + P[1])  # the summing inverse's order
    frames = bs.spectra_inverse_reference(mixed, n_fft)
    ours = overlap_add(frames.transpose(0, 1), B).numpy()
    theirs = np.asarray(_fused_ola_from_planes(
        *_scene_spectra_fused(tb, jnp.asarray(xbs), jnp.asarray(dirs), jcfg,
                              n_fft), n_fft, B, jcfg))
    assert ours.shape == theirs.shape == (2, (nb - 1) * B + n_fft)
    assert _snr_db(theirs.astype(np.float64), ours) >= 90

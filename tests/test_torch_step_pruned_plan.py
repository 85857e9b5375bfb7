"""The pruned mode of the block-step kernels `block_spectra` and
`block_spectra_mix` (n_fft above 16384) on the CPU: its plans against the
CUDA constants, numpy models of both pruned bodies against the float64
plain versions, and the port's static render, static scene and (through
the mix model) moving scene at 16,384 taps against the JAX package.

A block of B samples zero-padded to n = P·Q (Q = max(next_pow2(B), 128))
has X[r + P·m] = Σ_{t<Q} (x[t]·ω_n^{r·t})·ω_Q^{m·t}: P Q-point register
transforms of the pre-twiddled block. The models follow
``csrc/block_step.cu`` namespace `pruned` index by index: every CUDA block
of a row (of a (chunk, block)) in one shared array, block j's slots at
j·shared + u·slot; the first pass's input conjugated and multiplied by
tw_n[r·lane]·tw_n[r·m·T] (t = lane + m·T); the Q-point register passes
(each exchange writes every position once and reads back only what was
written); the exchange to
natural order; then the MAC's walk over the block's outputs (`_bins`, the
kernel's `pruned_bin`), each bin's Z[n − k] read from its mirror's slot
and the two signals of each transform unpacked (both ramps of a block
under crossfade; without it two sources' blocks in the mix, while
`block_spectra` multiplies its real block's Z[k] alone), and every output
bin written once. At Q = 16384 a block takes one residue and, where it
unpacks, runs its mirror's transform first and keeps the upper half
(`_half_block`).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from conftest import snr_db
from test_torch_block_render_plan import _group_passes
from test_torch_inverse_plan import _dft
from test_torch_mac_plan import (CPU, H100_SHARED_BYTES, _compiled_plan,
                                 _exchange, _last_positions, _read, _snr_db,
                                 _unpack)
from test_torch_step_plan import _f64, _filter_rows, _first_pass, _inputs
from tinaural.models.renderer import BinauralRenderer as JaxRenderer
from tinaural_torch.data import TorchTable
from tinaural_torch.models.renderer import _n_fft, _scene_core
from tinaural_torch.ops import _layout
from tinaural_torch.ops._layout import REGISTER
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops import block_step as bs
from tinaural_torch.ops.ola import overlap_add
from tinaural_torch.ops.spectra_inverse import MAX_REGISTER_N, twiddles
from tinaural_torch.ops.step_plan import (mix_launch, pruned_plan, pruned_q,
                                          pruned_rounds, radix2_plan,
                                          step_plan)

torch.set_num_threads(1)

CSRC = Path(tinaural_torch.__file__).parent / "csrc"
B = 1024
NAN = np.complex64(np.nan + 0j)


# ------------------------------------------------------------------- plans


def _constants() -> dict:
    """The pruned bodies' constants as ``csrc/block_step.cu`` states them,
    and the formulas of its `pruned::Plan`."""
    src = (CSRC / "block_step.cu").read_text()
    fft = (CSRC / "fft_reg.cuh").read_text()
    out = {"kRegMaxLog2N": int(re.search(
        r"constexpr int kRegMaxLog2N = (\d+);", fft).group(1))}
    for name in ("kStepMinLog2", "kAccSlots", "kSpectraThreads",
                 "kMixThreads", "kBins"):
        out[name] = int(re.search(rf"constexpr int {name} = (\d+);",
                                  src).group(1))
    body = src[src.index("struct Plan {"):src.index("// log2 Q of a block")]
    for line in (
            "static constexpr bool half = kLog2Q == kRegMaxLog2N;",
            "static constexpr int aim = kMix ? kMixThreads : kSpectraThreads;",
            "static constexpr int pairs = half || 2 * T >= aim ? 1 : aim / (2 * T);",
            "static constexpr int residues = half ? 1 : 2 * pairs;",
            "static constexpr int threads = residues * T;",
            "static constexpr int min_blocks = 1024 / threads;",
            "static constexpr int slot_f2 = R::row_f2 + 1;",
            "static constexpr int mirror_f2 = half ? Q / 2 : 0;",
            "static constexpr bool shared_acc = kMix && kLog2Q < kRegMaxLog2N - 1;",
            "static constexpr int shared_f2 = residues * slot_f2 + mirror_f2 +",
            "(shared_acc ? kAccSlots * threads : 0);"):
        assert line in body, line
    # Q from B, the launch's checks and grid, the entry points' mode rule
    assert "int l = kStepMinLog2;\n  while ((1 << l) < B) ++l;" in src
    assert re.search(r"threads != L::threads \|\| residues != L::residues "
                     r"\|\|\s+blocks_per_sm != L::min_blocks", src)
    assert "static_cast<long long>(rows) * (P / L::residues)" in src
    assert src.count("if (slices == 0 && n_fft > (1 << kRegMaxLog2N)) {") == 2
    assert re.search(r"__launch_bounds__\(Plan<kLog2Q, false>::threads,\s+"
                     r"Plan<kLog2Q, false>::min_blocks\)\s+"
                     r"block_spectra_kernel\(", src)
    assert re.search(r"__launch_bounds__\(Plan<kLog2Q, true>::threads,\s+"
                     r"Plan<kLog2Q, true>::min_blocks\)\s+"
                     r"block_spectra_mix_kernel\(", src)
    return out


def _compiled(Q: int, mix: bool, c: dict) -> dict:
    """`pruned::Plan<log2 Q, mix>` computed as the CUDA source does."""
    radices, T, _ = _compiled_plan(Q)
    log2q = Q.bit_length() - 1
    half = log2q == c["kRegMaxLog2N"]
    aim = c["kMixThreads"] if mix else c["kSpectraThreads"]
    pairs = 1 if half or 2 * T >= aim else aim // (2 * T)
    residues = 1 if half else 2 * pairs
    threads = residues * T
    slot = Q + Q // 16 + 1
    shared_acc = mix and log2q < c["kRegMaxLog2N"] - 1
    shared = (residues * slot + (Q // 2 if half else 0)
              + (c["kAccSlots"] * threads if shared_acc else 0))
    return dict(radices=radices, transform_threads=T, pairs=pairs,
                residues=residues, threads=threads,
                blocks_per_sm=1024 // threads, slot_f2=slot,
                shared_acc=shared_acc, shared_f2=shared)


@pytest.mark.parametrize("B_", [64, 1024, 16384])
@pytest.mark.parametrize("log2n", range(15, 21))
def test_pruned_plans_equal_the_cuda_constants(log2n, B_, monkeypatch):
    """n 32768 … 2^20, B 64 (Q 128), 1024 and 16384 (P 2 at 32768): both
    plans equal `pruned::Plan`, fit one block's shared memory (so the
    layout takes the pruned mode) with 64 registers a thread, hold g·Q
    outputs in 8 a thread, and their residue groups cover the P residues
    once, each group closed under r → (P − r) mod P; the split mode
    under `force_work`."""
    c = _constants()
    n = 1 << log2n
    Q = pruned_q(B_)
    assert Q == max(1 << c["kStepMinLog2"], B_) and MAX_REGISTER_N == 16384
    for mix in (False, True):
        p = pruned_plan(n, mix, B_)
        assert p is not None and (p.n, p.Q, p.P, p.mix) == (n, Q, n // Q, mix)
        want = _compiled(Q, mix, c)
        assert {k: getattr(p, k) for k in want} == want
        assert p.threads <= 1024 and 65536 // (p.blocks_per_sm
                                               * p.threads) == 64
        assert p.shared_f2 * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES
        assert _layout.launch_mode(p.body, p.shared_f2, n,
                                   H100_SHARED_BYTES) == (_layout.PRUNED, 0)
        assert p.scratch_f2 == radix2_plan(n, mix).scratch_f2
        if not p.half:
            assert c["kBins"] * p.threads == p.pairs * Q
        else:
            assert c["kBins"] * p.threads == Q // 2
        seen = [r for j in range(p.groups) for r in p.block_residues(j)]
        assert sorted(seen) == list(range(p.P))
        for j in range(p.groups):
            res = set(p.block_residues(j))
            assert p.half or res == {(p.P - r) % p.P for r in res}
            assert len(p.block_residues(j)) == p.residues
        monkeypatch.setattr(_layout, "force_work", _layout.SPLIT_WORK)
        assert _layout.launch_mode(p.body, p.shared_f2, n,
                                   H100_SHARED_BYTES) == (_layout.SPLIT,
                                                          _layout.SPLIT_WORK)
        monkeypatch.setattr(_layout, "force_work", 0)


def test_the_mode_flips_at_q_above_16384():
    """Q > 16384 (B > 16384) and n_fft ≤ 16384 take no pruned plan: the
    radix-2 body's split mode, or the register body; `mix_launch` at B =
    n_fft, whose Q is the transform itself, takes the radix-2 rule."""
    for n in (1 << 15, 1 << 17, 1 << 20):
        assert pruned_plan(n, False, 16384) is not None
        assert pruned_plan(n, False, 16385) is None
        assert pruned_plan(n, True, n) is None
        assert step_plan(n, True).body != REGISTER
    assert pruned_plan(16384, False, 1024) is None
    assert pruned_plan(1 << 15, False, 1).Q == 128
    assert pruned_plan(1 << 15, False, 129).Q == 256
    with pytest.raises(ValueError):
        pruned_plan(1 << 15, False, (1 << 15) + 1)
    assert mix_launch(64, 128, 1 << 15, 132, 1 << 15, True) == (8, 1)


def test_mix_chunk_fills_waves():
    """(q), (p): 64 sources × 128 blocks at n_fft 32768, B 1024: 8 residue
    groups of 4 transforms a (chunk, block), 3 blocks an SM; the chunk of
    fewest rounds, then fewest chunks: with crossfade a source a round (13
    sources: 5 chunks, 5120 blocks, 12.9 waves of 396), without it two
    sources a round (22: 3 chunks, 3072 blocks, 7.8 waves); one chunk with
    no card."""
    p = pruned_plan(1 << 15, True, B)
    assert (p.groups, p.residues, p.resident_blocks()) == (8, 4, 3)
    for crossfade, want in ((True, 13), (False, 22)):
        chunk, groups = mix_launch(64, 128, 1 << 15, 132, B, crossfade)
        assert (chunk, groups) == (want, 4)
        assert bs.mix_chunk(64, 128, 1 << 15, 132, B, crossfade) == want
        assert all(pruned_rounds(p, 64, 128, chunk, 132, crossfade)
                   <= pruned_rounds(p, 64, 128, c, 132, crossfade)
                   for c in range(1, 65))
    assert pruned_rounds(p, 64, 128, 22, 132, False) == 8 * 12
    assert bs.mix_chunk(64, 128, 1 << 15, 0, B, True) == 64
    assert bs.mix_chunk(3, 3, 1 << 16, 132, 16384, True) >= 1


# ------------------------------------------------------------------ models


def _bins(p, j, v):
    """`pruned::pruned_bin` of outputs v (any shape) of residue group j:
    → (k, at, mirror_at), at and mirror_at offsets in the block's array."""
    g, Q, P, slot = p.pairs, p.Q, p.P, p.slot_f2
    side_n = g * (Q // 2)
    side = (v >= side_n).astype(int)
    w = v - side * side_n
    m, i = w // g, w % g
    pi = np.where(side == 1, g - 1 - i, i)
    pp = j * g + pi
    u = side * g + pi
    r = np.where(side == 1, np.where(pp > 0, P - pp, P // 2), pp)
    k = r + P * m
    at = u * slot + m
    mirror = np.where(pp > 0, ((1 - side) * g + pi) * slot + (Q - 1 - m),
                      u * slot + np.where(side == 1, Q - 1 - m,
                                          (Q - m) & (Q - 1)))
    return k, at, mirror


def _forward(p, x, x2, residues, offs, size, crossfade):
    """The transforms of residues (one a slot, slot i's buffer at
    offs[i] of one array of ``size``) of the block x (B samples), and
    without crossfade of x2 packed beside it (None: zeros): the
    pre-twiddled first-pass input, the Q-point passes, the exchange to
    natural order → the array (bin m of slot i at offs[i] + m)."""
    Q, n, B_ = p.Q, p.n, x.shape[-1]
    T = p.transform_threads
    twn, twq = twiddles(n, CPU).numpy(), twiddles(Q, CPU).numpy()
    lane, m = np.arange(T)[:, None], np.arange(16)[None, :]
    t = lane + m * T
    z = _first_pass(x, B_, Q, crossfade)
    if x2 is not None and not crossfade:  # conj(x + i·x2)
        z = (z - 1j * _first_pass(x2, B_, Q, False)).astype(np.complex64)
    # ω_n^(r·t) as tw_n[r·lane]·tw_n[r·m·T], multiplied in that order
    v = np.stack([np.where(t < B_, z * twn[r * lane] * twn[r * m * T],
                           0).astype(np.complex64) for r in residues])
    v = _group_passes(_dft(v, 16), p.radices, Q, twq, size, offs)
    pos = np.asarray(offs)[:, None, None] + _last_positions(p.radices, Q)
    return _exchange(size, pos, np.conj(v))


def _group_bins(p, x, x2, crossfade):
    """Every residue group of one row (or of two packed blocks) in one
    array, group j's slot u at j·shared + u·slot (Q < 16384): → [(k, Z,
    Zm)], Z[k] and Z[n − k] of each output, k (groups, threads, 8), then
    the n/2 bin of group 0's first thread (its own mirror)."""
    residues = [r for j in range(p.groups) for r in p.block_residues(j)]
    offs = [j * p.shared_f2 + u * p.slot_f2 for j in range(p.groups)
            for u in range(p.residues)]
    X = _forward(p, x, x2, residues, offs, p.groups * p.shared_f2,
                 crossfade)
    j = np.arange(p.groups)[:, None, None]
    v = np.arange(p.threads)[None, :, None] + np.arange(8) * p.threads
    k, at, mirror = _bins(p, j, v)
    base = j * p.shared_f2
    Zn = _read(X, np.array([p.Q // 2]))
    return [(k, _read(X, base + at), lambda: _read(X, base + mirror)),
            (np.array([p.n // 2]), Zn, lambda: Zn)]


def _half_block(p, x, x2, r, crossfade, unpack):
    """The Q = 16384 body's block for residue r: where it unpacks and r is
    not its own mirror, its mirror's transform first, the upper half kept
    beside the buffer; then r's; → (k, Z, Zm) of its bins m = lane + i·T
    (i < 8) and, for r = 0, n/2."""
    Q, P, T = p.Q, p.P, p.transform_threads
    kept = np.full(Q // 2, NAN)
    if unpack and r != 0 and 2 * r != P:
        X1 = _forward(p, x, x2, [P - r], [0], p.slot_f2, crossfade)
        kept = _read(X1, Q // 2 + np.arange(Q // 2))
    X = np.concatenate([_forward(p, x, x2, [r], [0], p.slot_f2, crossfade),
                        kept])
    m = np.arange(T)[:, None] + np.arange(8)[None, :] * T
    if r == 0:
        m = np.concatenate([m.ravel(), [Q // 2]])
    mirror = ((Q - m) & (Q - 1) if r == 0 else Q - 1 - m if 2 * r == P
              else p.slot_f2 + Q // 2 - 1 - m)
    return r + P * m, _read(X, m), lambda: _read(X, mirror)


def _bins_of(p, x, x2, crossfade, unpack):
    """(k, Z, Zm()) of every CUDA block of one row (or packed pair)."""
    if p.half:
        return [_half_block(p, x, x2, r, crossfade, unpack)
                for r in range(p.P)]
    return _group_bins(p, x, x2, crossfade)


def _mac(X, H, k):
    """Both ears' X·H at bins k → (2, ...) complex64."""
    return (X * H[:, k]).astype(np.complex64)


def _model_spectra(xbs, H, n, crossfade, dir_rate):
    """`block_spectra`' pruned body: xbs (S, nb, B) f32, H (S, ⌈nb/k⌉, 2,
    F) complex64 → Y (S, nb, 2, F) complex64, every bin written once; a
    CUDA block a row, its bins unpacked under crossfade, else Z·H."""
    S, nb, B_ = xbs.shape
    p = pruned_plan(n, False, B_)
    F, rows = n // 2 + 1, S * nb
    Y = np.full((rows, 2, F), NAN)
    writes = np.zeros((rows, F), int)
    for row in range(rows):
        s, b = divmod(row, nb)
        hc, hp = _filter_rows(b, dir_rate)
        Hc, Hp = H[s, hc], H[s, hp]
        for k, Z, Zm in _bins_of(p, xbs[s, b], None, crossfade, crossfade):
            if crossfade:
                A, Bv = _unpack(Z, Zm())
                y = _mac(A, Hc, k) + _mac(Bv, Hp, k)
            else:
                y = _mac(Z, Hc, k)
            Y[row][:, k.ravel()] = y.reshape(2, -1)
            np.add.at(writes[row], k.ravel(), 1)
    assert (writes == 1).all()
    return Y.reshape(S, nb, 2, F)


def _model_mix(xbs, H, n, crossfade, dir_rate, chunk):
    """`block_spectra_mix`' pruned body: per (chunk c, block b) and
    residue group, the chunk's sources in order (two a transform set
    without crossfade, the second's filter in place of the predecessor's),
    each thread's bins summed in complex64, then written once → P
    (⌈S/chunk⌉, nb, 2, F) complex64."""
    S, nb, B_ = xbs.shape
    p = pruned_plan(n, True, B_)
    F, C = n // 2 + 1, -(-S // chunk)
    P = np.full((C * nb, 2, F), NAN)
    writes = np.zeros((C * nb, F), int)
    for blk in range(C * nb):
        c, b = divmod(blk, nb)
        hc, hp = _filter_rows(b, dir_rate)
        s_end = min(S, c * chunk + chunk)
        acc = None
        for s in range(c * chunk, s_end, 1 if crossfade else 2):
            two = not crossfade and s + 1 < s_end
            Hc = H[s, hc]
            Hp = (H[s, hp] if crossfade else H[s + 1, hc] if two else Hc)
            outs = []
            for k, Z, Zm in _bins_of(p, xbs[s, b],
                                     xbs[s + 1, b] if two else None,
                                     crossfade, True):
                A, Bv = _unpack(Z, Zm())
                outs.append((k, _mac(A, Hc, k) + _mac(Bv, Hp, k)))
            if acc is None:
                acc = [(k, np.zeros_like(y)) for k, y in outs]
            acc = [(k, (a + y).astype(np.complex64))
                   for (k, a), (_, y) in zip(acc, outs)]
        for k, a in acc:
            P[blk][:, k.ravel()] = a.reshape(2, -1)
            np.add.at(writes[blk], k.ravel(), 1)
    assert (writes == 1).all()
    return P.reshape(C, nb, 2, F)


# (n, B): Q 1024 at n 32768, 65536 and 262144 (P 32, 64, 256); Q 128 (64
# pairs a block); Q 4096 (one pair, the mix's sums in shared memory); Q
# 16384 at P 2 (both residues their own mirrors) and P 4 (the mirror's
# transform first)
MODEL_SHAPES = [(1 << 15, 1024), (1 << 16, 1024), (1 << 18, 1024),
                (1 << 15, 64), (1 << 15, 3000), (1 << 15, 16384),
                (1 << 16, 16384)]


@pytest.mark.parametrize("crossfade", [True, False])
@pytest.mark.parametrize("n,B_", MODEL_SHAPES)
def test_spectra_model_matches_reference(n, B_, crossfade):
    """The model against the float64 `block_spectra_reference`: 2 sources
    × 3 blocks at dir_rate 1, and 1 × 5 at dir_rate 4 (nb no multiple of
    k: the crossfade across the group boundary at block 4): ≥ 100 dB."""
    for S, nb, k in ((2, 3, 1), (1, 5, 4)):
        if n >= 1 << 18 and k == 4:
            S, nb = 1, 5
        xbs, H = _inputs(S, nb, B_, n, k, seed=n % 997 + B_ + k + crossfade)
        got = _model_spectra(xbs, H, n, crossfade, k)
        ref = bs.block_spectra_reference(_f64(xbs), _f64(H), n,
                                         crossfade=crossfade,
                                         dir_rate=k).numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert _snr_db(ref, got) >= 100, (n, B_, k, _snr_db(ref, got))


@pytest.mark.parametrize("crossfade", [True, False])
@pytest.mark.parametrize("n,B_", MODEL_SHAPES)
def test_mix_model_matches_reference(n, B_, crossfade):
    """The model against the float64 `block_spectra_mix_reference`: 3
    sources in chunks of 2 (S no multiple of the chunk) over 2 blocks at
    dir_rate 1, and over 5 blocks at dir_rate 4 (nb no multiple of k):
    ≥ 100 dB."""
    for nb, k in ((2, 1), (5, 4)):
        xbs, H = _inputs(3, nb, B_, n, k, seed=n % 991 + B_ + k + crossfade)
        got = _model_mix(xbs, H, n, crossfade, k, chunk=2)
        ref = bs.block_spectra_mix_reference(
            _f64(xbs), _f64(H), n, crossfade=crossfade, chunk=2,
            dir_rate=k).numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert _snr_db(ref, got) >= 100, (n, B_, k, _snr_db(ref, got))


# ------------------------------------------------------------------- JAX


@pytest.fixture(scope="module")
def long_table():
    """The 16,384-tap synthetic set, as arrays and on the port's CPU."""
    arrays = tinaural.load_hrir_set("synthetic", taps=16384)
    table = TorchTable.from_hrir_table(arrays, "cpu")
    assert _n_fft(table, B) == 1 << 15
    return arrays, table


def _jax(arrays):
    return JaxRenderer(arrays, tinaural.RenderConfig(
        use_pallas=False, block_size=B, filter_path="fft"))


def test_static_render_and_scene_at_32768_match_jax(long_table):
    """A static `render` of 9 blocks and a static `render_scene` of 3
    sources × 3 blocks at 16,384 taps and block 1024 (n_fft 32768: the
    pruned mode of `block_spectra` and `block_spectra_mix` on a card),
    on the port's CPU route (B3's and B4's plain versions), against
    `tinaural`'s jnp route on the same numpy inputs: ≥ 100 dB."""
    arrays, table = long_table
    rng = np.random.default_rng(19)
    cfg = tinaural_torch.RenderConfig(block_size=B)
    x = rng.standard_normal(9 * B - 100).astype(np.float32)
    y = tinaural_torch.BinauralRenderer(table, cfg).render(x, 123.4,
                                                           5.6).numpy()
    yj = np.asarray(_jax(arrays).render(x, 123.4, 5.6))
    assert y.shape == yj.shape and np.isfinite(y).all()
    assert snr_db(yj, y) >= 100
    xs = rng.standard_normal((3, 3 * B - 50)).astype(np.float32)
    dirs = np.stack([rng.uniform(0, 360, 3), rng.uniform(-40, 90, 3)],
                    -1).astype(np.float32)
    y = tinaural_torch.render_scene(table, xs, dirs, cfg,
                                    dedupe=False).numpy()
    yj = np.asarray(_jax(arrays).render_scene(xs, dirs, dedupe=False))
    assert y.shape == yj.shape and np.isfinite(y).all()
    assert snr_db(yj, y) >= 100


def test_moving_scene_through_the_mix_model_matches_jax(long_table):
    """A moving scene of 3 sources × 3 blocks at 16,384 taps and block
    1024 through the renderer's scene core with `block_spectra_mix`'
    pruned model in the route (filters from the plain `assemble_filters`,
    chunks of 2, the partials summed in order, irfft, overlap-add), the
    route a card takes for a scene of fewer blocks than SMs, against
    `tinaural`'s jnp `render_scene`: ≥ 100 dB."""
    arrays, table = long_table
    rng = np.random.default_rng(23)
    S, nb = 3, 3
    N = nb * B - 300
    xs = rng.standard_normal((S, N)).astype(np.float32)
    dirs = np.stack([rng.uniform(0, 360, (S, nb)),
                     rng.uniform(-40, 90, (S, nb))], -1).astype(np.float32)
    cfg = tinaural_torch.RenderConfig(block_size=B)
    r = tinaural_torch.BinauralRenderer(table, cfg)
    called = []

    def route(xbs, idx, w, table, n_fft, *, crossfade, apply_itd, apply_ild,
              dir_rate):
        called.append((n_fft, crossfade))
        H = br.assemble_filters_reference(idx, w, table, n_fft,
                                          apply_itd=apply_itd,
                                          apply_ild=apply_ild).numpy()
        P = _model_mix(xbs.numpy(), H, n_fft, crossfade, dir_rate, chunk=2)
        total = P[0]
        for part in P[1:]:
            total = (total + part).astype(np.complex64)
        frames = bs.spectra_inverse_reference(torch.from_numpy(total), n_fft)
        return overlap_add(frames.transpose(0, 1), xbs.shape[-1])

    xbs, N_ = r._blockify(xs)
    y = _scene_core(table, xbs, r._dirs(dirs), cfg, render=route)
    y = y[:, : r._out_len(N_)].numpy()
    assert called == [(1 << 15, True)]
    yj = np.asarray(_jax(arrays).render_scene(xs, dirs, dedupe=False))
    assert y.shape == yj.shape and np.isfinite(y).all()
    assert snr_db(yj, y) >= 100

"""The launch plans of the partitioned convolution's register kernels, and
a numpy model of the kernels, on the CPU.

`ops/conv_plan.py`'s figures must equal the constants that
``csrc/partitioned.cu`` computes at compile time: the entry points refuse
any other plan. The model follows the kernels index by index, one CUDA
block at a time, in arrays of the block's shared memory:

- `stream_conv`: slot f < ⌈G/2⌉ loads conj(a + i·b) of streams 2f and
  2f + 1 ([prev_in | xb] each) into its first pass's registers, runs the
  2B-point passes through its own exchange buffer and stores the spectrum
  conjugated in natural order; the MAC's units (bin k of stream g,
  partitions q ≡ pg mod groups) unpack the new frame from bins k and
  2B − k, shift the delay line and write each group's sums of both ears
  and both filters into its slice of shared memory above the forward
  buffers; slot j < 2G then packs Yn_e + i·Yp_e of stream j/2 and ear
  j mod 2 from those sums (bin k or the mirror of 2B − k), runs the
  inverse and blends the last B samples in registers.
- `frame_spectra`: slot j of block b transforms frames c and c + 1
  (c = f0 + 2(b·G + j), f0 even) as one complex frame and writes both
  spectra's bins lane + m·T and, on lane 0, B.
- `partitioned_conv`: the MAC of X[b − q] under block b's row and its
  predecessor's, then the two ears' inverses as in `stream_conv`.

Every exchange writes each position once and reads only what was written
(``test_torch_mac_plan._exchange``, ``_read``), the forward buffers and the
MAC's sums do not overlap, every output is written once, and the forward
transforms a chunk of the offline render takes are counted. Held against
the float64 `stream_conv_reference`, `frame_spectra_reference` and
`partitioned_conv_reference`, the model pins the index maps before a card
runs them; ``tests/test_torch_cuda.py`` holds the kernels themselves to
the same references on the card.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_block_render_plan import _group_passes
from test_torch_inverse_plan import _dft
from test_torch_mac_plan import (CPU, H100_SHARED_BYTES, _compiled_plan,
                                 _exchange, _last_positions, _read, _snr_db,
                                 _unpack)
from tinaural_torch.ops import _layout
from tinaural_torch.ops._layout import REGISTER
from tinaural_torch.ops import partitioned_conv as pc
from tinaural_torch.ops.conv_plan import (MAX_CONV_BLOCK, MIN_CONV_BLOCK,
                                          chunk_frames, conv_launch,
                                          conv_plan, forward_transforms,
                                          frames_launch, pair_start,
                                          stream_forward_transforms,
                                          stream_launch)
from tinaural_torch.ops.spectra_inverse import twiddles

torch.set_num_threads(1)

H100_SMS = 132
PARTS = (1, 2, 3, 5, 9, 33, 87)


# ------------------------------------------------------------------- plans


def _compiled_max_streams(log2n: int) -> int:
    """conv_max_streams of the CUDA source."""
    return min(16, 512 >> (log2n - 3))


def _compiled_threads(log2n: int, G: int, P: int) -> int:
    """conv_threads of the CUDA source."""
    inv = G << (log2n - 3)
    wide = min(G << log2n, 512) if P > 1 else 0
    return max(inv, wide, 256)


def _compiled_groups(log2n: int, G: int, threads: int, P: int) -> int:
    """conv_part_groups of the CUDA source."""
    return min(max(threads // (G << (log2n - 1)), 1), P)


def _compiled_shared_f2(log2n: int, G: int, groups: int,
                        forward: bool) -> int:
    """conv_shared_f2 of the CUDA source."""
    row = (1 << log2n) + (1 << (log2n - 4))
    fwd = (G + 1) // 2 * row if forward else 0
    return max(fwd + groups * G * 4 * ((1 << (log2n - 1)) + 1), 2 * G * row)


def _compiled_part_threads_ok(log2n: int, threads: int) -> bool:
    """part_threads_ok of the CUDA source."""
    lo = max(1 << (log2n - 3), 64)
    return lo <= threads <= 512 and threads & (threads - 1) == 0


def _fits(f2: int) -> bool:
    return f2 * 8 + _layout._STATIC_SMEM <= H100_SHARED_BYTES


@pytest.mark.parametrize("log2B", range(1, 14))
def test_conv_plans(log2B):
    """Every block 2 … 8192 at P of 1 … 87: the register body at blocks
    64 … 2048 with the compiled constants (radices, most streams, threads,
    partition groups and shared figure at every G; partitioned_conv's
    threads at several block counts; frame_spectra's figures), within
    512 threads and the H100's shared memory; the radix-2 body's figures
    at the other blocks."""
    B = 1 << log2B
    log2n = log2B + 1
    for P in PARTS:
        plan = conv_plan(B, P)
        assert (plan.body == REGISTER) == (MIN_CONV_BLOCK <= B
                                           <= MAX_CONV_BLOCK)
        if plan.body != REGISTER:
            assert stream_launch(B, P, 100, H100_SMS) == (0, 256, 7 * B)
            assert conv_launch(B, P, 100, H100_SMS) == (0, 9 * B + 4)
            with pytest.raises(ValueError):
                frames_launch(B, 10, H100_SMS)
            continue
        T = 2 * B // 16
        assert plan.radices == _compiled_plan(2 * B)[0]
        assert math.prod(plan.radices) == 2 * B
        assert plan.max_streams == _compiled_max_streams(log2n)
        G = 1
        while G <= plan.max_streams:
            t = plan.threads(G)
            assert t == _compiled_threads(log2n, G, P)
            assert 2 * G * T <= t <= 512 and t % T == 0
            groups = plan.part_groups(G, t)
            assert groups == _compiled_groups(log2n, G, t, P)
            f2 = plan.shared_f2(G, t, True)
            assert f2 == _compiled_shared_f2(log2n, G, groups, True)
            assert _fits(f2)
            G *= 2
        for nb, sms in ((1, H100_SMS), (40, H100_SMS), (256, H100_SMS),
                        (2048, H100_SMS), (10 ** 5, H100_SMS), (40, 0)):
            t, f2 = conv_launch(B, P, nb, sms)
            assert _compiled_part_threads_ok(log2n, t)
            groups = plan.part_groups(1, t)
            assert f2 == _compiled_shared_f2(log2n, 1, groups, False)
            assert _fits(f2)
        assert plan.frame_max_groups == max(1, 256 >> (log2n - 4))
        Gf, t, f2 = frames_launch(B, 1000, 0)
        assert (Gf, t, f2) == (plan.frame_max_groups, Gf * T,
                               Gf * plan.row_f2)
        assert t <= 256 and _fits(f2)


def test_launches_fill_the_card():
    """stream_conv's G fills the card as assemble_partitions' rows do:
    render (d)'s 1024 streams take G = 4 (256 blocks), (e)'s 64 and (f)'s
    one G = 1, 301 streams G = 2 with one stream in the last block;
    partitioned_conv's threads: (g)'s 2048 blocks 128, (j)'s 256 blocks
    512; frame_spectra: (g)'s 1024 transforms 4 per block, (j)'s 128 one."""
    assert stream_launch(256, 1, 1024, H100_SMS)[:2] == (4, 256)
    assert stream_launch(256, 9, 64, H100_SMS)[:2] == (1, 512)
    assert stream_launch(256, 1, 1, H100_SMS)[:2] == (1, 256)
    assert stream_launch(256, 1, 301, H100_SMS)[0] == 2
    assert stream_launch(256, 1, 301, 0)[0] == 8  # no card: the most
    assert conv_launch(512, 5, 2048, H100_SMS)[0] == 128
    assert conv_launch(512, 87, 256, H100_SMS)[0] == 512
    assert conv_launch(512, 87, 256, 0)[0] == 128
    assert frames_launch(512, 1024, H100_SMS)[:2] == (4, 256)
    assert frames_launch(512, 128, H100_SMS)[:2] == (1, 64)
    assert stream_forward_transforms(256, 1, 1024, H100_SMS) == 512
    assert stream_forward_transforms(256, 1, 301, H100_SMS) == 151
    assert stream_forward_transforms(256, 9, 64, H100_SMS) == 64
    assert stream_forward_transforms(32, 1, 7, H100_SMS) == 7


def test_plans_reject_bad_sizes():
    for B, P in ((0, 1), (3, 1), (48, 1), (64, 0)):
        with pytest.raises(ValueError):
            conv_plan(B, P)


# ------------------------------------------------------------------ models


def _first_pass(z: np.ndarray, T: int) -> np.ndarray:
    """The first pass of a transform whose thread ``lane`` loads inputs
    lane + m·T (m < 16) of z (..., 16·T): (..., T, 16) after dft<16>."""
    return _dft(z.reshape(*z.shape[:-1], 16, T).swapaxes(-1, -2), 16)


def _forward(z: np.ndarray, plan, size: int, offs) -> np.ndarray:
    """The forward transforms of the frames z (slots, 2B) complex64 as the
    kernels run them, slot i through its buffer at offs[i] of one shared
    array of ``size``: conj of the register inverse of conj(z), stored in
    natural order → that buffer."""
    n, T = plan.n, plan.transform_threads
    tw = twiddles(n, CPU).numpy()
    offs = np.asarray(offs)
    v = _first_pass(np.conj(z).astype(np.complex64), T)
    v = _group_passes(v, plan.radices, n, tw, size, offs)
    return _exchange(size, offs[:, None, None] + _last_positions(
        plan.radices, n), np.conj(v))


def _inverse_blend(acc: np.ndarray, acc_off: int, G: int, groups: int,
                   slots, plan, size: int, crossfade: bool) -> np.ndarray:
    """conv_inverse for each (slot j, stream g, ear e) of ``slots``: Yn_e +
    i·Yp_e summed over the groups from acc (plane p of stream g and group
    pg at acc_off + ((pg·G + g)·4 + p)·(B+1)), packed with the mirror,
    the register inverse through the slot's buffer (which may overlay
    acc), the last B samples blended → (slots, B) f32."""
    n, B, T = plan.n, plan.block, plan.transform_threads
    F2 = B + 1
    tw = twiddles(n, CPU).numpy()
    f32 = np.float32
    p = np.arange(T)[:, None] + np.arange(16)[None, :] * T
    k = np.where(p <= B, p, n - p)
    z = []
    for j, g, e in slots:
        A = np.zeros(p.shape, np.complex64)
        Bv = np.zeros(p.shape, np.complex64)
        for pg in range(groups):  # in order of the groups
            base = acc_off + (pg * G + g) * 4 * F2
            A += _read(acc, base + e * F2 + k)
            if crossfade:
                Bv += _read(acc, base + (2 + e) * F2 + k)
        edge = (k == 0) | (k == B)
        A = np.where(edge, A.real, A).astype(np.complex64)
        Bv = np.where(edge, Bv.real, Bv).astype(np.complex64)
        z.append(np.where(p <= B, (A.real - Bv.imag) + 1j * (A.imag + Bv.real),
                          (A.real + Bv.imag) + 1j * (Bv.real - A.imag)))
    v = _dft(np.stack(z).astype(np.complex64), 16)
    offs = np.array([j for j, _, _ in slots]) * plan.row_f2
    assert offs.max() + plan.row_f2 <= size
    v = _group_passes(v, plan.radices, n, tw, size, offs)
    pos = _last_positions(plan.radices, n)
    assert (np.sort(pos.ravel()) == np.arange(n)).all()
    last = pos >= B
    i = pos[last] - B
    u = ((i + f32(0.5)) * f32(1 / B)).astype(f32)
    out = np.full((len(slots), B), np.nan, f32)
    for s, vs in enumerate(v):
        zz = vs[last]
        y = u * zz.real + (f32(1) - u) * zz.imag if crossfade else zz.real
        out[s, i] = y * f32(1 / n)
    return out


def _model_stream(xb, prev_in, fdl_re, fdl_im, H, Hp, started, crossfade,
                  sms):
    """`stream_conv`'s register body by its index maps. xb, prev_in (S,
    B) f32; fdl_* (S, P, B+1) f32; H, Hp (S, P, 2, B+1) complex64; started
    (S,) → (y (S, 2, B), prev_out, fdl_re', fdl_im', forward transforms)."""
    S, B = xb.shape
    P = H.shape[1]
    F2, n = B + 1, 2 * B
    plan = conv_plan(B, P)
    G, threads, size = stream_launch(B, P, S, sms)
    groups = plan.part_groups(G, threads)
    pairs = (G + 1) // 2
    y = np.full((S, 2, B), np.nan, np.float32)
    prev_out = np.full((S, B), np.nan, np.float32)
    fr = np.full(fdl_re.shape, np.nan, np.float32)
    fi = np.full(fdl_im.shape, np.nan, np.float32)
    writes = np.zeros(fdl_re.shape, int)
    count = 0
    for s0 in range(0, S, G):
        live = [s for s in range(s0, s0 + G) if s < S]
        # forward: slot f packs streams s0 + 2f and s0 + 2f + 1
        z, slots = [], []
        for f in range(pairs):
            sa = s0 + 2 * f
            if sa >= S:
                continue
            two = 2 * f + 1 < G and sa + 1 < S
            fa = np.concatenate([prev_in[sa], xb[sa]])
            fb = (np.concatenate([prev_in[sa + 1], xb[sa + 1]]) if two
                  else np.zeros(n, np.float32))
            prev_out[sa] = xb[sa]
            if two:
                prev_out[sa + 1] = xb[sa + 1]
            z.append(fa + 1j * fb)
            slots.append(f)
        count += len(slots)
        fwd = _forward(np.stack(z), plan, size,
                       np.array(slots) * plan.row_f2)
        # the MAC, each unit's sums into the slices above the forward
        # buffers
        pos, vals = [], []
        for pg in range(groups):
            for g, s in enumerate(live):
                k = np.arange(F2)
                zf = (g // 2) * plan.row_f2
                Xa, Xb = _unpack(_read(fwd, zf + k),
                                 _read(fwd, zf + ((n - k) & (n - 1))))
                X0 = Xb if g % 2 else Xa
                Hq = H[s]
                Pq = Hp[s] if crossfade and started[s] > 0.5 else H[s]
                acc = np.zeros((4, F2), np.complex64)
                for q in range(pg, P, groups):
                    X = X0 if q == 0 else (fdl_re[s, q - 1]
                                           + 1j * fdl_im[s, q - 1]).astype(
                                               np.complex64)
                    fr[s, q], fi[s, q] = X.real, X.imag
                    writes[s, q] += 1
                    acc[0] += X * Hq[q, 0]
                    acc[1] += X * Hq[q, 1]
                    if crossfade:
                        acc[2] += X * Pq[q, 0]
                        acc[3] += X * Pq[q, 1]
                planes = 4 if crossfade else 2
                base = pairs * plan.row_f2 + (pg * G + g) * 4 * F2
                pos.append(base + np.arange(planes)[:, None] * F2 + k)
                vals.append(acc[:planes])
        pos = np.concatenate([p.ravel() for p in pos])
        assert pos.min() >= pairs * plan.row_f2  # above the forward buffers
        acc = _exchange(size, pos, np.concatenate([v.ravel() for v in vals]))
        slots = [(j, j // 2, j % 2) for j in range(2 * G)
                 if s0 + j // 2 < S]
        out = _inverse_blend(acc, pairs * plan.row_f2, G, groups, slots,
                             plan, size, crossfade)
        for (j, g, e), row in zip(slots, out):
            y[s0 + g, e] = row
    assert (writes == 1).all()  # every delay-line slot written once
    return y, prev_out, fr, fi, count


def _model_frames(x: np.ndarray, f0: int, stop: int, sms: int):
    """`frame_spectra` by its index maps: frames f0 … stop − 1 of x (nb,
    B) → (X (frames, B+1) complex64, forward transforms)."""
    nb, B = x.shape
    n, F2 = 2 * B, B + 1
    plan = conv_plan(B, 1)
    T = plan.transform_threads
    frames = stop - f0
    transforms = -(-frames // 2)
    G, _, size = frames_launch(B, transforms, sms)
    xp = np.concatenate([np.zeros((1, B), np.float32), x])  # x[−1] = 0
    X = np.full((frames, F2), np.nan + 0j, np.complex64)
    writes = np.zeros(X.shape, int)
    count = 0
    for b in range(-(-transforms // G)):
        slots = [j for j in range(G) if 2 * (b * G + j) < frames]
        cs = [f0 + 2 * (b * G + j) for j in slots]
        # frame c + 1 wherever it lies in x, so bits do not depend on stop
        z = [np.concatenate([xp[c], xp[c + 1]])
             + 1j * (np.concatenate([xp[c + 1], xp[c + 2]]) if c + 1 < nb
                     else 0) for c in cs]
        count += len(slots)
        buf = _forward(np.stack(z), plan, size, np.array(slots) * plan.row_f2)
        lane = np.arange(T)
        kb = np.concatenate([(lane[:, None] + np.arange(8) * T).ravel(), [B]])
        for j, c in zip(slots, cs):
            off = j * plan.row_f2
            A, Bk = _unpack(_read(buf, off + kb),
                            _read(buf, off + ((n - kb) & (n - 1))))
            X[c - f0, kb] = A
            writes[c - f0, kb] += 1
            if c + 1 < stop:
                X[c + 1 - f0, kb] = Bk
                writes[c + 1 - f0, kb] += 1
    assert (writes == 1).all()  # every bin of the range written once
    return X, count


def _model_conv(x, X, f0, H, start, stop, dir_rate, crossfade, sms):
    """`partitioned_conv`'s register body by its index maps: blocks start
    … stop − 1 of x (nb, B) with frame spectra X of frames f0 …, H (rows,
    P, 2, B+1) complex64 → y (2, nb·B), the other blocks NaN."""
    nb, B = x.shape
    P = H.shape[1]
    F2 = B + 1
    plan = conv_plan(B, P)
    threads, size = conv_launch(B, P, stop - start, sms)
    groups = plan.part_groups(1, threads)
    row, prow = (r.numpy() for r in pc.conv_rows(start, stop, dir_rate))
    y = np.full((2, nb * B), np.nan, np.float32)
    for i, b in enumerate(range(start, stop)):
        pos, vals = [], []
        k = np.arange(F2)
        for pg in range(groups):
            acc = np.zeros((4, F2), np.complex64)
            for q in range(pg, min(P, b + 1), groups):
                Xq = _read(X.ravel(), (b - q - f0) * F2 + k)
                acc[0] += Xq * H[row[i], q, 0]
                acc[1] += Xq * H[row[i], q, 1]
                if crossfade:
                    acc[2] += Xq * H[prow[i], q, 0]
                    acc[3] += Xq * H[prow[i], q, 1]
            planes = 4 if crossfade else 2
            pos.append(pg * 4 * F2 + np.arange(planes)[:, None] * F2 + k)
            vals.append(acc[:planes])
        acc = _exchange(size, np.concatenate([p.ravel() for p in pos]),
                        np.concatenate([v.ravel() for v in vals]))
        out = _inverse_blend(acc, 0, 1, groups, [(0, 0, 0), (1, 0, 1)],
                             plan, size, crossfade)
        y[:, b * B:(b + 1) * B] = out
    return y


# (S, B, P, crossfade, sms): S = 1 and odd, S not a multiple of G (sms 0
# gives the most streams per block), P 1 … 87, B at both edges of the
# register range
STREAM_CASES = [(1, 64, 1, True, H100_SMS), (3, 64, 5, True, H100_SMS),
                (5, 64, 9, True, 0), (9, 128, 3, False, 0),
                (3, 256, 87, True, H100_SMS), (2, 2048, 2, True, 0),
                (3, 2048, 1, False, H100_SMS)]


@pytest.mark.parametrize("S,B,P,crossfade,sms", STREAM_CASES)
def test_stream_model_matches_reference(S, B, P, crossfade, sms):
    """The model of `stream_conv` against the float64
    `stream_conv_reference`, streams started and not: ≥ 120 dB for y and
    the delay line, prev_in' the block, ⌈G/2⌉ forward transforms a block."""
    rng = np.random.default_rng(S * 100 + B + P)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    xb, prev_in = f32(S, B), f32(S, B)
    fdl_re, fdl_im = f32(S, P, B + 1), f32(S, P, B + 1)
    H = (f32(S, P, 2, B + 1) + 1j * f32(S, P, 2, B + 1)).astype(np.complex64)
    Hp = (f32(S, P, 2, B + 1) + 1j * f32(S, P, 2, B + 1)).astype(np.complex64)
    started = (np.arange(S) % 2 == 0).astype(np.float32)
    y, po, fr, fi, count = _model_stream(xb, prev_in, fdl_re, fdl_im, H, Hp,
                                         started, crossfade, sms)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).double()
    ref = pc.stream_conv_reference(
        t(xb), t(prev_in), t(fdl_re), t(fdl_im), t(H.real), t(H.imag),
        t(Hp.real), t(Hp.imag), t(started), crossfade=crossfade)
    assert np.array_equal(po, xb)
    for got, r in ((y, ref[0]), (fr, ref[2]), (fi, ref[3])):
        assert np.isfinite(got).all()
        assert _snr_db(r.numpy(), got) >= 120, _snr_db(r.numpy(), got)
    assert count == stream_forward_transforms(B, P, S, sms)


# (nb, B, P, dir_rate, start, stop, crossfade): chunks that start past
# block 0 (on a group, odd and even first frames), P 1 … 87, B at both
# edges, dir_rate 1 and 4
CONV_CASES = [(9, 64, 5, 1, 0, 9, True), (12, 64, 3, 4, 4, 12, True),
              (12, 64, 87, 1, 3, 12, True), (10, 128, 1, 1, 3, 7, False),
              (11, 256, 9, 4, 8, 11, True), (6, 2048, 2, 4, 4, 6, True),
              (5, 2048, 1, 1, 0, 5, False)]


@pytest.mark.parametrize("nb,B,P,k,start,stop,crossfade", CONV_CASES)
def test_partitioned_model_matches_reference(nb, B, P, k, start, stop,
                                             crossfade):
    """The models of `frame_spectra` and `partitioned_conv` against the
    float64 plain versions: the chunk's own frames (from the even frame
    at or before max(0, start − P + 1)) and the render's (all nb), ≥ 120
    dB, each forward transform counted: at most ⌈frames/2⌉ for the
    chunk's frames, and frame spectra equal in bits from either range."""
    rng = np.random.default_rng(nb * 100 + B + P + start)
    x = rng.standard_normal((nb, B)).astype(np.float32)
    g0 = start // k - (start > 0)
    rows = -(-stop // k) - g0
    H = (rng.standard_normal((rows, P, 2, B + 1))
         + 1j * rng.standard_normal((rows, P, 2, B + 1))).astype(np.complex64)
    f0, frames = chunk_frames(start, stop, P)
    e0 = pair_start(f0)
    X, count = _model_frames(x, e0, stop, H100_SMS)
    assert count == forward_transforms(stop - e0)
    assert count <= -(-frames // 2) + (f0 % 2)
    Xall, count_all = _model_frames(x, 0, nb, 0)
    assert count_all == -(-nb // 2)
    assert np.array_equal(X, Xall[e0:stop])  # the same bits in any range
    x64 = torch.from_numpy(x).double()
    ref = pc.frame_spectra_reference(x64, e0, stop).numpy()
    assert _snr_db(ref, X) >= 120, _snr_db(ref, X)
    hr = torch.from_numpy(np.ascontiguousarray(H.real)).double()
    hi = torch.from_numpy(np.ascontiguousarray(H.imag)).double()
    ref = pc.partitioned_conv_reference(x64, hr, hi, crossfade=crossfade,
                                        start=start, stop=stop,
                                        dir_rate=k).numpy()
    for XX, ff in ((X, e0), (Xall, 0)):
        y = _model_conv(x, XX, ff, H, start, stop, k, crossfade, H100_SMS)
        sl = np.s_[:, start * B:stop * B]
        assert np.isfinite(y[sl]).all() and np.isnan(
            np.delete(y, np.r_[start * B:stop * B], axis=1)).all()
        assert _snr_db(ref[sl], y[sl]) >= 120, _snr_db(ref[sl], y[sl])


@pytest.mark.parametrize("nb,k,P", [(11, 1, 5), (11, 4, 3), (37, 2, 9)])
def test_render_frames_once(nb, k, P):
    """`partitioned_render`'s CUDA route computes the frame spectra of all
    nb blocks once, ⌈nb/2⌉ transforms, whatever its chunks; each chunk's
    frames (its blocks and the P − 1 before) would take at most
    ⌈frames/2⌉ + 1 from its even first frame, ⌈frames/2⌉ from frame 0."""
    for chunk in (k, 2 * k, 3 * k, nb):
        for b0, b1, _, _ in pc.render_chunks(nb, k, chunk):
            f0, frames = chunk_frames(b0, b1, P)
            assert frames == b1 - b0 + min(P - 1, b0)
            n_fwd = forward_transforms(b1 - pair_start(f0))
            assert n_fwd <= -(-frames // 2) + f0 % 2
            if f0 == 0:
                assert n_fwd == -(-frames // 2)
    assert forward_transforms(nb) == -(-nb // 2)

"""The launch plan of `overlap_add` (``ops/ola_plan.py``) and a numpy
model of the kernel under it, on the CPU.

The plan's figures must equal the constants of ``csrc/block_render.cu``,
whose entry point computes the same plan and launches no other. The model
follows ``overlap_add_kernel`` index by index: grid y walks the 2·S rows
(past 65535 in a loop), thread g = blockIdx.x·threads + lane of a row
makes the V outputs g·V … g·V + V − 1, stopping at the row's last group
(the ragged tail); for each batch of frames (all k at once at k = 2 and 4, else BATCH in
order) it loads every frame q − j that exists at offset (t & (B − 1)) +
j·B of its 32-bit row, then adds them in order into zeros. It must equal
the plain float32 `ola.overlap_add` in bits, write every output once and
read every frame value once (the bytes the bound counts), with every
float4 access 16-byte aligned and every in-row offset below 2^31.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tinaural_torch
from tinaural_torch.ops import ola_plan as op
from tinaural_torch.ops.ola import overlap_add
from tinaural_torch.ops.ola_plan import OlaPlan, check_rows, ola_plan

torch.set_num_threads(1)

SOURCE = Path(tinaural_torch.__file__).parent / "csrc" / "block_render.cu"


def _cuda_constants() -> dict:
    """Every ``constexpr`` kOla… constant of the CUDA source."""
    out = {}
    for name, value in re.findall(
            r"constexpr (?:int|bool|long long) (kOla\w+) = ([^;]+);",
            SOURCE.read_text()):
        value = value.strip()
        out[name] = (value == "true" if value in ("true", "false")
                     else int(value.rstrip("LL"), 0))
    return out


def test_plan_figures_equal_the_cuda_constants():
    c = _cuda_constants()
    assert c == {"kOlaVec": op.VEC, "kOlaThreads": op.THREADS,
                 "kOlaBatch": op.BATCH, "kOlaAlign": op.ALIGN_BYTES,
                 "kOlaMaxIndex": op.MAX_INDEX}
    # one float4, a block a whole number of warps
    assert op.VEC == 4 and op.THREADS % 32 == 0
    # the entry point's rule, as the CUDA source states it
    assert "vec = B < 4 || !aligned ? 1 : kOlaVec" in SOURCE.read_text()


def _model(flat: np.ndarray, offset: int, S: int, nb: int, B: int,
           n_fft: int, plan: OlaPlan):
    """overlap_add_kernel under ``plan`` on frames flat[offset:], flat's
    element 0 16-byte aligned → (out (S, 2, out_len), reads per element of
    flat, writes per output)."""
    V, k, T = plan.vec, n_fft // B, op.THREADS
    gx, gy = plan.grid
    log2b, mask = B.bit_length() - 1, B - 1
    out_len = (nb - 1) * B + n_fft
    groups = out_len // V
    rows = 2 * S
    batch = k if k in (2, 4) else op.BATCH
    # grid y: block y takes rows y, y + gy, …; every row once
    order = np.concatenate([np.arange(y, rows, gy) for y in range(gy)])
    assert np.array_equal(np.sort(order), np.arange(rows))
    row = order[:, None]
    base = offset + ((row >> 1) * nb * 2 + (row & 1)) * n_fft  # 64-bit
    out = np.full(rows * out_len, np.nan, np.float32)
    reads = np.zeros(flat.size, np.int64)
    writes = np.zeros(rows * out_len, np.int64)
    lanes = np.arange(V)
    g = np.broadcast_to(np.arange(gx * T), (rows, gx * T))
    live = g < groups  # the ragged tail returns
    t = (g * V)[live]
    assert t.max(initial=0) <= op.MAX_INDEX
    b, q, r = np.broadcast_to(base, g.shape)[live], t >> log2b, t & mask
    rw = np.broadcast_to(row, g.shape)[live]
    acc = np.zeros((t.size, V), np.float32)
    for j0 in range(0, k, batch):
        loaded = []
        for j in range(batch):  # every load of the batch first
            bb = q - j0 - j
            ok = (j0 + j < k) & (bb >= 0) & (bb < nb)
            off = bb[ok] * 2 * n_fft + r[ok] + ((j0 + j) << log2b)
            assert off.max(initial=0) + V - 1 <= op.MAX_INDEX
            addr = b[ok] + off
            if V > 1:
                assert not np.any(addr * 4 % op.ALIGN_BYTES)
            addr = addr[:, None] + lanes
            reads += np.bincount(addr.ravel(), minlength=flat.size)
            loaded.append((ok, flat[addr]))
        for ok, x in loaded:  # then the adds, frame q first
            acc[ok] = acc[ok] + x
    o = (rw * out_len + t)[:, None] + lanes
    out[o] = acc
    writes += np.bincount(o.ravel(), minlength=writes.size)
    return out.reshape(S, 2, out_len), reads, writes


# (S, nb, B, k) of the model's cases: B 1 … 16384, k 2, 4 and 32, S 1, 3
# and 64, nb 1, 2, 7 and 128
CASES = ((3, 7, 1, 2), (1, 2, 1, 32), (3, 7, 2, 4), (64, 1, 2, 2),
         (1, 7, 4, 2), (3, 128, 4, 4), (64, 7, 64, 2), (3, 7, 64, 32),
         (1, 128, 64, 4), (1, 128, 1024, 2), (3, 7, 1024, 4),
         (1, 2, 1024, 32), (64, 2, 1024, 2), (1, 128, 2048, 2),
         (3, 7, 2048, 4), (1, 1, 2048, 2), (1, 2, 16384, 2), (1, 7, 16384, 4),
         (3, 1, 16384, 2), (1, 2, 16384, 32))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("S,nb,B,k", CASES)
def test_model_equals_plain_overlap_add_in_bits(S, nb, B, k, offset):
    """The model under the H100's plan equals `ola.overlap_add` in bits,
    writes every output once and reads every frame value once; frames one
    float past alignment (offset 1) take the scalar body."""
    n_fft = k * B
    rng = np.random.default_rng(S * 7 + nb * 11 + B + k + offset)
    flat = rng.standard_normal(offset + S * nb * 2 * n_fft).astype(np.float32)
    plan = ola_plan(S, nb, B, n_fft, offset == 0)
    assert (plan.vec == 1) == (offset == 1 or B < 4)
    got, reads, writes = _model(flat, offset, S, nb, B, n_fft, plan)
    frames = torch.from_numpy(flat[offset:].reshape(S, nb, 2, n_fft))
    ref = overlap_add(frames.transpose(1, 2), B).numpy()
    assert got.shape == ref.shape
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert np.all(writes == 1)
    assert np.all(reads[offset:] == 1) and not reads[:offset].any()


def test_plans_at_the_renders_shapes():
    """The H100's plans at chip_smoke's shapes: V outputs a thread at (a),
    (i), (h), (k), (l), the scene mixdown's 128 summed frames and (j)'s
    128 frames at n_fft 32768; the scalar body off alignment; the grid
    covering every group."""
    for S, nb, B, n, k in ((1, 8192, 1024, 2048, 2),
                           (64, 128, 1024, 2048, 2),
                           (1, 4096, 1024, 2048, 2),
                           (64, 128, 1024, 4096, 4),
                           (1, 4096, 2048, 4096, 2),
                           (1, 128, 1024, 2048, 2),
                           (1, 128, 1024, 32768, 32)):
        p = ola_plan(S, nb, B, n, True)
        out_len = (nb - 1) * B + n
        assert (p.vec, p.k) == (op.VEC, k)
        assert p.grid == (-(-out_len // p.vec // op.THREADS), 2 * S)
        assert ola_plan(S, nb, B, n, False).vec == 1
    assert ola_plan(1, 8192, 1024, 2048, True).body == "float4, k 2"
    assert ola_plan(1, 128, 1024, 32768, True).body == \
        "float4, k 32 in batches of 8"
    assert ola_plan(1, 7, 2, 8, True).body == "scalar, k 4"
    # the scene mixdown's 128 summed frames still spread over the SMs
    assert ola_plan(1, 128, 1024, 2048, True).grid[0] * 2 > 132 * 3


def test_vector_width_follows_the_hop():
    """One float4 a thread where B ≥ 4 (V divides B, so a thread's
    outputs share one q), the scalar body below 4 or off alignment."""
    for B, want in ((1, 1), (2, 1), (4, 4), (8, 4), (1024, 4)):
        assert ola_plan(3, 5, B, 4 * B, True).vec == want
        assert ola_plan(3, 5, B, 4 * B, False).vec == 1


def test_rows_beyond_32_bits_are_refused():
    """From the shape alone: a source's frames of 2^31 values or more
    (its output row is shorter), a hop that is no power of two or does
    not divide n_fft, no frames."""
    assert check_rows(1, 2**17, 2048, 4096) == (2**17 - 1) * 2048 + 4096
    assert check_rows(3, 2**18 - 1, 2048, 4096) == (2**18 - 2) * 2048 + 4096
    for args in ((1, 2**18, 2048, 4096),  # nb·2·n_fft = 2^31
                 (1, 2**14, 32, 2**16),
                 (1, 8, 3, 6), (1, 8, 1024, 1536), (1, 8, 2048, 1024),
                 (0, 8, 1024, 2048), (1, 0, 1024, 2048)):
        with pytest.raises(ValueError):
            check_rows(*args)
        with pytest.raises(ValueError):
            ola_plan(*args, True)


def test_grid_y_loops_past_65535_rows():
    """More than 65535 rows: grid y stops at 65535 and the kernel's row
    loop (row += gridDim.y) covers each row once."""
    S = 40000
    p = ola_plan(S, 1, 1, 2, True)
    assert p.grid[1] == op.MAX_GRID_Y
    covered = np.concatenate([np.arange(y, 2 * S, p.grid[1])
                              for y in range(p.grid[1])])
    assert np.array_equal(np.sort(covered), np.arange(2 * S))

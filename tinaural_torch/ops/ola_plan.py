"""Launch plan of the overlap-add kernel `overlap_add`
(``csrc/block_render.cu``; wrapper ``ops/block_render.py``
`overlap_add_cuda`).

The kernel makes out[s,e,t] = Σ_j frames[s, q−j, e, t − (q−j)·B] with q =
⌊t/B⌋ over the k = n_fft/B frames that exist, adding frame q first, then
q−1, …, into zeros: the order of the plain `ola.overlap_add`, so the two
agree in bits. Thread g of a (source, ear) row makes the V consecutive
outputs g·V … g·V + V − 1 (V divides B, so they share q), loading every
frame it needs before its first add (k = 2 and 4 at once, any other k in
batches of `BATCH`). Grid x covers a row's groups, grid y the 2·S rows
(looping past `MAX_GRID_Y`).

- V = `VEC` (one float4 a frame) at B ≥ 4; 1 (the scalar body) at B < 4
  or where the frames or out pointer is not `ALIGN_BYTES` aligned.
- Index math within a row is 32-bit: B is a power of two (a shift and a
  mask), and a row — one source's nb·2·n_fft frame values, or one ear's
  shorter output — holds fewer than 2^31 samples, or `check_rows` raises.

The figures are the CUDA constants (``kOlaVec``, ``kOlaThreads``,
``kOlaBatch``, ``kOlaAlign``, ``kOlaMaxIndex``): the entry point computes
the same plan from them and launches no other. A sweep on an H100 chose
them (``PERF.md``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

VEC = 4  # outputs a thread at B ≥ 4: one float4
THREADS = 128  # threads a block
BATCH = 8  # frames loaded before their adds where k is not 2 or 4
ALIGN_BYTES = 16  # a float4 load or store
MAX_INDEX = 2**31 - 1  # the largest 32-bit offset within a row
MAX_GRID_Y = 65535


@dataclass(frozen=True)
class OlaPlan:
    """One launch of `overlap_add`."""

    vec: int  # outputs a thread (1: the scalar body)
    k: int  # frames over each sample, n_fft/B
    grid: tuple[int, int]  # (a row's groups, the rows up to MAX_GRID_Y)

    @property
    def body(self) -> str:
        """The kernel instance: its vector width and its k."""
        width = "scalar" if self.vec == 1 else "float4"
        frames = (f"k {self.k}" if self.k in (2, 4)
                  else f"k {self.k} in batches of {BATCH}")
        return f"{width}, {frames}"


def check_rows(S: int, nb: int, B: int, n_fft: int) -> int:
    """The output length (nb−1)·B + n_fft of a launch over (S, nb, 2,
    n_fft) frames at hop B; raises where B is no power of two dividing
    n_fft, or a source's nb·2·n_fft frame values (the longest row the
    kernel indexes: an output row is shorter) reach 2^31."""
    if B < 1 or B & (B - 1) or n_fft < B or n_fft % B:
        raise ValueError(f"hop {B} must be a power of two dividing "
                         f"n_fft={n_fft}")
    if S < 1 or nb < 1:
        raise ValueError(f"overlap_add needs frames, got S={S}, nb={nb}")
    if nb * 2 * n_fft > MAX_INDEX:
        raise ValueError(
            f"a row of {nb * 2 * n_fft} frame values leaves the kernel's "
            f"32-bit offsets (nb={nb}, n_fft={n_fft})")
    return (nb - 1) * B + n_fft


@functools.lru_cache(maxsize=1024)
def ola_plan(S: int, nb: int, B: int, n_fft: int, aligned: bool) -> OlaPlan:
    """The plan for (S, nb, 2, n_fft) frames at hop B, the frames and out
    pointers ``aligned`` to ALIGN_BYTES or not."""
    out_len = check_rows(S, nb, B, n_fft)
    vec = 1 if B < 4 or not aligned else VEC
    grid_x = -(-(out_len // vec) // THREADS)
    return OlaPlan(vec, n_fft // B, (grid_x, min(2 * S, MAX_GRID_Y)))

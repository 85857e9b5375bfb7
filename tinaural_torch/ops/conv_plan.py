"""Launch plans of the partitioned convolution's register kernels
(``csrc/partitioned.cu``; wrappers in ``ops/partitioned_conv.py``).

At blocks B = `MIN_CONV_BLOCK` … `MAX_CONV_BLOCK` (2B = 128 … 4096, the
partition FFTs of `assemble_partitions`' register body) every 2B-point
transform is the register FFT of ``csrc/fft_reg.cuh`` (`RegPlan`): 16
points a thread, T = 2B/16 threads a transform, radix-16 passes with one
exchange through shared memory between them, the forward transform as the
conjugate of the inverse, twiddles from `spectra_inverse.twiddles(2B)`.

- `stream_conv`: G streams per CUDA block of `threads` threads (G a power
  of two, picked from S and the card's SM count as
  `PartitionsPlan.rows_per_block` picks rows). ⌈G/2⌉ forward transforms,
  each of two streams' real frames [prev_in | xb] packed as one complex
  frame; then the MAC over the P partitions, G·(B+1) bins × `part_groups`
  groups of partitions spread over the block's threads, each group's sums
  in its own slice of shared memory; then 2G inverses at once on their
  own T threads each, one per (stream, ear): Yn + i·Yp of the ear, so the
  blend of the last B samples, u·Re + (1−u)·Im, runs in each thread's
  registers (without crossfade Yp is 0 and u is 1: the hold step).
- `frame_spectra`: the overlap-save frame spectra of a render, each frame
  once: frames 2m and 2m + 1 in one complex transform (so a frame's bits
  do not depend on how the render is cut into chunks), `frame_groups`
  transforms per CUDA block.
- `partitioned_conv`: one output block per CUDA block, its MAC over the P
  frame spectra that `frame_spectra` wrote (bins × partition groups
  spread over the threads as in `stream_conv`), and the two ears'
  inverses at once, as in `stream_conv` with G = 1. Its threads grow from
  max(64, 2T) by powers of two, up to MAX_THREADS, until the blocks hold
  FILL_THREADS threads per SM: (g)'s 2048 blocks take 128 threads, so
  several blocks share an SM and one's MAC loads overlap another's
  inverse; (j)'s 256 blocks 512.

The figures here are the launch as the CUDA code computes it at compile
time (`conv_max_streams`, `conv_threads`, `conv_part_groups`,
`conv_shared_f2`, `frame_max_groups`, `part_threads_ok`): the wrappers
hand the entry points G, threads and the shared figure, and the entry
points refuse any other plan and launch nothing. Outside the register range, and in the split
buffer mode (``ops/_layout.py``), both kernels run their radix-2 body, one
block of `RADIX2_THREADS` threads per stream or output block, and the
radix-2 `partitioned_conv` computes its frame spectra itself.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ._layout import RADIX2, REGISTER
from .spectra_inverse import inverse_plan

# the register range: 2B = 128 … 4096, as assemble_partitions' register body
MIN_CONV_BLOCK = 64
MAX_CONV_BLOCK = 2048
POINTS = 16  # values per thread in each register transform
MAX_THREADS = 512  # per block of stream_conv or partitioned_conv
MIN_THREADS = 256  # over which a block's MAC spreads at least
MAX_STREAMS = 16  # G of stream_conv at most
MIN_PART_THREADS = 64  # per block of partitioned_conv at least
FILL_THREADS = 512  # per SM that partitioned_conv's blocks aim at
FRAME_THREADS = 256  # per block of frame_spectra at most
RADIX2_THREADS = 256  # the radix-2 body's


def _fill(count: int, most: int, sms: int) -> int:
    """The largest power of two up to ``most`` that still gives each of
    ``sms`` SMs a block over ``count`` items (1 where count < sms; ``most``
    with no card, sms 0)."""
    G = most
    while G > 1 and -(-count // G) < sms:
        G //= 2
    return G


@dataclass(frozen=True)
class ConvPlan:
    """The launches of the partitioned convolution's kernels at block
    ``block`` with ``parts`` partitions."""

    block: int  # B
    parts: int  # P
    radices: tuple[int, ...]  # the 2B-point passes; () outside the range
    body: str  # REGISTER or RADIX2 (``ops/_layout.py``)

    @property
    def n(self) -> int:
        return 2 * self.block

    @property
    def transform_threads(self) -> int:
        """T: the threads of one 2B-point transform."""
        return self.n // POINTS

    @property
    def row_f2(self) -> int:
        """complex64 of one transform's padded exchange buffer."""
        return self.n + self.n // 16

    @property
    def max_streams(self) -> int:
        """G of `stream_conv` at most: 2G transforms of T threads fit
        MAX_THREADS."""
        return min(MAX_STREAMS, MAX_THREADS // (2 * self.transform_threads))

    def streams_per_block(self, S: int, sms: int) -> int:
        """G of `stream_conv` for S streams on a card of ``sms`` SMs."""
        return _fill(S, self.max_streams, sms)

    def threads(self, G: int) -> int:
        """Threads of a `stream_conv` block of G streams: the 2G
        inverses' 2G·T, at least MIN_THREADS, and where P > 1 enough for
        G·2B (bin, partition) pairs at once, up to MAX_THREADS."""
        wide = min(MAX_THREADS, 2 * G * self.block) if self.parts > 1 else 0
        return max(MIN_THREADS, 2 * G * self.transform_threads, wide)

    def part_groups(self, G: int, threads: int) -> int:
        """Groups of partitions whose MACs run at once on a block of G
        streams and ``threads`` threads: as many as the threads hold G·B
        bins each, at most P."""
        return min(self.parts, max(1, threads // (G * self.block)))

    def shared_f2(self, G: int, threads: int, forward: bool) -> int:
        """complex64 of shared memory of a block of G streams and
        ``threads`` threads: with ``forward``, the ⌈G/2⌉ forward
        transforms' buffers below the MAC's sums (4 planes of B+1 bins per
        stream and partition group); the 2G inverses' buffers over both
        once they are read."""
        fwd = (G + 1) // 2 * self.row_f2 if forward else 0
        acc = self.part_groups(G, threads) * G * 4 * (self.block + 1)
        return max(fwd + acc, 2 * G * self.row_f2)

    def part_threads(self, n_blocks: int, sms: int) -> int:
        """Threads of a `partitioned_conv` block over ``n_blocks`` output
        blocks on a card of ``sms`` SMs: from max(MIN_PART_THREADS, 2T)
        doubled, up to MAX_THREADS, while the blocks hold fewer than
        FILL_THREADS threads per SM."""
        t = max(MIN_PART_THREADS, 2 * self.transform_threads)
        while t < MAX_THREADS and n_blocks * t < FILL_THREADS * sms:
            t *= 2
        return t

    @property
    def frame_max_groups(self) -> int:
        """Transforms per block of `frame_spectra` at most."""
        return max(1, FRAME_THREADS // self.transform_threads)

    def frame_groups(self, transforms: int, sms: int) -> int:
        return _fill(transforms, self.frame_max_groups, sms)

    # the radix-2 body: shared figures and one scratch slice (split mode)
    @property
    def stream_radix2_f2(self) -> int:
        return 7 * self.block

    @property
    def stream_scratch_f2(self) -> int:
        return 6 * self.block

    @property
    def conv_radix2_f2(self) -> int:
        return 5 * self.block + 4 * (self.block + 1)

    @property
    def conv_scratch_f2(self) -> int:
        return 4 * self.block + 4 * (self.block + 1)


@functools.cache
def conv_plan(block: int, parts: int) -> ConvPlan:
    """The kernels' plan (block a power of two of at least 2, parts ≥ 1)."""
    if block < 2 or block & (block - 1) or parts < 1:
        raise ValueError(f"block={block} must be a power of two of at least "
                         f"2 and parts={parts} positive")
    if MIN_CONV_BLOCK <= block <= MAX_CONV_BLOCK:
        return ConvPlan(block, parts, inverse_plan(2 * block).radices,
                        REGISTER)
    return ConvPlan(block, parts, (), RADIX2)


@functools.lru_cache(maxsize=1024)
def stream_launch(block: int, parts: int, S: int,
                  sms: int) -> tuple[int, int, int]:
    """(G, threads, shared figure) of one `stream_conv` launch over S
    streams on a card of ``sms`` SMs; (0, RADIX2_THREADS, shared figure)
    of the radix-2 body outside the register range. Cached, as the
    serving paths launch one shape per push."""
    plan = conv_plan(block, parts)
    if plan.body != REGISTER:
        return 0, RADIX2_THREADS, plan.stream_radix2_f2
    G = plan.streams_per_block(S, sms)
    threads = plan.threads(G)
    return G, threads, plan.shared_f2(G, threads, True)


@functools.lru_cache(maxsize=1024)
def conv_launch(block: int, parts: int, n_blocks: int,
                sms: int) -> tuple[int, int]:
    """(threads, shared figure) of one `partitioned_conv` launch over
    ``n_blocks`` output blocks, one per CUDA block, on a card of ``sms``
    SMs; (0, radix-2 shared figure) outside the register range."""
    plan = conv_plan(block, parts)
    if plan.body != REGISTER:
        return 0, plan.conv_radix2_f2
    threads = plan.part_threads(n_blocks, sms)
    return threads, plan.shared_f2(1, threads, False)


@functools.lru_cache(maxsize=1024)
def frames_launch(block: int, transforms: int,
                  sms: int) -> tuple[int, int, int]:
    """(transforms per block, threads, shared figure) of one
    `frame_spectra` launch of ``transforms`` two-frame transforms."""
    plan = conv_plan(block, 1)
    if plan.body != REGISTER:
        raise ValueError(f"frame_spectra takes blocks {MIN_CONV_BLOCK} … "
                         f"{MAX_CONV_BLOCK}, not {block}")
    G = plan.frame_groups(transforms, sms)
    return G, G * plan.transform_threads, G * plan.row_f2


def chunk_frames(start: int, stop: int, parts: int) -> tuple[int, int]:
    """(first frame, frames) whose spectra a `partitioned_conv` chunk of
    blocks start … stop − 1 reads: its blocks and the P − 1 frames before
    them, from frame 0 on."""
    f0 = max(0, start - parts + 1)
    return f0, stop - f0


def pair_start(frame: int) -> int:
    """The first frame of the `frame_spectra` transform that holds
    ``frame``: transforms pair frames 2m and 2m + 1, so a frame's spectrum
    is the same in bits however a render is cut into chunks."""
    return frame - frame % 2


def forward_transforms(frames: int) -> int:
    """`frame_spectra`'s forward transforms over ``frames`` frames: two
    frames each."""
    return -(-frames // 2)


def stream_forward_transforms(block: int, parts: int, S: int,
                              sms: int) -> int:
    """`stream_conv`'s forward transforms over S streams: ⌈G/2⌉ per block
    of G streams (the last block's live streams), in the register body;
    one per stream in the radix-2 body."""
    plan = conv_plan(block, parts)
    if plan.body != REGISTER:
        return S
    G = plan.streams_per_block(S, sms)
    return S // G * -(-G // 2) + -(-(S % G) // 2)

"""Launch plan of kernel `assemble_partitions` (``csrc/assemble_partitions.cu``;
wrapper `partitioned_conv.assemble_partitions_cuda`).

Where the rows need no chain (``chain`` false: neither ITD nor ILD
applies, so the delay is 0, the ramp 1 and the gain 1, and the chain
returns the lerp of the table rows zero-padded to t_pad) and B =
`MIN_CLUSTER_BLOCK` … `MAX_CLUSTER_BLOCK`, the direct body at every L:

- direct: one unit of work a (row, partition), S units per CUDA block of
  S·2B/16 threads (`direct_slots`: the largest power of two up to
  `DIRECT_THREADS`/(2B/16), at least 1, that still gives every SM a
  block; one unit a block from B 512 up), each loading its B samples
  straight from the 4 table rows, lerped in registers, into one 2B-point
  register transform of ``csrc/fft_reg.cuh``: no L-point transform, ramp
  or cluster.

Otherwise three buffer modes, picked by ``ops/_layout.py`` from the
plan's shared figure:

- shared (L ≤ 8192). At blocks B = `MIN_CLUSTER_BLOCK` … `MAX_CLUSTER_BLOCK`
  the register body: G rows per CUDA block of `block_threads` threads
  (`rows_per_block`, from the rows and the card's SM count), their
  L-point chains (gather, rfft_L as the conjugate of the register
  inverse, the table-driven ramp and the gain, irfft_L) at once, each on
  L/16 of its row's T/G threads, which share the row's ramp pass and,
  where they are at least twice the chain's, its gather; then the
  block's G·P partitions as 2B-point register transforms of
  ``csrc/fft_reg.cuh`` on 2B/16 threads each, T/(2B/16) at once. At
  other blocks the radix-2 body, one block of `SHARED_THREADS` threads
  per row;
- cluster (`MIN_CLUSTER_L` ≤ L ≤ `MAX_CLUSTER_L`, block B in
  `MIN_CLUSTER_BLOCK` … `MAX_CLUSTER_BLOCK`): one thread-block cluster of
  ``ranks = L / 16384`` blocks of `CLUSTER_THREADS` threads per row. Each
  L-point transform of the chain (gather, rfft_L as the conjugate of the
  register inverse, the ramp, irfft_L) is a radix-``ranks`` step across
  the cluster and each block's 16384-point register FFT of
  ``csrc/fft_reg.cuh`` (`ClusterPlan`), with the exchanges through the
  cluster's distributed shared memory. The truncated h_eff then lies in
  the blocks' shared memory, 16384 samples each, and every block runs the
  2B-point FFTs (`RegPlan`, 2B/16 threads each) of the partitions whose
  samples it holds, 8192/B of them at a time in two rounds;
- split (every other shape, or forced): the radix-2 body over a device
  scratch.

`partitions_plan` is the launch as the kernel computes it at compile time:
the wrapper hands the entry point the plan's body (direct or not), ranks,
threads and rows or units per block, and the entry point refuses any
other, the direct body with ITD or ILD on among them. Twiddles come from
`spectra_inverse.twiddles` at L, 16384 (cluster) and 2B, the ramp's taper
from `mac_plan.ramp_taper`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..data.table import DELAY_PAD
from ._layout import CLUSTER, DIRECT, RADIX2, REGISTER
from .filters import n_parts, next_pow2
from .spectra_inverse import MAX_REGISTER_N, inverse_plan

MIN_CLUSTER_L = MAX_REGISTER_N  # 16384: one block
MAX_CLUSTER_L = 1 << 17  # 8 blocks, the portable cluster size
# the partition FFTs of the cluster mode and of the shared mode's register
# body: 2B = 128 … 4096 points
MIN_CLUSTER_BLOCK = 64
MAX_CLUSTER_BLOCK = 2048
CLUSTER_THREADS = 1024
SHARED_THREADS = 256  # the radix-2 body's
# the register body: L = 128 … MAX_REGISTER_L at the cluster mode's blocks,
# at most REGISTER_THREADS threads (128 registers each) and MAX_ROWS rows
# per CUDA block
MAX_REGISTER_L = MIN_CLUSTER_L // 2
REGISTER_THREADS = 512
MIN_REGISTER_THREADS = 256  # over which a few rows' ramp and gather spread
MAX_ROWS = 16
POINTS = 16  # values per thread in each register transform
# samples of h_eff per block of the cluster mode, and per partition round
RANK_SAMPLES = MAX_REGISTER_N
ROUND_SAMPLES = RANK_SAMPLES // 2
# the direct body: S transforms of 2B/16 threads a CUDA block, as many as
# DIRECT_THREADS threads hold and at least one. Small blocks wait on
# small barriers: at 44,100 taps × B 512 on an H100, 1.93 ms a call of
# room44k.streamed's 4,106 rows at 64 threads a block, 2.02 at 128, 2.27
# at 256, 2.72 at 512; at B 64 and 2048, 64 … 256 threads within 7%.
DIRECT_THREADS = 64
# samples of the second round that the first round's exchange buffers
# cover (threads hold them in registers), so a block's shared memory fits
# the SM's 196 KB carve-out with its 1 KB reserve
KEEP_SAMPLES = 640


@dataclass(frozen=True)
class PartitionsPlan:
    """One launch of `assemble_partitions` for ``taps``-tap filters cut
    into partitions of ``block`` samples."""

    taps: int
    block: int  # B
    L: int  # next_pow2(t_pad)
    t_pad: int  # taps + DELAY_PAD
    parts: int  # P = ⌈t_pad / B⌉
    body: str  # DIRECT, CLUSTER, REGISTER or RADIX2 (``ops/_layout.py``)
    ranks: int  # blocks per row in the cluster mode, else 0
    radices_L: tuple[int, ...]  # the register or cluster mode's L-point
    # passes
    radices_2B: tuple[int, ...]  # their (or the direct body's) partition
    # FFTs' passes
    threads: int  # per block of the radix-2 body or the cluster mode
    # (the register and direct bodies': from `launch`, 0 here)
    max_rows: int  # the register body's most rows per block, else 1
    shared_f2: int  # complex64 of shared memory per block of the radix-2
    # body or the cluster mode (the register and direct bodies': from
    # `launch`)
    scratch_f2: int  # complex64 of one scratch slice, split mode

    @property
    def slots(self) -> int:
        """Partitions a block transforms at once in the cluster mode."""
        return ROUND_SAMPLES // self.block

    def rows_per_block(self, rows: int, sms: int) -> int:
        """G of the register body: the largest power of two up to
        `max_rows` that still gives each of ``sms`` SMs a block (1 where
        rows < sms; `max_rows` with no card, sms 0); 1 in the other
        modes."""
        G = self.max_rows
        while G > 1 and -(-rows // G) < sms:
            G //= 2
        return G

    def block_threads(self, G: int) -> int:
        """Threads of a register block of G rows: twice the G chains' L/16
        each up to REGISTER_THREADS, or as many partitions' 2B/16 as its
        G·P take up to REGISTER_THREADS, whichever is more, and at least
        MIN_REGISTER_THREADS. Each row's T/G threads share its ramp pass,
        and its gather where they are at least twice its chain's."""
        Tp = 2 * self.block // POINTS
        slots = min(G * self.parts, REGISTER_THREADS // Tp)
        wide = min(2 * G * self.L // POINTS, REGISTER_THREADS)
        return max(wide, slots * Tp, MIN_REGISTER_THREADS)

    def direct_slots(self, units: int, sms: int) -> int:
        """S of the direct body over ``units`` (rows × P): the largest
        power of two up to DIRECT_THREADS/(2B/16) (at least 1) that still
        gives each of ``sms`` SMs a block (1 where units < sms; the most
        with no card, sms 0)."""
        S = max(1, DIRECT_THREADS * POINTS // (2 * self.block))
        while S > 1 and -(-units // S) < sms:
            S //= 2
        return S

    def block_shared_f2(self, G: int) -> int:
        """complex64 of shared memory of a register block of G rows: the
        chains' padded exchange buffers, and over them h_eff's G·t_pad
        samples below one padded 2B-point exchange buffer per partition
        slot."""
        n2 = 2 * self.block
        slots = self.block_threads(G) // (n2 // POINTS)
        return max(G * (self.L + self.L // 16),
                   G * self.t_pad + slots * (n2 + n2 // 16))


@functools.cache
def partitions_plan(taps: int, block: int, chain: bool) -> PartitionsPlan:
    """The kernel's plan (block a power of two of at least 2) for rows
    whose delays or gains apply (``chain``: ITD or ILD on), or, without,
    the direct body's at blocks 64 … 2048."""
    if taps < 1 or block < 2 or block & (block - 1):
        raise ValueError(f"taps={taps} must be positive and block={block} a "
                         "power of two of at least 2")
    t_pad = taps + DELAY_PAD
    L = next_pow2(t_pad)
    P = n_parts(taps, block)
    scratch = 2 * L + 2 * block
    if not chain and MIN_CLUSTER_BLOCK <= block <= MAX_CLUSTER_BLOCK:
        return PartitionsPlan(taps, block, L, t_pad, P, DIRECT, 0, (),
                              inverse_plan(2 * block).radices, 0, 1, 0,
                              scratch)
    if (MIN_CLUSTER_L <= L <= MAX_CLUSTER_L
            and MIN_CLUSTER_BLOCK <= block <= MAX_CLUSTER_BLOCK):
        # h_eff's 16384 samples, with one round's padded exchange buffers,
        # 8192/B · (2B + 2B/16), from KEEP_SAMPLES below its second half
        rounds_f2 = (ROUND_SAMPLES - KEEP_SAMPLES
                     + RANK_SAMPLES + RANK_SAMPLES // 16)
        return PartitionsPlan(taps, block, L, t_pad, P, CLUSTER,
                              L // RANK_SAMPLES,
                              inverse_plan(L).radices,
                              inverse_plan(2 * block).radices,
                              CLUSTER_THREADS, 1, rounds_f2, scratch)
    if L <= MAX_REGISTER_L and MIN_CLUSTER_BLOCK <= block <= MAX_CLUSTER_BLOCK:
        return PartitionsPlan(taps, block, L, t_pad, P, REGISTER, 0,
                              inverse_plan(L).radices,
                              inverse_plan(2 * block).radices, 0,
                              min(MAX_ROWS, REGISTER_THREADS * POINTS // L),
                              0, scratch)
    return PartitionsPlan(taps, block, L, t_pad, P, RADIX2, 0, (), (),
                          SHARED_THREADS, 1,
                          max(L, 2 * block) // 2 + 2 * L + 2 * block, scratch)


@functools.lru_cache(maxsize=1024)
def launch(taps: int, block: int, rows: int, sms: int,
           chain: bool) -> tuple[int, int, int]:
    """(G, threads, shared figure) of one launch over ``rows`` rows on a
    card of ``sms`` SMs: the register body's `rows_per_block`,
    `block_threads` and `block_shared_f2`; the direct body's S =
    `direct_slots` over rows × P, S·2B/16 threads and S padded 2B-point
    exchange buffers; (1, threads, shared_f2) of the plan in the other
    modes. Cached, as the serving paths launch one shape per push."""
    plan = partitions_plan(taps, block, chain)
    if plan.body == DIRECT:
        n2 = 2 * block
        S = plan.direct_slots(rows * plan.parts, sms)
        return S, S * n2 // POINTS, S * (n2 + n2 // 16)
    if plan.body != REGISTER:
        return 1, plan.threads, plan.shared_f2
    G = plan.rows_per_block(rows, sms)
    return G, plan.block_threads(G), plan.block_shared_f2(G)

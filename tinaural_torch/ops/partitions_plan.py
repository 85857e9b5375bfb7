"""Launch plan of kernel `assemble_partitions` (``csrc/partitioned.cu``;
wrapper `partitioned_conv.assemble_partitions_cuda`).

Three buffer modes, picked by ``ops/_layout.py`` from the plan's shared
figure:

- shared (L ≤ 8192): one block of `SHARED_THREADS` threads per row, the
  radix-2 effective-filter chain and partition FFTs in its shared memory;
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
- split (every other shape, or forced): the shared mode's body over a
  device scratch.

`partitions_plan` is the launch as the kernel computes it at compile time:
the wrapper hands the entry point the plan's ranks, and the entry point
refuses any other. Twiddles come from `spectra_inverse.twiddles` at L,
16384 and 2B, the ramp's taper from `mac_plan.ramp_taper`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..data.table import DELAY_PAD
from .filters import n_parts, next_pow2
from .spectra_inverse import MAX_REGISTER_N, inverse_plan

MIN_CLUSTER_L = MAX_REGISTER_N  # 16384: one block
MAX_CLUSTER_L = 1 << 17  # 8 blocks, the portable cluster size
# the partition FFTs of the cluster mode: 2B = 128 … 4096 points
MIN_CLUSTER_BLOCK = 64
MAX_CLUSTER_BLOCK = 2048
CLUSTER_THREADS = 1024
SHARED_THREADS = 256
# samples of h_eff per block of the cluster mode, and per partition round
RANK_SAMPLES = MAX_REGISTER_N
ROUND_SAMPLES = RANK_SAMPLES // 2
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
    ranks: int  # blocks per row in the cluster mode, else 0
    radices_L: tuple[int, ...]  # the cluster mode's L-point passes
    radices_2B: tuple[int, ...]  # its partition FFTs' passes
    threads: int  # per block
    shared_f2: int  # complex64 of shared memory per block, shared or
    # cluster mode
    scratch_f2: int  # complex64 of one scratch slice, split mode

    @property
    def cluster(self) -> bool:
        return self.ranks > 0

    @property
    def slots(self) -> int:
        """Partitions a block transforms at once in the cluster mode."""
        return ROUND_SAMPLES // self.block


@functools.cache
def partitions_plan(taps: int, block: int) -> PartitionsPlan:
    """The kernel's plan (block a power of two of at least 2)."""
    if taps < 1 or block < 2 or block & (block - 1):
        raise ValueError(f"taps={taps} must be positive and block={block} a "
                         "power of two of at least 2")
    t_pad = taps + DELAY_PAD
    L = next_pow2(t_pad)
    P = n_parts(taps, block)
    scratch = 2 * L + 2 * block
    if (MIN_CLUSTER_L <= L <= MAX_CLUSTER_L
            and MIN_CLUSTER_BLOCK <= block <= MAX_CLUSTER_BLOCK):
        # h_eff's 16384 samples, with one round's padded exchange buffers,
        # 8192/B · (2B + 2B/16), from KEEP_SAMPLES below its second half
        rounds_f2 = (ROUND_SAMPLES - KEEP_SAMPLES
                     + RANK_SAMPLES + RANK_SAMPLES // 16)
        return PartitionsPlan(taps, block, L, t_pad, P, L // RANK_SAMPLES,
                              inverse_plan(L).radices,
                              inverse_plan(2 * block).radices,
                              CLUSTER_THREADS, rounds_f2, scratch)
    return PartitionsPlan(taps, block, L, t_pad, P, 0, (), (), SHARED_THREADS,
                          max(L, 2 * block) // 2 + 2 * L + 2 * block, scratch)

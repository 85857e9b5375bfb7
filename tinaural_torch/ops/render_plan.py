"""Launch plans of the block render's two register kernels.

`assemble_filters` (``csrc/assemble_filters.cu``; wrapper
`block_render.assemble_filters_cuda`) assembles ``rows_per_block`` = G
filters per CUDA block of ``threads = n/16`` threads. The G rows' L-point
chains (gather, rfft_L, ramp and gain, irfft_L: `assembly_mac`'s stages)
run at once on G groups of L/16 threads, each
in its own padded exchange buffer. Each row's truncated h_eff then goes to
shared memory, and every thread takes its 16/G nonzero inputs of each
row's n-point rfft into registers. The G rfft_n then run one after the
other on the whole block, and thread ``lane`` writes bins lane + i·T of
H. So no thread idles in the L-point stages while G·L/16 ≤ n/16, and one
exchange buffer of n + n/16 complex64 serves both phases. G is n/L, at
most 16 (one nonzero input per thread and row).

`block_spectra_mix_inverse` (``csrc/block_mix_inverse.cu``; wrapper
`block_render.block_spectra_mix_inverse_cuda`) runs one output block b per
CUDA block, in groups of ``threads = n/16`` threads, each group looping
over its share of the sources in order: a forward register FFT of the
block's samples, an exchange to the bins lane + i·T and n − k, the
crossfaded MAC into 18 accumulators per thread (in a slice of shared
memory below n_fft 16384, in registers at 16384). Group 0 then adds the
other groups' sums in order and runs the packed inverse of both ears.
`mix_groups` picks the groups from the shapes and the card: one where nb
blocks fill the card, more where they do not (64 sources × 128 blocks on
132 SMs take 4), so a block's sum is deterministic for a given card.

Both are the register FFT of ``csrc/fft_reg.cuh`` (`RegPlan`), 16 points
per thread, the forward transforms as the conjugate of the inverse, with
twiddles from `spectra_inverse.twiddles` and the ramp's taper from
`mac_plan.ramp_taper`. `filters_plan` and `mix_plan` are the launches as
the kernels compute them at compile time; the wrappers hand the entry
points the plan's ranks, threads, rows per block, blocks per SM and
groups, and the entry points refuse any other plan.

Above `MAX_REGISTER_N`, up to `MAX_CLUSTER_N`, both kernels have a
cluster mode (``csrc/fft_reg.cuh`` `ClusterPlan`): a thread-block cluster
of ``ranks = n/16384`` blocks of `CLUSTER_THREADS` threads takes a run of
rows (`assemble_filters`, where the assembly's L equals n_fft; runs from
the clusters the card places at once, `_layout.cluster_slots`) or
one output block (`block_spectra_mix_inverse`, at any L), each n-point
transform a radix-``ranks`` step across the cluster and each block's
16384-point register FFT, so the radices are ``(ranks, 16, 16, 16, 4)``.
Their shared figure (``shared_f2``; the mix plan's ``group_f2``, one group
a block) is one block's share. Every other shape above `MAX_REGISTER_N`
(n_fft above `MAX_CLUSTER_N`, or `assemble_filters` with L < n_fft, as at
block 1024 and 15,298 … 16,320 taps) has the `RADIX2` body, whose shared
figure no card holds, so ``ops/_layout.py`` always splits it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..data.table import DELAY_PAD
from ._layout import CLUSTER, RADIX2, REGISTER
from .filters import next_pow2
from .spectra_inverse import (CLUSTER_THREADS, MAX_CLUSTER_N,
                              MAX_REGISTER_N, inverse_plan)

POINTS = 16  # values per thread in each register transform
MAX_ROWS = 16  # rows per block of assemble_filters: ≥ 1 input per thread
# threads' worth of blocks that assemble_filters' __launch_bounds__ asks to
# fit one SM, so up to 255 registers a thread below 512 threads, at most 32
# blocks
SM_THREADS = 256
MAX_BLOCKS_PER_SM = 32
# threads of one mix kernel block at most: groups of n/16 threads each
MIX_BLOCK_THREADS = 512
# threads per block of the split mode's radix-2 kernels
FILTERS_SPLIT_THREADS = 256
MIX_SPLIT_THREADS = 512
# the smallest n_fft of the mix kernel: 16 points on each of 8 threads
MIN_MIX_N = 128
# complex64 accumulators per thread of the mix kernel: 9 bins, 2 ears
ACC_SLOTS = 18
# groups of the mix kernel per SM that `mix_groups` aims at
MIX_FILL = 4


def min_blocks(threads: int) -> int:
    """The blocks per SM that `assemble_filters`' __launch_bounds__ ask
    for."""
    return 1 if threads >= SM_THREADS else min(MAX_BLOCKS_PER_SM,
                                               SM_THREADS // threads)


@dataclass(frozen=True)
class FiltersPlan:
    """One launch of `assemble_filters` for ``taps``-tap filters at n_fft
    ``n``."""

    taps: int
    n: int
    L: int  # the assembly's transform size, next_pow2(t_pad)
    t_pad: int  # taps + DELAY_PAD: the samples kept after irfft_L
    radices_L: tuple[int, ...]  # the L-point passes, first to last
    radices_n: tuple[int, ...]  # the n-point passes
    threads: int  # per block
    rows_per_block: int  # G
    blocks_per_sm: int  # that __launch_bounds__ asks for
    shared_f2: int  # complex64 of shared memory per block, shared or
    # cluster mode
    scratch_f2: int  # complex64 of one scratch slice, split mode
    body: str  # REGISTER, CLUSTER or RADIX2 (``ops/_layout.py``)
    ranks: int = 0  # blocks per cluster in the cluster mode, else 0


def _cluster_radices(n_fft: int) -> tuple[int, tuple[int, ...]]:
    """The cluster mode's ranks and radices at n_fft: the radix-C step,
    then each block's 16384-point transform."""
    ranks = n_fft // MAX_REGISTER_N
    return ranks, (ranks, *inverse_plan(MAX_REGISTER_N).radices)


@functools.cache
def filters_plan(taps: int, n_fft: int) -> FiltersPlan:
    """The kernel's plan (n_fft a power of two of at least taps +
    DELAY_PAD)."""
    t_pad = taps + DELAY_PAD
    if taps < 1 or n_fft & (n_fft - 1) or n_fft < t_pad:
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least "
                         f"taps + {DELAY_PAD} = {t_pad}")
    L = next_pow2(t_pad)
    if MAX_REGISTER_N < n_fft <= MAX_CLUSTER_N and L == n_fft:
        # one block's share, which the pair exchange reuses
        ranks, radices = _cluster_radices(n_fft)
        return FiltersPlan(taps, n_fft, L, t_pad, radices, radices,
                           CLUSTER_THREADS, 1, 1,
                           inverse_plan(MAX_REGISTER_N).shared_f2,
                           n_fft + 2 * L, CLUSTER, ranks)
    if n_fft > MAX_REGISTER_N:
        log2 = lambda m: m.bit_length() - 1
        return FiltersPlan(taps, n_fft, L, t_pad, (2,) * log2(L),
                           (2,) * log2(n_fft), FILTERS_SPLIT_THREADS, 1, 1,
                           n_fft // 2 + n_fft + 2 * L, n_fft + 2 * L, RADIX2)
    threads = n_fft // POINTS
    # one exchange buffer, n + n/16 complex64 (a float2 of padding after
    # every 16, csrc/fft_reg.cuh): the G group buffers of L + L/16 fill it
    return FiltersPlan(taps, n_fft, L, t_pad, inverse_plan(L).radices,
                       inverse_plan(n_fft).radices, threads,
                       min(n_fft // L, MAX_ROWS), min_blocks(threads),
                       n_fft + n_fft // 16, n_fft + 2 * L, REGISTER)


@dataclass(frozen=True)
class MixPlan:
    """One launch of `block_spectra_mix_inverse` at n_fft ``n``."""

    n: int
    radices: tuple[int, ...]  # the n-point passes, both directions
    threads: int  # per group; a group takes one source at a time
    max_groups: int  # per block: MIX_BLOCK_THREADS' worth
    blocks_per_sm: int  # that __launch_bounds__ asks for
    group_f2: int  # complex64 of shared memory per group, shared mode;
    # one block's share in the cluster mode
    scratch_f2: int  # complex64 of one scratch slice, split mode
    body: str  # REGISTER, CLUSTER or RADIX2 (``ops/_layout.py``)
    ranks: int = 0  # blocks per cluster in the cluster mode, else 0


@functools.cache
def mix_plan(n_fft: int) -> MixPlan:
    """The kernel's plan (n_fft a power of two of at least MIN_MIX_N)."""
    if n_fft < MIN_MIX_N or n_fft & (n_fft - 1):
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least "
                         f"{MIN_MIX_N}")
    F = n_fft // 2 + 1
    if MAX_REGISTER_N < n_fft <= MAX_CLUSTER_N:
        # one cluster an output block, one block's share each
        ranks, radices = _cluster_radices(n_fft)
        return MixPlan(n_fft, radices, CLUSTER_THREADS, 1, 1,
                       inverse_plan(MAX_REGISTER_N).shared_f2,
                       n_fft + 2 * F, CLUSTER, ranks)
    if n_fft > MAX_REGISTER_N:
        log2 = n_fft.bit_length() - 1
        return MixPlan(n_fft, (2,) * log2, MIX_SPLIT_THREADS, 1, 1,
                       n_fft // 2 + n_fft + 2 * F, n_fft + 2 * F, RADIX2)
    threads = n_fft // POINTS
    # the exchange buffer, and below MAX_REGISTER_N the accumulators'
    # slices beside it
    acc = ACC_SLOTS * threads if n_fft < MAX_REGISTER_N else 0
    # two blocks of MIX_BLOCK_THREADS per SM: 64 registers a thread
    return MixPlan(n_fft, inverse_plan(n_fft).radices, threads,
                   max(1, MIX_BLOCK_THREADS // threads),
                   1 if threads > MIX_BLOCK_THREADS else 2,
                   n_fft + n_fft // 16 + acc, n_fft + 2 * F, REGISTER)


def mix_groups(S: int, nb: int, plan: MixPlan, sms: int) -> int:
    """Groups per block of `block_spectra_mix_inverse`: the fewest (a power
    of two) that give the card MIX_FILL groups per SM over nb blocks, at
    most the plan's and at most S. With 1 the sources run in order; with
    g, group j sums sources j, j + g, … and the groups' sums are added in
    order. ``sms`` 0 (no card) gives 1."""
    groups = 1
    while (2 * groups <= min(S, plan.max_groups)
           and nb * groups < MIX_FILL * sms):
        groups *= 2
    return groups

"""Launch plans of the block-step kernels `block_spectra` and
`block_spectra_mix` (``csrc/block_step.cu``; wrappers in
``ops/block_step.py``).

At n_fft `MIN_STEP_N` … `MAX_REGISTER_N` both run register bodies on the
register FFT of ``csrc/fft_reg.cuh`` (`RegPlan`): 16 points a thread,
T = n/16 threads a transform, radix-16 passes with one exchange through
shared memory between them, the forward transform as the conjugate of the
register inverse, twiddles from `spectra_inverse.twiddles(n)`. After one
more exchange to natural order, thread ``lane`` owns bins lane + i·T
(i < 8; lane 0 also n/2), unpacks both crossfade ramps' spectra from bins
k and n − k, and reads both filters and writes its bins coalesced.

- `block_spectra`: G rows per CUDA block of G·T threads, each row on its
  own T threads and its own padded exchange buffer of n + n/16 complex64
  (`row_f2`); G the fewest rows of at least `ROW_THREADS` threads (one row
  from n_fft 2048 up: on an H100 a block of one row took 0.166 ms over
  8192 rows at n_fft 2048, of four 0.179, `PERF.md`), halved while the rows
  give the card fewer than `ROW_FILL` blocks an SM (`spectra_rows`).
- `block_spectra_mix`: one (source chunk c, output block b) per CUDA
  block, in ``groups`` groups of T threads; group j takes the chunk's
  sources j, j + groups, … in order, its 18 accumulators a thread in its
  own slice of shared memory beside its buffer (in registers at n_fft
  16384, where the slices would not fit), and the groups' sums are added
  in the order of the groups into the partial P[c, b]. `mix_launch` picks
  the chunk and the groups together from S, nb, n_fft and the SM count:
  the fewest rounds of sources the busiest group slot runs, counting the
  blocks an SM holds at once (`resident_blocks`, from the H100's limits),
  then the fewest chunks.

The figures here are the launch as the CUDA code computes it at compile
time (`step_max_per_block`, `step_min_blocks`, `step_unit_f2`): the
wrappers hand the entry points the plan's threads, rows or groups per
block and blocks per SM, and the entry points refuse any other plan and
launch nothing.

Above `MAX_REGISTER_N` both kernels run their pruned bodies (`pruned_plan`)
wherever Q = max(next_pow2(B), 128) ≤ `MAX_REGISTER_N`: a block of B
samples zero-padded to n = P·Q has X[r + P·m] = Σ_{t<Q} (x[t]·ω_n^{r·t})·
ω_Q^{m·t}, so the n-point transform is P independent Q-point register
transforms of the pre-twiddled block (5·n·log2 Q operations, not
5·n·log2 n), with no scratch and no cluster. Bin n − k of bin k = r + P·m
lies in transform (P − r) mod P, so a CUDA block takes whole pairs of
residues: pair p is p and P − p, pair 0 is 0 and P/2. Residue group j of
a row (of a (chunk, block) for the mix kernel) is pairs j·g … j·g + g − 1
(`PrunedPlan.block_residues`), each transform on its own Q/16 threads and
buffer, and the MAC walks the group's bins so that g neighbouring threads
take g neighbouring bins. Under crossfade a transform holds both ramps
of a block, unpacked from bins k and n − k; without it the mix packs two
sources' real blocks into each transform (so its rounds count pairs of
sources, `pruned_rounds`), while `block_spectra` transforms a real block
alone. At Q = 16384 a pair does not fit one block: a block takes one
residue and, where it unpacks, runs its mirror's transform first.

Below `MIN_STEP_N`, where Q exceeds `MAX_REGISTER_N`, and in the split
buffer mode (``ops/_layout.py``; forced with ``_layout.force_work``) both
kernels run their radix-2 body: one row (or one (chunk, block)) per CUDA
block of `RADIX2_THREADS` threads, its FFT in ``csrc/common.cuh``
`fft_run`; `radix2_plan` describes that launch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ._layout import PRUNED, RADIX2, REGISTER
from .spectra_inverse import MAX_REGISTER_N, inverse_plan

POINTS = 16  # values per thread in each register transform
# the smallest n_fft of the register bodies: 16 points on each of 8 threads
MIN_STEP_N = 128
# threads of one register block at most: G rows or groups of n/16 threads
BLOCK_THREADS = 512
RADIX2_THREADS = 256  # the radix-2 body's block
# complex64 accumulators a thread of the mix kernel: 9 bins, 2 ears
ACC_SLOTS = 18
# threads of one block_spectra block at least, where rows are short
ROW_THREADS = 128
# blocks an SM that block_spectra's rows per block aim to leave the card
ROW_FILL = 2
# CUDA blocks an SM that the radix-2 body's source chunks aim at
RADIX2_FILL = 8
# the pruned bodies' block threads (each kernel's aim, below which a block
# takes more pairs of residues)
PRUNED_SPECTRA_THREADS = 512
PRUNED_MIX_THREADS = 256
# one SM of the H100, to count the blocks it holds at once: shared memory
# (228 KB, 1 KB of it reserved per block), threads, registers, blocks
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024
SM_THREADS = 2048
SM_REGISTERS = 65_536
SM_BLOCKS = 32


def max_per_block(threads: int) -> int:
    """Rows (block_spectra) or groups (block_spectra_mix) of ``threads``
    threads one register block holds at most: BLOCK_THREADS' worth."""
    return 1 if threads >= BLOCK_THREADS else BLOCK_THREADS // threads


def min_blocks(threads: int) -> int:
    """Blocks per SM that the register bodies' __launch_bounds__ ask for:
    two of BLOCK_THREADS threads (64 registers a thread), one at 1024."""
    return 1 if threads >= 1024 else 2


@dataclass(frozen=True)
class StepPlan:
    """One launch of `block_spectra` or `block_spectra_mix` at n_fft
    ``n``."""

    n: int
    radices: tuple[int, ...]  # the register passes; () on the radix-2 body
    threads: int  # per row or group (register), per block (radix-2)
    max_per_block: int  # rows or groups per block at most
    blocks_per_sm: int  # that __launch_bounds__ asks for
    unit_f2: int  # shared complex64 per row or group; radix-2: per block
    scratch_f2: int  # complex64 of one scratch slice, split mode
    body: str  # REGISTER or RADIX2 (``ops/_layout.py``)

    def shared_f2(self, per_block: int) -> int:
        """complex64 of shared memory of a block of ``per_block`` rows or
        groups (the radix-2 body: one)."""
        return per_block * self.unit_f2

    def resident_blocks(self, per_block: int) -> int:
        """Blocks of ``per_block`` rows or groups that one SM holds at
        once: its shared memory, threads and registers (the plan's
        __launch_bounds__ cap) and its block limit."""
        threads = per_block * self.threads
        # the registers a thread that __launch_bounds__ leaves: 64
        regs = SM_REGISTERS // (self.blocks_per_sm * self.max_per_block
                                * self.threads)
        return min(SM_SHARED_BYTES // (self.shared_f2(per_block) * 8
                                       + BLOCK_RESERVED_BYTES),
                   SM_THREADS // threads, SM_REGISTERS // (regs * threads),
                   SM_BLOCKS)


@functools.cache
def radix2_plan(n_fft: int, mix: bool) -> StepPlan:
    """The radix-2 body's launch: one row (or (chunk, block)) per CUDA
    block, its twiddles, FFT buffer (and the mix kernel's two ears' sums)
    in shared memory, or in the split mode a scratch slice."""
    F = n_fft // 2 + 1
    acc = 2 * F if mix else 0
    return StepPlan(n_fft, (), RADIX2_THREADS, 1, 1,
                    n_fft // 2 + n_fft + acc, n_fft + acc, RADIX2)


@functools.cache
def step_plan(n_fft: int, mix: bool) -> StepPlan:
    """The kernel's plan (n_fft a power of two of at least 2): the
    register body at MIN_STEP_N … MAX_REGISTER_N, else the radix-2 body."""
    if n_fft < 2 or n_fft & (n_fft - 1):
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least 2")
    if not MIN_STEP_N <= n_fft <= MAX_REGISTER_N:
        return radix2_plan(n_fft, mix)
    threads = n_fft // POINTS
    # one padded exchange buffer per row or group; the mix kernel's
    # accumulators' slices beside it below MAX_REGISTER_N
    unit = n_fft + n_fft // 16
    if mix and n_fft < MAX_REGISTER_N:
        unit += ACC_SLOTS * threads
    return StepPlan(n_fft, inverse_plan(n_fft).radices, threads,
                    max_per_block(threads), min_blocks(threads), unit,
                    radix2_plan(n_fft, mix).scratch_f2, REGISTER)


def spectra_rows(plan: StepPlan, rows: int, sms: int) -> int:
    """G of `block_spectra` over ``rows`` rows on a card of ``sms`` SMs:
    the fewest rows of ROW_THREADS threads, at most the plan's, halved
    while the blocks number fewer than ROW_FILL an SM (not halved with no
    card, sms 0); 1 on the radix-2 body."""
    G = min(plan.max_per_block, max(1, ROW_THREADS // plan.threads))
    while G > 1 and -(-rows // G) < ROW_FILL * sms:
        G //= 2
    return G


def _rounds(plan: StepPlan, chunk: int, groups: int, blocks: int,
            sms: int) -> int:
    """Rounds the busiest group slot of the card runs: the waves of
    ``blocks`` blocks over the blocks the SMs hold at once, times a
    group's share of a chunk's sources plus one for the block's partial
    (its store, and the summing inverse's read of it)."""
    slots = sms * plan.resident_blocks(groups)
    return -(-blocks // slots) * (-(-chunk // groups) + 1)


def mix_groups(plan: StepPlan, chunk: int, blocks: int, sms: int) -> int:
    """Groups per block of `block_spectra_mix` for chunks of ``chunk``
    sources over ``blocks`` CUDA blocks: the power of two, at most the
    plan's and at most the chunk, of the fewest rounds (then the fewest
    groups); 1 on the radix-2 body or with no card (sms 0)."""
    if plan.body != REGISTER or sms <= 0:
        return 1
    best, groups = None, 1
    while groups <= min(chunk, plan.max_per_block):
        key = _rounds(plan, chunk, groups, blocks, sms)
        if best is None or key < best[0]:
            best = (key, groups)
        groups *= 2
    return best[1]


@dataclass(frozen=True)
class PrunedPlan:
    """One launch of the pruned body of `block_spectra` (``mix`` False) or
    `block_spectra_mix` at n_fft ``n`` = P·Q: P transforms of Q points a
    row (a (chunk, block)), `residues` of them a CUDA block of
    `threads`."""

    n: int
    Q: int
    mix: bool
    radices: tuple[int, ...]  # the Q-point register passes
    transform_threads: int  # T = Q/16, one transform's
    pairs: int  # g: pairs of residues a block (Q = 16384: one residue)
    residues: int  # transforms a block: 2g, or 1 at Q = 16384
    threads: int  # a block's: residues · T
    blocks_per_sm: int  # that __launch_bounds__ asks for: 64 registers
    slot_f2: int  # complex64 of one transform's buffer, one float2 past
    shared_acc: bool  # the mix kernel's 18 sums a thread in shared memory
    shared_f2: int  # complex64 of shared memory a block (Q = 16384: with
    # the mirror's kept half, Q/2)
    scratch_f2: int  # the split mode's slice (radix2_plan's)
    body: str  # PRUNED (``ops/_layout.py``)

    @property
    def P(self) -> int:
        return self.n // self.Q

    @property
    def half(self) -> bool:
        """Q = 16384: a block takes one residue."""
        return self.residues == 1

    @property
    def groups(self) -> int:
        """Residue groups (CUDA blocks) a row."""
        return self.P // self.residues

    def block_residues(self, j: int) -> tuple[int, ...]:
        """The residues that residue group j transforms, slot by slot:
        pairs j·g … j·g + g − 1, then their mirrors (pair 0's is P/2); at
        Q = 16384 residue j alone."""
        if self.half:
            return (j,)
        lo = [j * self.pairs + u for u in range(self.pairs)]
        return (*lo, *(self.P - p if p else self.P // 2 for p in lo))

    def resident_blocks(self) -> int:
        """Blocks that one SM holds at once: its shared memory, threads,
        registers (64 a thread) and block limit."""
        return min(SM_SHARED_BYTES // (self.shared_f2 * 8
                                       + BLOCK_RESERVED_BYTES),
                   SM_THREADS // self.threads,
                   SM_REGISTERS // (64 * self.threads), SM_BLOCKS)


def pruned_q(B: int) -> int:
    """Q of a block of B samples: max(next_pow2(B), MIN_STEP_N)."""
    return max(MIN_STEP_N, 1 << max(0, B - 1).bit_length())


@functools.cache
def pruned_plan(n_fft: int, mix: bool, B: int) -> PrunedPlan | None:
    """The pruned body's plan at n_fft above MAX_REGISTER_N for blocks of
    B ≤ n_fft samples; None where it does not apply (n_fft ≤
    MAX_REGISTER_N, or Q above it: the radix-2 body's split mode). The
    figures are ``csrc/block_step.cu`` `pruned::Plan`'s."""
    if n_fft < 2 or n_fft & (n_fft - 1):
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least 2")
    if not 1 <= B <= n_fft:
        raise ValueError(f"B={B} must be 1 … n_fft={n_fft}")
    Q = pruned_q(B)
    if n_fft <= MAX_REGISTER_N or Q > MAX_REGISTER_N:
        return None
    T = Q // POINTS
    half = Q == MAX_REGISTER_N
    aim = PRUNED_MIX_THREADS if mix else PRUNED_SPECTRA_THREADS
    pairs = 1 if half or 2 * T >= aim else aim // (2 * T)
    residues = 1 if half else 2 * pairs
    threads = residues * T
    slot = Q + Q // 16 + 1
    shared_acc = mix and Q < MAX_REGISTER_N // 2
    shared = (residues * slot + (Q // 2 if half else 0)
              + (ACC_SLOTS * threads if shared_acc else 0))
    return PrunedPlan(n_fft, Q, mix, inverse_plan(Q).radices, T, pairs,
                      residues, threads, 1024 // threads, slot, shared_acc,
                      shared, radix2_plan(n_fft, mix).scratch_f2, PRUNED)


def pruned_rounds(plan: PrunedPlan, S: int, nb: int, chunk: int,
                  sms: int, crossfade: bool) -> int:
    """Rounds of transforms the busiest block slot of the card runs for
    the pruned mix over chunks of ``chunk``: the waves of the C·nb·groups
    blocks over the blocks the SMs hold at once, times the chunk's
    transform sets (a source each under crossfade, else two) plus one for
    the block's partial."""
    blocks = -(-S // chunk) * nb * plan.groups
    sets = chunk if crossfade else -(-chunk // 2)
    return -(-blocks // (sms * plan.resident_blocks())) * (sets + 1)


@functools.lru_cache(maxsize=1024)
def mix_launch(S: int, nb: int, n_fft: int, sms: int, B: int,
               crossfade: bool) -> tuple[int, int]:
    """(chunk, groups) of `block_spectra_mix` over S sources × nb blocks
    of B samples on a card of ``sms`` SMs (B and ``crossfade`` matter
    only to the pruned body, above MAX_REGISTER_N). The
    register body: the chunk whose launch (groups by `mix_groups`) runs
    the fewest rounds, then the one of fewest chunks C = ⌈S/chunk⌉. The
    pruned body: likewise by `pruned_rounds` (``crossfade``: a source a
    transform set, else two), its groups the plan's residues a block. The
    radix-2 body: the fewest chunks whose grid of C·nb blocks gives every
    SM RADIX2_FILL, at most S, the sources spread evenly over them. With
    no card (sms 0): one chunk of all S sources, one group."""
    pruned = pruned_plan(n_fft, True, B)
    plan = step_plan(n_fft, True)
    if sms <= 0:
        return S, 1
    if pruned is not None:
        best = None
        for C in range(1, S + 1):
            chunk = -(-S // C)
            if -(-S // chunk) != C:
                continue
            key = pruned_rounds(pruned, S, nb, chunk, sms, crossfade)
            if best is None or key < best[0]:
                best = (key, chunk)
        return best[1], pruned.residues
    if plan.body != REGISTER:
        chunks = min(S, max(1, -(-RADIX2_FILL * sms // nb)))
        return -(-S // chunks), 1
    best = None
    for C in range(1, S + 1):
        chunk = -(-S // C)
        if -(-S // chunk) != C:
            continue  # the same chunk as a smaller C
        groups = mix_groups(plan, chunk, C * nb, sms)
        key = _rounds(plan, chunk, groups, C * nb, sms)
        if best is None or key < best[0]:
            best = (key, chunk, groups)
    return best[1], best[2]

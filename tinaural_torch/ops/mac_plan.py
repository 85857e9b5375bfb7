"""Launch plan and ramp table of kernel `assembly_mac`'s register design.

`assembly_mac` (``csrc/assembly_mac.cu``; wrapper
`assembly_mac.assembly_mac_cuda`) runs three transforms per row in one CUDA
block: rfft_L of the gathered filter pair, irfft_L after the delay ramp and
the gain, and rfft_n of the truncated result. Each is the register FFT of
``csrc/fft_reg.cuh``, 16 points per thread in passes of radix 16 with a
smaller last radix, the forward ones as the conjugate of the inverse. The
block has ``threads = n/16`` threads; the L-point transforms run on its
first L/16. The twiddles come from `spectra_inverse.twiddles` at L and at
n, the ramp's taper from `ramp_taper`.

`mac_plan` is the launch as the kernel computes it at compile time. The
wrapper hands the CUDA entry point the plan's threads and blocks per SM,
and the entry point refuses any plan other than the one it was compiled
for. The wrapper passes the plan's shared-memory figure to
``ops/_layout.py``, which picks the buffer mode. Above `MAX_REGISTER_N` the
kernel runs the split buffer mode of ``csrc/common.cuh``: radix-2 passes
over a device scratch, `SPLIT_THREADS` threads per block. The plan
describes that launch, and its shared figure is the full radix-2 layout,
which no card's shared memory holds, so the layout picks the split mode.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ..data.table import DELAY_PAD, TAPER_HI, TAPER_LO
from .filters import next_pow2
from .spectra_inverse import MAX_REGISTER_N, inverse_plan

POINTS = 16  # values per thread in each register transform
# threads' worth of blocks that __launch_bounds__ asks to fit one SM
SM_THREADS = 768
MAX_BLOCKS_PER_SM = 16  # whose shared memory fits the SM at any n
# complex64 of H_prev a thread carries from row to row: 9 bins, 2 ears
CARRY_SLOTS = 18
# threads per block of the split mode's radix-2 kernel
SPLIT_THREADS = 1024


@dataclass(frozen=True)
class MacPlan:
    """One launch of `assembly_mac` for ``taps``-tap filters at n_fft
    ``n``."""

    taps: int
    n: int
    L: int  # the assembly's transform size, next_pow2(t_pad)
    t_pad: int  # taps + DELAY_PAD: the samples kept after irfft_L
    radices_L: tuple[int, ...]  # the L-point passes, first to last
    radices_n: tuple[int, ...]  # the n-point passes
    threads: int  # per block
    blocks_per_sm: int  # that __launch_bounds__ asks for
    shared_f2: int  # complex64 of shared memory per block, shared mode
    scratch_f2: int  # complex64 of one scratch slice, split mode

    @property
    def register(self) -> bool:
        return self.n <= MAX_REGISTER_N


@functools.cache
def mac_plan(taps: int, n_fft: int) -> MacPlan:
    """The kernel's plan (n_fft a power of two of at least taps +
    DELAY_PAD)."""
    t_pad = taps + DELAY_PAD
    if taps < 1 or n_fft & (n_fft - 1) or n_fft < t_pad:
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least "
                         f"taps + {DELAY_PAD} = {t_pad}")
    L = next_pow2(t_pad)
    scratch = n_fft + 2 * L + 4 * (n_fft // 2 + 1)
    if n_fft > MAX_REGISTER_N:
        log2 = lambda m: m.bit_length() - 1
        return MacPlan(taps, n_fft, L, t_pad, (2,) * log2(L),
                       (2,) * log2(n_fft), SPLIT_THREADS, 1,
                       n_fft // 2 + scratch, scratch)
    threads = n_fft // POINTS
    blocks = 1 if threads >= SM_THREADS else min(MAX_BLOCKS_PER_SM,
                                                 SM_THREADS // threads)
    # one exchange buffer: n + n/16 complex64 (one float2 of padding after
    # every 16, see csrc/fft_reg.cuh), and each thread's carried H_prev
    # beside it where both fit
    carry = CARRY_SLOTS * threads if n_fft < MAX_REGISTER_N else 0
    return MacPlan(taps, n_fft, L, t_pad, inverse_plan(L).radices,
                   inverse_plan(n_fft).radices, threads, blocks,
                   n_fft + n_fft // 16 + carry, scratch)


_TAPERS: dict[tuple[torch.device, int], torch.Tensor] = {}


def ramp_taper(L: int, device: torch.device) -> torch.Tensor:
    """The delay ramp's taper w at the bins 0 … L/2 of an L-point rfft, as
    `filters.delay_ramp` computes it, in float64 rounded once to float32:
    1 up to fnorm = TAPER_LO, a half cosine down to 0 at TAPER_HI. Built
    once per (device, L) and kept."""
    key = (device, L)
    table = _TAPERS.get(key)
    if table is None:
        fnorm = torch.arange(L // 2 + 1, dtype=torch.float64) / L
        t = torch.clamp((fnorm - TAPER_LO) / (TAPER_HI - TAPER_LO), 0.0, 1.0)
        table = (0.5 * (1.0 + torch.cos(math.pi * t))).to(torch.float32).to(
            device)
        _TAPERS[key] = table
    return table

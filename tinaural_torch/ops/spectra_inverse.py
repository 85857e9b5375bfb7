"""Launch plan and twiddle table of kernel `spectra_inverse`'s register FFT.

`spectra_inverse` (``csrc/spectra_inverse.cu``; wrapper
`block_step.spectra_inverse_cuda`) inverts both ears' half spectra of a
row as one packed complex n-point FFT held in registers. A row's
``threads`` threads keep ``points`` values each and run the plan's
``radices`` as passes of in-register butterflies, radix 16 with a smaller
last radix where n is not a power of 16. Between two passes the values go
through one exchange in shared memory and one barrier. The exchange
follows Stockham's order, so the output lands in natural order with no
bit reversal; ``csrc/fft_reg.cuh`` spells out the index maps. The twiddles
between passes come from `twiddles`, a table built once per (device, n).

`inverse_plan` is the kernel's shape as ``csrc/fft_reg.cuh`` `RegPlan`
computes it at compile time. The wrapper hands the CUDA entry point the
plan's rows per block and points per thread, and the entry point refuses
any plan other than the one it was compiled for. The wrapper passes the
plan's shared-memory figure to ``ops/_layout.py``, which picks the buffer
mode.

Above `MAX_REGISTER_N` a row's exchange buffer outgrows one block's shared
memory. Up to `MAX_CLUSTER_N` the row then spreads over a thread-block
cluster of ``ranks = n / MAX_REGISTER_N`` blocks of `CLUSTER_THREADS`
threads, 16 points each (the cluster mode; ``csrc/fft_reg.cuh``
`ClusterPlan`): a first pass of radix ``ranks`` runs in registers and
crosses the cluster once through its distributed shared memory, and each
block then runs the 16384-point register transform on its share, so the
plan's radices are ``(ranks,)`` and the 16384-point plan's. Each block
holds the padded exchange buffer of one 16384-point row, so the plan's
shared figure is one block's. Above `MAX_CLUSTER_N` the plan has the
`RADIX2` body, 256 threads per row, whose shared figure no card holds, so
``ops/_layout.py`` always splits it.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ._layout import CLUSTER, RADIX2, REGISTER

MAX_RADIX = 16
# the largest n whose exchange buffer (n + n/16 complex64 per row) fits one
# block's shared memory on the H100 (227 KB): 139,264 bytes at 2^14
MAX_REGISTER_N = 1 << 14
# the largest n of the cluster mode: 8 blocks, the portable cluster size
MAX_CLUSTER_N = 1 << 17
# threads per block of the cluster mode
CLUSTER_THREADS = 1024
# threads per CUDA block that small transforms fill with rows
BLOCK_THREADS = 256
# threads per row of the split mode's radix-2 kernel
SPLIT_THREADS = 256


@dataclass(frozen=True)
class InversePlan:
    """One launch of `spectra_inverse` for n = ``n``-point rows."""

    n: int
    radices: tuple[int, ...]  # one per pass, first to last; product n
    points: int  # values per thread
    threads: int  # per row and block: n / (points · ranks)
    rows_per_block: int
    shared_f2: int  # complex64 of shared memory per block, shared mode
    body: str  # REGISTER, CLUSTER or RADIX2 (``ops/_layout.py``)
    ranks: int = 1  # blocks per row: a thread-block cluster where > 1


@functools.cache
def inverse_plan(n_fft: int) -> InversePlan:
    """The kernel's plan for an n_fft-point inverse (a power of two ≥ 2)."""
    if n_fft < 2 or n_fft & (n_fft - 1):
        raise ValueError(f"n_fft={n_fft} must be a power of two of at least 2")
    log2n = n_fft.bit_length() - 1
    if n_fft > MAX_CLUSTER_N:
        return InversePlan(n_fft, (2,) * log2n, n_fft // SPLIT_THREADS,
                           SPLIT_THREADS, 1, n_fft // 2 + n_fft, RADIX2)
    passes = -(-log2n // 4)
    radices = (MAX_RADIX,) * (passes - 1) + (n_fft >> 4 * (passes - 1),)
    if n_fft > MAX_REGISTER_N:
        # the radix-C step, then each block's 16384-point transform
        local = inverse_plan(MAX_REGISTER_N)
        ranks = n_fft // MAX_REGISTER_N
        return InversePlan(n_fft, (ranks, *local.radices), MAX_RADIX,
                           CLUSTER_THREADS, 1, local.shared_f2, CLUSTER,
                           ranks)
    points = min(n_fft, MAX_RADIX)
    threads = n_fft // points
    rows = max(1, BLOCK_THREADS // threads)
    # one float2 of padding after every 16 keeps the first pass's
    # stride-16 stores on distinct banks
    row_f2 = n_fft + n_fft // 16 if passes > 1 else 0
    return InversePlan(n_fft, radices, points, threads, rows, rows * row_f2,
                       REGISTER)


_TWIDDLES: dict[tuple[torch.device, int], torch.Tensor] = {}


def twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(+2πi·m/n) for m < n as complex64 on ``device``: the inverse
    FFT's twiddles, computed in float64 and rounded once. Built once per
    (device, n) and kept."""
    key = (device, n)
    table = _TWIDDLES.get(key)
    if table is None:
        angle = torch.arange(n, dtype=torch.float64) * (2.0 * math.pi / n)
        table = torch.polar(torch.ones_like(angle), angle).to(
            torch.complex64).to(device)
        _TWIDDLES[key] = table
    return table

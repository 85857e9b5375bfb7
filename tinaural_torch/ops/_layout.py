"""Where a kernel keeps its FFT buffers: shared memory, a thread-block
cluster's shared memory, or a device scratch.

Every kernel of ``csrc/`` holds its twiddles and FFT buffers in shared
memory when they fit the card's limit for one block (227 KB on the H100).
Two kernels have a cluster mode above that: `spectra_inverse` at n_fft
32768 … 131072 and `assemble_partitions` at L 16384 … 131072 spread each
row over a thread-block cluster whose blocks hold a share of its buffers
each (``csrc/fft_reg.cuh`` `ClusterPlan`). Their plans give one block's
share as the shared figure, so the shared-mode test below takes them too,
and the kernel's entry point picks the cluster kernel from the sizes.
Above it the kernels run with their buffers in a device-memory scratch,
one slice per CUDA block, the blocks walking the rows in a grid-stride loop
and each n-point FFT split into two passes of at most `SPLIT_WORK` points
in shared memory (``csrc/common.cuh``, `fft_run`): the split mode. The mode
is chosen here from the shapes, before the launch; a launch that fails
raises in every mode, and none gives way to another.
"""

from __future__ import annotations

import functools

import torch

# Points (complex64) of shared memory per pass of a split FFT, so a split
# transform takes up to SPLIT_WORK² points.
SPLIT_WORK = 4096
# Most scratch one launch allocates; the grid shrinks to fit it.
SCRATCH_BYTES = 1 << 28
# Static shared memory a kernel may declare beside its dynamic buffers.
_STATIC_SMEM = 1024

# Tests set this to a small power of two to force the split mode with that
# work size at any shape, the cluster mode's included; 0 picks the mode
# from the shapes.
force_work = 0


@functools.cache
def max_shared_bytes(index: int) -> int:
    """The opt-in shared memory of one block on CUDA device ``index``."""
    from . import _build

    v = _build.library().tt_max_shared_bytes(index)
    if v <= 0:
        raise RuntimeError(f"cannot read the shared-memory limit of cuda:{index}")
    return v


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device; 0 for any other
    device, whose route rules then take the plain shape-only choices."""
    if device.type != "cuda":
        return 0
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def split_work(shared_f2: int, largest_fft: int, limit: int) -> int:
    """0 when ``shared_f2`` complex64 values of shared memory fit ``limit``
    bytes, else the split passes' work size. Raises for an FFT beyond what
    two passes take."""
    work = force_work or (SPLIT_WORK if shared_f2 * 8 + _STATIC_SMEM > limit
                          else 0)
    if work and largest_fft > work * work:
        raise ValueError(f"an FFT of {largest_fft} points exceeds the "
                         f"{work * work} that two split passes take")
    return work


def layout(device: torch.device, shared_f2: int, scratch_f2: int, rows: int,
           largest_fft: int) -> tuple[int, int, int, torch.Tensor | None]:
    """A launch's buffer mode → (scratch pointer or 0, slices, work,
    scratch tensor to keep alive). ``shared_f2``: complex64 values of
    shared memory in the shared mode; ``scratch_f2``: of one scratch slice
    in the split mode; ``rows``: the kernel's rows."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    work = split_work(shared_f2, largest_fft, max_shared_bytes(index))
    if not work:
        return 0, 0, 0, None
    slices = max(1, min(rows, SCRATCH_BYTES // (scratch_f2 * 8)))
    scratch = torch.empty(slices * scratch_f2, dtype=torch.complex64,
                          device=device)
    return scratch.data_ptr(), slices, work, scratch

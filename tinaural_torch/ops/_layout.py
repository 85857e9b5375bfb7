"""How a kernel launches: the FFT body it runs, and where its buffers live.

Each kernel's plan states its body in its ``body`` field: `REGISTER`
(register FFTs, buffers in one block's shared memory), `CLUSTER` (each
row, run of rows or output block spread over a thread-block cluster whose
blocks hold a share of its buffers each, ``csrc/fft_reg.cuh``
`ClusterPlan`: `spectra_inverse`, `block_spectra_mix_inverse`,
`assemble_partitions`, `assembly_mac` and `assemble_filters` above n_fft
or L 16384), `PRUNED` (the block step's n/Q transforms of Q ≤ 16384
points above n_fft 16384, ``ops/step_plan.py``), `DIRECT`
(`assemble_partitions` where neither ITD nor ILD applies: each partition's
register transform straight from the table rows, no L-point chain,
``ops/partitions_plan.py``) or `RADIX2`. A plan's
shared figure is one block's. `launch_mode`, THE launch-mode rule, runs
the body where that figure fits the card's limit for one block (227 KB on
the H100) and `force_work` is 0; else the split mode, `SPLIT`: the
buffers in a device-memory scratch, one slice per CUDA block, the blocks
walking the rows in a grid-stride loop, each n-point FFT in two passes of
at most `SPLIT_WORK` points in shared memory (``csrc/common.cuh``,
`fft_run`). `layout` hands a wrapper the mode and the split mode's scratch
as one `Launch`. Runs of rows of the cluster mode come from the clusters
the card places at once (`cluster_slots`, `run_length`). A launch that
fails raises in every mode, and none gives way to another. The wrappers'
common input checks (`check_inputs`, `cuda_inputs`) live here too.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..data.table import DELAY_PAD, TorchTable

# Points (complex64) of shared memory per pass of a split FFT, so a split
# transform takes up to SPLIT_WORK² points.
SPLIT_WORK = 4096
# Most scratch one launch allocates; the grid shrinks to fit it.
SCRATCH_BYTES = 1 << 28
# Static shared memory a kernel may declare beside its dynamic buffers.
_STATIC_SMEM = 1024
# Every run of rows takes about the same time, so runs are as long as leave
# RUN_WAVES runs for each block (cluster) the card holds at once.
RUN_WAVES = 1

# The FFT bodies a plan states (its ``body``), each of which a launch runs
# with its buffers in shared memory, and the split mode: the radix-2 body
# over a device scratch.
REGISTER, CLUSTER, PRUNED, DIRECT, RADIX2, SPLIT = (
    "register", "cluster", "pruned", "direct", "radix2", "split")

# Tests set this to a small power of two to force the split mode with that
# work size at any shape, the cluster mode's included; 0 picks the mode
# from the shapes.
force_work = 0


def _index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


@functools.cache
def _shared_limit(index: int) -> int:
    from . import _build

    v = _build.library().tt_max_shared_bytes(index)
    if v <= 0:
        raise RuntimeError("cannot read the shared-memory limit of "
                           f"cuda:{index}")
    return v


def shared_limit(device: torch.device) -> int:
    """The opt-in shared memory of one block on a CUDA device, in bytes:
    read once per device."""
    return _shared_limit(_index(device))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device; 0 for any other
    device, whose route rules then take the plain shape-only choices."""
    return _sm_count(_index(device)) if device.type == "cuda" else 0


@functools.cache
def _cluster_slots(index: int, entry: str, n_fft: int) -> int:
    from . import _build

    with torch.cuda.device(index):
        v = getattr(_build.library(), entry)(n_fft)
    if v <= 0:
        raise RuntimeError(f"cuda:{index} runs no cluster of {entry} at "
                           f"n_fft={n_fft} (code {v})")
    return v


def cluster_slots(device: torch.device, entry: str, n_fft: int) -> int:
    """The clusters of a kernel's cluster mode at ``n_fft`` that the CUDA
    device runs at once (``cudaOccupancyMaxActiveClusters``, read by the C
    entry point ``entry``): read once per device, kernel and size, with no
    host sync. Raises where it runs none."""
    return _cluster_slots(_index(device), entry, n_fft)


def run_length(rows: int, slots: int) -> int:
    """Rows per CUDA block (per cluster in the cluster mode) of a kernel
    that walks runs of rows when ``slots`` of them run at once (the SMs
    times the plan's blocks per SM, or the clusters the card runs at
    once): the shortest run that needs no more than RUN_WAVES · slots
    runs."""
    return -(-rows // (RUN_WAVES * max(slots, 1)))


def launch_mode(body: str, shared_f2: int, largest_fft: int,
                limit: int) -> tuple[str, int]:
    """THE launch-mode rule → (mode, work): (``body``, 0) where
    ``shared_f2`` complex64 values of shared memory fit ``limit`` bytes
    and `force_work` is 0; else (SPLIT, the split passes' work size).
    Raises for an FFT beyond what two passes take."""
    work = force_work or (SPLIT_WORK if shared_f2 * 8 + _STATIC_SMEM > limit
                          else 0)
    if not work:
        return body, 0
    if largest_fft > work * work:
        raise ValueError(f"an FFT of {largest_fft} points exceeds the "
                         f"{work * work} that two split passes take")
    return SPLIT, work


class Launch(NamedTuple):
    """A launch's mode, and in the split mode its scratch pointer, slices,
    work size and the scratch tensor to keep alive."""

    mode: str
    scratch: int = 0
    slices: int = 0
    work: int = 0
    keep: torch.Tensor | None = None

    @property
    def split_args(self) -> tuple[int, int, int]:
        """The C entry points' last buffer arguments: scratch, slices,
        work (all 0 outside the split mode)."""
        return self.scratch, self.slices, self.work


def layout(device: torch.device, body: str, shared_f2: int, scratch_f2: int,
           rows: int, largest_fft: int) -> Launch:
    """A launch of a plan's ``body`` on a CUDA device (`launch_mode` at
    the device's limit). ``shared_f2``: complex64 values of shared memory
    in the shared mode; ``scratch_f2``: of one scratch slice in the split
    mode; ``rows``: the kernel's rows."""
    mode, work = launch_mode(body, shared_f2, largest_fft,
                             shared_limit(device))
    if mode != SPLIT:
        return Launch(mode)
    slices = max(1, min(rows, SCRATCH_BYTES // (scratch_f2 * 8)))
    scratch = torch.empty(slices * scratch_f2, dtype=torch.complex64,
                          device=device)
    return Launch(mode, scratch.data_ptr(), slices, work, scratch)


def filter_rows(nb: int, dir_rate: int) -> int:
    """Filter rows per source of ``nb`` blocks at ``dir_rate`` blocks a
    filter: ⌈nb/dir_rate⌉."""
    if dir_rate < 1:
        raise ValueError(f"dir_rate={dir_rate} must be at least 1")
    return -(-nb // dir_rate)


def check_inputs(xbs, idx, w, table: TorchTable, n_fft: int,
                 dir_rate: int) -> None:
    """Shapes, types and devices of a block render's inputs: idx and w
    hold ⌈nb/dir_rate⌉ rows per source."""
    if xbs.dim() != 3:
        raise ValueError(f"xbs must be (S, nb, B), got {tuple(xbs.shape)}")
    S, nb, B = xbs.shape
    want = (S, filter_rows(nb, dir_rate), 4)
    for name, t in (("idx", idx), ("w", w)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want} at dir_rate={dir_rate}, "
                             f"got {tuple(t.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if (n_fft & (n_fft - 1) or n_fft % B
            or n_fft < B + table.taps + DELAY_PAD - 1):
        raise ValueError(
            f"n_fft={n_fft} must be a power of two, a multiple of B={B} and "
            f"at least B + taps + {DELAY_PAD} - 1")
    devs = {t.device
            for t in (xbs, idx, w, table.h, table.delays, table.gains)}
    if len(devs) != 1:
        raise ValueError(f"inputs and table lie on different devices: {devs}")


def cuda_inputs(*tensors: torch.Tensor) -> int:
    """Check that kernel inputs are contiguous float32/int32 CUDA tensors
    on one device; → the stream handle to launch on."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("kernel inputs must lie on one CUDA device, "
                             f"got {t.device}")
        if t.dtype not in (torch.float32, torch.int32, torch.complex64):
            raise TypeError("kernel inputs are float32/int32/complex64, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return torch.cuda.current_stream(dev).cuda_stream

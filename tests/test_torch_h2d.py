"""`BinauralRenderer._to_device` on a card: the host array goes through
page-locked memory from torch's caching host allocator and is sent without
a host wait. The blocks `_blockify` frames from it equal in bits those of
a pageable copy (one source or several, a ragged tail, inputs that are not
C-contiguous); each offline entry point's output is unchanged when the
caller overwrites its arrays as soon as the call returns, and when two
calls of different inputs come back to back with no sync between them
(the card held busy by a spin first, so that every copy to it is still
queued when the host moves on); 20 calls after warm-up allocate no
page-locked memory; and every byte counted in ``h2d_bytes`` is counted in
``h2d_pinned_bytes`` too.

This file imports neither the JAX package nor the shared conftest:

    python -m pytest tests/test_torch_h2d.py --noconftest -m gpu -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

import tinaural_torch as tt
from tinaural_torch.utils import profiling

B, NB, S = 1024, 48, 4
SPIN_CYCLES = 20_000_000  # ~10 ms of the card's clock, ahead of each call
ENTRIES = ("render_trajectory", "render_scene", "render_batch", "render",
           "render_short", "render_streamed")


@pytest.fixture(scope="module")
def renderer():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    table = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"),
                                          torch.device("cuda"))
    return tt.BinauralRenderer(table, tt.RenderConfig(block_size=B))


def _args(entry: str, seed: int) -> tuple:
    """Fresh host arrays (and angles) for one call of ``entry``."""
    rng = np.random.default_rng(seed)

    def track(n):
        return np.stack([rng.uniform(0, 360, n), rng.uniform(-40, 90, n)],
                        -1).astype(np.float32)

    if entry == "render_trajectory":
        return rng.standard_normal(NB * B - 37).astype(np.float32), track(NB)
    if entry in ("render_scene", "render_batch"):
        return (rng.standard_normal((S, NB * B)).astype(np.float32),
                np.stack([track(NB) for _ in range(S)]))
    if entry == "render_streamed":
        n = NB * B // 256
        return rng.standard_normal(n * 256).astype(np.float32), track(n)
    n = NB * B if entry == "render" else 3 * B  # the block or direct route
    return (rng.standard_normal(n).astype(np.float32),
            float(rng.uniform(0, 360)), float(rng.uniform(-40, 90)))


def _call(renderer, entry: str, args: tuple) -> torch.Tensor:
    name = "render" if entry == "render_short" else entry
    return getattr(renderer, name)(*args)


def _copies(args: tuple) -> tuple:
    return tuple(a.copy() if isinstance(a, np.ndarray) else a for a in args)


def _overwrite(args: tuple) -> None:
    for a in args:
        if isinstance(a, np.ndarray):
            a[...] = np.float32(np.nan)


def _alone(renderer, entry: str, args: tuple) -> torch.Tensor:
    y = _call(renderer, entry, _copies(args))
    torch.cuda.synchronize()
    return y


def _signal(shape, layout: str) -> np.ndarray:
    rng = np.random.default_rng(25)
    wide = (*shape[:-1], 2 * shape[-1]) if layout == "strided" else shape
    x = rng.standard_normal(wide, dtype=np.float32)
    if layout == "strided":
        x = x[..., ::2]
    elif layout == "reversed":
        x = x[..., ::-1]
    elif layout == "fortran":
        x = np.asfortranarray(x)
    assert x.flags.c_contiguous == (layout == "contiguous")
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("shape,layout", [
    (shape, layout)
    for shape in [(NB * B,), (NB * B - 37,), (S, NB * B), (S, NB * B - 5)]
    for layout in ["contiguous", "strided", "reversed"]
    + ["fortran"] * (len(shape) == 2)])
def test_blocks_equal_the_pageable_copy(renderer, shape, layout):
    """`_blockify`'s blocks on the card equal in bits the pageable copy
    ``torch.from_numpy(x).to(dev)`` framed the same way."""
    x = _signal(shape, layout)
    xb, N = renderer._blockify(x)
    nb = -(-N // B)
    whole = torch.from_numpy(np.ascontiguousarray(x)).to(renderer.device)
    want = torch.nn.functional.pad(whole, (0, nb * B - N))
    assert torch.equal(xb, want.reshape(*x.shape[:-1], nb, B))


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ENTRIES)
def test_caller_may_overwrite_its_arrays_at_once(renderer, entry):
    args = _args(entry, 1)
    want = _alone(renderer, entry, args)
    torch.cuda._sleep(SPIN_CYCLES)
    got = _call(renderer, entry, args)
    _overwrite(args)  # before any sync: the copies are the program's
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ENTRIES)
def test_back_to_back_calls_each_equal_their_render_alone(renderer, entry):
    first, second = _args(entry, 2), _args(entry, 3)
    want = [_alone(renderer, entry, first), _alone(renderer, entry, second)]
    torch.cuda._sleep(SPIN_CYCLES)
    got = [_call(renderer, entry, first), _call(renderer, entry, second)]
    _overwrite(first)
    _overwrite(second)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["render_trajectory", "render_scene",
                                   "render_batch"])
def test_steady_calls_allocate_no_pinned_memory(renderer, entry):
    """After warm-up, 20 calls back to back, no sync between them, leave
    torch's page-locked host memory as it was: the blocks are reused."""
    inputs = [_args(entry, 4), _args(entry, 5)]
    for args in inputs:
        _call(renderer, entry, args)
    torch.cuda.synchronize()
    before = torch.cuda.host_memory_stats()
    for i in range(20):
        _call(renderer, entry, inputs[i % 2])
    torch.cuda.synchronize()
    after = torch.cuda.host_memory_stats()
    for key in ("num_host_alloc", "allocated_bytes.current"):
        assert after[key] == before[key], key


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ENTRIES)
def test_every_copied_byte_takes_the_pinned_path(renderer, entry):
    args = _args(entry, 6)
    before = profiling.counters()
    _call(renderer, entry, args)
    after = profiling.counters()
    copied = after["h2d_bytes"] - before.get("h2d_bytes", 0)
    assert copied >= sum(a.nbytes for a in args if isinstance(a, np.ndarray))
    assert after["h2d_pinned_bytes"] - before.get("h2d_pinned_bytes", 0) \
        == copied

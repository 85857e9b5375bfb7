"""`BinauralRenderer._blockify` frames a host signal on the device: its
blocks equal in bits the host-padded blocks ``np.pad(x, …).reshape(…, nb,
B)`` for every N, one source or several, float32 or float64, contiguous or
a reversed view; the caller's array is never written, nor aliased by the
CPU blocks; and the entry points render a signal of any N as they render
it padded by hand to whole blocks."""

import numpy as np
import pytest
import torch

import tinaural_torch as tt

torch.set_num_threads(1)

B, NB, S = 256, 6, 3


@pytest.fixture(scope="module")
def renderer():
    t = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), "cpu")
    return tt.BinauralRenderer(t, tt.RenderConfig(block_size=B))


def _host_blocks(x):
    x = np.asarray(x, np.float32)
    N = x.shape[-1]
    nb = -(-N // B)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, nb * B - N)]
    return np.pad(x, pad).reshape(*x.shape[:-1], nb, B)


def _signal(shape, dtype, layout):
    x = np.random.default_rng(23).standard_normal(shape).astype(dtype)
    if layout == "reversed":
        x = x[..., ::-1]
        assert not x.flags.c_contiguous
    return x


@pytest.mark.parametrize("lead", [(), (S,)], ids=["one", "several"])
@pytest.mark.parametrize("N", [NB * B, NB * B - 37, 3, B], ids=str)
@pytest.mark.parametrize("dtype,layout", [(np.float32, "contiguous"),
                                          (np.float64, "contiguous"),
                                          (np.float32, "reversed")])
def test_blocks_equal_the_host_padded_blocks(renderer, lead, N, dtype,
                                             layout):
    x = _signal((*lead, N), dtype, layout)
    kept = x.copy()
    xb, got_n = renderer._blockify(x)
    want = _host_blocks(x)
    assert got_n == N and xb.dtype == torch.float32
    assert xb.shape == want.shape and xb.is_contiguous()
    assert np.array_equal(xb.numpy(), want)
    xb.add_(1.0)  # the blocks are the program's own memory
    assert np.array_equal(x, kept)


def _tracks(rng, S_, nb):
    return np.stack([rng.uniform(0, 360, (S_, nb)),
                     rng.uniform(-40, 90, (S_, nb))], -1).astype(np.float32)


def _calls(renderer, N):
    """{entry point: (its call on a signal of N samples, that signal)}."""
    rng = np.random.default_rng(N)
    nb = -(-N // B)
    x = rng.standard_normal(N).astype(np.float32)
    xs = rng.standard_normal((S, N)).astype(np.float32)
    dirs = _tracks(rng, S, nb)  # three distinct tracks: no dedupe
    return {
        "render_trajectory": (lambda s: renderer.render_trajectory(
            s, dirs[0]), x),
        "render_scene": (lambda s: renderer.render_scene(s, dirs), xs),
        "render_batch": (lambda s: renderer.render_batch(s, dirs), xs),
    }


@pytest.mark.parametrize("entry", ["render_trajectory", "render_scene",
                                   "render_batch"])
@pytest.mark.parametrize("N", [NB * B, NB * B - 37], ids=str)
def test_entry_points_leave_the_callers_array_unchanged(renderer, entry, N):
    call, x = _calls(renderer, N)[entry]
    kept = x.copy()
    y = call(x)
    assert np.isfinite(y.numpy()).all()
    assert x.tobytes() == kept.tobytes()


@pytest.mark.parametrize("entry", ["render_trajectory", "render_scene"])
def test_any_length_renders_as_padded_by_hand(renderer, entry):
    N = NB * B - 37
    call, x = _calls(renderer, N)[entry]
    y = call(x)
    y_padded = call(_host_blocks(x).reshape(*x.shape[:-1], NB * B))
    assert y.shape[-1] == renderer._out_len(N)
    assert torch.equal(y, y_padded[..., : y.shape[-1]])

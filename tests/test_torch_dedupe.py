"""`render_scene`'s host dedupe, `_dedupe_sources`: the port's grouping by
the key rows' bytes, with its loop premix, held to the JAX package's
`np.unique(axis=0)` and `np.add.at` in bits.

Each case builds a scene of S sources whose tracks are shared by some
pattern and runs both packages' `_dedupe_sources` on the same arrays. Where
the JAX package returns the scene untouched the port must return the very
objects it was given; elsewhere ``xs'`` and ``dirs'`` must equal the JAX
package's in value and dtype (NaN equal to NaN). The counter
``dedupe_rows_merged`` counts S less the bucketed count only where the
premix runs."""

import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from tinaural.models import renderer as jrd
from tinaural_torch.models import renderer as rd
from tinaural_torch.utils import profiling

torch.set_num_threads(1)

NB, N = 128, 4096  # the scene cell's 128 blocks a track; xs's length is free


def _tracks(rng, n: int, nb: int = NB) -> np.ndarray:
    """n distinct moving tracks (n, nb, 2): each its own sweep."""
    t = np.linspace(0.0, 1.0, nb)
    az = (rng.uniform(0, 360, (n, 1))
          + rng.uniform(18, 180, (n, 1)) * t) % 360
    el = rng.uniform(-40, 90, (n, 1)) + rng.uniform(-10, 10, (n, 1)) * t
    return np.stack([az, el], -1).astype(np.float32)


def _shared(rng, n_tracks: int, ways: int) -> np.ndarray:
    """n_tracks tracks, each given to ``ways`` sources, in shuffled order."""
    return _tracks(rng, n_tracks)[rng.permutation(np.repeat(
        np.arange(n_tracks), ways))]


def _scene(case: str):
    """(dirs, dir_rate) of one case; S is dirs' first axis."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "distinct":
        return _tracks(rng, 16), 1
    if case == "shared2":
        return _shared(rng, 8, 2), 1
    if case == "shared3":
        return _shared(rng, 8, 3), 1
    if case == "shared8_64":  # a choir: 64 sources on 8 tracks
        return _shared(rng, 8, 8), 1
    if case == "static_shared":
        return _shared(rng, 4, 4)[:, 0], 1
    if case == "static_distinct":
        return _tracks(rng, 16)[:, 0], 1
    if case == "snapped_merge":  # equal only after snapping by 4
        dirs = _shared(rng, 4, 4)
        inside = np.arange(NB) % 4 != 0
        dirs[:, inside] += rng.uniform(0.5, 5.0, dirs[:, inside].shape)
        return dirs.astype(np.float32), 4
    if case == "late_differ":  # equal first blocks, a later block apart
        dirs = _shared(rng, 8, 4)
        dirs[:2, NB - 3:] += 1.0
        return dirs, 1
    if case == "negative_zero":
        dirs = _shared(rng, 4, 4)
        dirs[..., 0] = 0.0
        dirs[::2, ::3, 0] = -0.0
        return dirs, 1
    if case == "nan":
        dirs = _shared(rng, 8, 2)
        dirs[dirs[:, 0, 0] == dirs[0, 0, 0], 5, 1] = np.nan
        return dirs, 1
    if case == "static_negative_zero_nan":
        dirs = np.zeros((12, 2), np.float32)
        dirs[::2] = -0.0
        dirs[8:, 0] = np.nan
        dirs[10:, 1] = 45.0
        return dirs, 1
    if case == "bucket_edge":  # 9 tracks of 16: 8 merge, 9 bucket to 16
        return _tracks(rng, 9)[np.r_[np.arange(9), np.arange(7)]], 1
    if case == "bucket_edge_plus_one":  # 9 tracks of 17: 16 < 17
        return _tracks(rng, 9)[np.r_[np.arange(9), np.arange(8)]], 1
    raise ValueError(case)


CASES = ("distinct", "shared2", "shared3", "shared8_64", "static_shared",
         "static_distinct", "snapped_merge", "late_differ", "negative_zero",
         "nan", "static_negative_zero_nan", "bucket_edge",
         "bucket_edge_plus_one")


def _run(case: str, chunk: int):
    dirs, k = _scene(case)
    S = dirs.shape[0]
    xs = np.random.default_rng(S).standard_normal((S, N)).astype(np.float32)
    port = rd._dedupe_sources(
        xs, dirs, tinaural_torch.RenderConfig(dir_rate=k, scene_chunk=chunk))
    ref = jrd._dedupe_sources(
        xs, dirs, tinaural.RenderConfig(dir_rate=k, scene_chunk=chunk))
    return xs, dirs, port, ref


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("case", CASES)
def test_dedupe_matches_the_jax_package_in_bits(case, chunk):
    xs, dirs, (xs_p, dirs_p), (xs_r, dirs_r) = _run(case, chunk)
    if xs_r is xs:
        assert dirs_r is dirs
        assert xs_p is xs and dirs_p is dirs
        return
    assert xs_p.shape[0] < xs.shape[0]
    assert xs_p.dtype == xs_r.dtype and dirs_p.dtype == dirs_r.dtype
    assert np.array_equal(xs_p, xs_r)
    assert np.array_equal(dirs_p, dirs_r, equal_nan=True)


@pytest.mark.parametrize("case, chunk, merged", [
    ("distinct", 8, None), ("bucket_edge", 8, None), ("shared2", 8, 8),
    ("shared8_64", 8, 56), ("shared3", 1, 16), ("bucket_edge_plus_one", 8, 1),
    ("nan", 1, 7)])
def test_dedupe_rows_merged_counts_only_a_premix(case, chunk, merged):
    before = profiling.counters().get("dedupe_rows_merged", 0)
    xs, _, (xs_p, _), _ = _run(case, chunk)
    after = profiling.counters().get("dedupe_rows_merged", 0)
    if merged is None:
        assert xs_p is xs and after == before
    else:
        assert after - before == merged == xs.shape[0] - xs_p.shape[0]


def test_render_scene_root_counts_the_merge():
    """A call's root keeps the counter: present where tracks merge, absent
    (so the call's counters as before) where every track is its own."""
    table = tinaural_torch.TorchTable.from_hrir_table(
        tinaural_torch.load_hrir_set("synthetic"), torch.device("cpu"))
    r = tinaural_torch.BinauralRenderer(
        table, tinaural_torch.RenderConfig(block_size=256, scene_chunk=2))
    rng = np.random.default_rng(5)
    dirs = _tracks(rng, 4, nb=4)
    xs = rng.standard_normal((8, 4 * 256)).astype(np.float32)
    for tracks, merged in ((dirs[[0, 1, 2, 3, 0, 1, 2, 3]], 4),
                           (_tracks(rng, 8, nb=4), None)):
        profiling.clear()
        with profiling.tracing():
            r.render_scene(xs, tracks)
        (root,) = [s for s in profiling.spans() if s.name == "tt.render_scene"]
        assert root.counts.get("dedupe_rows_merged") == merged

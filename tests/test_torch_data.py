"""tinaural_torch's data layer and matrix generators against tinaural's.

The port carries numpy copies of the JAX package's host data layer and
assembly-matrix generators (the originals import flax/jax, which the
port's machine lacks); these tests keep the copies bit-equal.
"""

import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from tinaural.data.table import save_table as jax_save_table
from tinaural.ops import filters as jax_filters
from tinaural_torch.data import TorchTable, load_table, save_table
from tinaural_torch.ops import filters as tt_filters

torch.set_num_threads(1)

FIELDS = ("h", "delays", "gains", "elevs", "az_counts", "valid")


def _assert_same_arrays(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f
    assert a.sample_rate == b.sample_rate
    assert a.decomposed == b.decomposed


@pytest.mark.parametrize("decompose", [True, False])
def test_synthetic_set_bit_equal(decompose):
    ours = tinaural_torch.load_hrir_set("synthetic", decompose=decompose)
    theirs = tinaural.load_hrir_set("synthetic", decompose=decompose)
    _assert_same_arrays(ours, theirs)


@pytest.mark.parametrize("kw", [
    dict(taps=64, noise=0.0, seed=3, sample_rate=48000),
    dict(taps=128, seed=1, target_sample_rate=48000, decompose=False)])
def test_synthetic_set_options_bit_equal(kw):
    _assert_same_arrays(tinaural_torch.load_hrir_set("synthetic", **kw),
                        tinaural.load_hrir_set("synthetic", **kw))


def test_npz_round_trip_across_packages(tmp_path):
    ours = tinaural_torch.load_hrir_set("synthetic")
    p = tmp_path / "ours.npz"
    save_table(p, ours)
    _assert_same_arrays(load_table(p), ours)
    _assert_same_arrays(tinaural_torch.load_hrir_set(str(p)), ours)
    with pytest.raises(ValueError, match="decomposed"):
        tinaural_torch.load_hrir_set(str(p), decompose=False)
    # a table the JAX package saved loads unchanged
    q = tmp_path / "theirs.npz"
    jax_save_table(q, tinaural.load_hrir_set("synthetic", decompose=False))
    _assert_same_arrays(tinaural_torch.load_hrir_set(str(q)),
                        tinaural.load_hrir_set(str(q)))


def test_unported_sources_raise(tmp_path):
    with pytest.raises(ValueError, match="SOFA"):
        tinaural_torch.load_hrir_set(str(tmp_path / "set.sofa"))
    with pytest.raises(ValueError, match="KEMAR-directory"):
        tinaural_torch.load_hrir_set(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tinaural_torch.load_hrir_set(str(tmp_path / "nothing"))


def test_from_hrir_table_carries_jax_table():
    jt = tinaural.load_hrir_set("synthetic")
    t = TorchTable.from_hrir_table(jt, "cpu")
    for f in FIELDS:
        v = getattr(t, f)
        assert v.device.type == "cpu" and v.is_contiguous()
        assert np.array_equal(v.numpy(), np.asarray(getattr(jt, f))), f
    assert t.h.dtype == torch.float32 and t.az_counts.dtype == torch.int32
    assert (t.sample_rate, t.decomposed) == (jt.sample_rate, jt.decomposed)
    assert (t.a_max, t.taps) == (jt.a_max, jt.taps)


@pytest.mark.parametrize("taps,n_fft", [(128, 2048), (64, 512), (512, 2048)])
def test_assembly_matrices_bit_equal(taps, n_fft):
    for a, b in zip(tt_filters._assembly_basis(taps),
                    jax_filters._assembly_basis(taps)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tt_filters._hybrid_matrices(taps),
                    jax_filters._hybrid_matrices(taps)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    a, b = tt_filters._rfft_matrix(taps, n_fft), jax_filters._rfft_matrix(taps, n_fft)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_render_config_matches_semantic_fields():
    ours, theirs = tinaural_torch.RenderConfig(), tinaural.RenderConfig()
    for f in ("sample_rate", "interp", "apply_itd", "apply_ild", "block_size",
              "stream_block", "crossfade", "scene_chunk", "out_length",
              "dir_rate", "stream_update_rate"):
        assert getattr(ours, f) == getattr(theirs, f), f
    for bad in (dict(interp="cubic"), dict(out_length="long"),
                dict(block_size=1000), dict(dir_rate=3),
                dict(stream_update_rate=5)):
        with pytest.raises(ValueError):
            tinaural_torch.RenderConfig(**bad)

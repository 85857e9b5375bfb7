"""tinaural_torch's WAV I/O, path helpers and file loaders against
tinaural's: the same files and arguments through both packages give
results equal in bits (and the same errors)."""

import shutil
import sys

import numpy as np
import pytest
from scipy.io import wavfile

import tinaural
import tinaural_torch
from tinaural.data import read_wav as jax_read_wav
from tinaural.data import write_wav as jax_write_wav
from tinaural.utils import paths as jax_paths
from tinaural_torch.data import read_wav, synthesize_hrirs, write_wav
from tinaural_torch.utils import circular_sweep, waypoints_to_block_dirs

FIELDS = ("h", "delays", "gains", "elevs", "az_counts", "valid")


def _assert_same_tables(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f
    assert a.sample_rate == b.sample_rate and a.decomposed == b.decomposed


def _both(source, **kw):
    """The port's and the JAX package's table of one source, checked
    equal in bits; → the port's."""
    ours = tinaural_torch.load_hrir_set(source, **kw)
    _assert_same_tables(ours, tinaural.load_hrir_set(source, **kw))
    return ours


def _both_raise(source, exc, match):
    with pytest.raises(exc, match=match) as ours:
        tinaural_torch.load_hrir_set(source)
    with pytest.raises(exc, match=match) as theirs:
        tinaural.load_hrir_set(source)
    assert str(ours.value).split(":")[0] == str(theirs.value).split(":")[0]


# ------------------------------------------------------------------- WAV


def _pcm(dtype, rng, n=500, ch=2):
    x = np.clip(rng.standard_normal((n, ch)) * 0.3, -1.0, 1.0)
    if dtype == np.float32:
        return x.astype(np.float32)
    if dtype == np.uint8:
        return np.clip(np.round(x * 127 + 128), 0, 255).astype(np.uint8)
    info = np.iinfo(dtype)
    return np.clip(np.round(x * info.max), info.min, info.max).astype(dtype)


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.uint8, np.float32])
@pytest.mark.parametrize("ch", [1, 2])
def test_read_wav_bit_equal(tmp_path, dtype, ch):
    rng = np.random.default_rng(int(np.dtype(dtype).itemsize) * 10 + ch)
    data = _pcm(dtype, rng, ch=ch)
    p = tmp_path / "in.wav"
    wavfile.write(p, 22050, data[:, 0] if ch == 1 else data)
    sr, x = read_wav(p)
    sr_j, x_j = jax_read_wav(p)
    assert sr == sr_j == 22050 and isinstance(sr, int)
    assert x.dtype == x_j.dtype == np.float64
    assert np.array_equal(x, x_j)
    assert np.abs(x).max() <= 1.0


@pytest.mark.parametrize("dtype,normalize", [("int16", False),
                                             ("int16", True),
                                             ("float32", False),
                                             ("float32", True)])
def test_write_wav_bit_equal(tmp_path, dtype, normalize):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((700, 2)) * 0.7  # clips at int16 full scale
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    write_wav(a, 48000, x, dtype=dtype, normalize=normalize)
    jax_write_wav(b, 48000, x, dtype=dtype, normalize=normalize)
    assert a.read_bytes() == b.read_bytes()


def test_write_wav_rejects_unknown_dtype(tmp_path):
    with pytest.raises(ValueError, match="unsupported dtype"):
        write_wav(tmp_path / "x.wav", 44100, np.zeros(4), dtype="int8")


def test_wav_exported_from_both_namespaces():
    assert tinaural_torch.read_wav is read_wav
    assert tinaural_torch.write_wav is write_wav


# ----------------------------------------------------------------- paths


@pytest.mark.parametrize("wps,nb,block,sr", [
    ([(0.0, 350.0, 0.0), (1.0, 10.0, 20.0)], 4, 11025, 44100),  # wraps
    ([(0.0, 10.0, -10.0), (0.3, 200.0, 40.0), (0.5, 90.0, 0.0)], 37, 512,
     44100),
    ([(0.2, 45.0, 5.0)], 6, 1024, 48000),  # one waypoint: clamps
])
def test_waypoints_bit_equal(wps, nb, block, sr):
    ours = waypoints_to_block_dirs(wps, nb, block, sr)
    want = jax_paths.waypoints_to_block_dirs(wps, nb, block, sr)
    assert ours.dtype == want.dtype == np.float32
    assert np.array_equal(ours, want)


def test_waypoints_interpolate_through_front():
    dirs = waypoints_to_block_dirs([(0.0, 350.0, 0.0), (1.0, 10.0, 20.0)],
                                   n_blocks=4, block_size=11025,
                                   sample_rate=44100)
    assert np.all((dirs[:, 0] > 340) | (dirs[:, 0] < 20))
    assert dirs[0, 1] < dirs[-1, 1] <= 20.0


@pytest.mark.parametrize("bad", [[(1.0, 0, 0), (0.5, 10, 0)],
                                 np.zeros((2, 2)), np.zeros((0, 3))])
def test_waypoints_validation(bad):
    for fn in (waypoints_to_block_dirs, jax_paths.waypoints_to_block_dirs):
        with pytest.raises(ValueError):
            fn(bad, 4, 256, 44100)


@pytest.mark.parametrize("args", [(8, 0, 360, 5.0), (5, 350.0, 10.0, 0.0),
                                  (5, 0.0, 360.0, 0.0), (5, 90.0, 90.0, -20.0),
                                  (7, 30.0, 800.0, 10.0)])
def test_circular_sweep_bit_equal(args):
    ours = circular_sweep(*args)
    want = jax_paths.circular_sweep(*args)
    assert ours.dtype == want.dtype == np.float32
    assert np.array_equal(ours, want)


def test_circular_sweep_wraps_forward_and_holds():
    assert np.allclose(circular_sweep(5, 350.0, 10.0)[:, 0],
                       [350, 355, 0, 5, 10])
    assert np.allclose(circular_sweep(5, 0.0, 360.0)[:, 0],
                       [0, 90, 180, 270, 0])
    assert np.allclose(circular_sweep(5, 90.0, 90.0)[:, 0], 90.0)


# ---------------------------------------------------------------- KEMAR


def _kemar_compact(root, h, g, elevs=(50, 90)):
    """Compact KEMAR layout: the front half (az ≤ 180) of each ring as
    float32 stereo WAVs; the loaders mirror the back half."""
    for e_deg in elevs:
        e_i = list(g.elevs).index(float(e_deg))
        d = root / f"elev{e_deg}"
        d.mkdir()
        for a_i, az in enumerate(g.ring_azimuths(e_i)):
            if az <= 180.0:
                write_wav(d / f"H{e_deg}e{int(round(az)) % 360:03d}a.wav",
                          44100, h[e_i, a_i].T, dtype="float32")


def _kemar_dat(root, h, g, elevs=(0, 80, 90)):
    """Full KEMAR layout: every azimuth as big-endian int16 L/R .dat."""
    for e_deg in elevs:
        e_i = list(g.elevs).index(float(e_deg))
        d = root / f"elev{e_deg}"
        d.mkdir()
        for a_i, az in enumerate(g.ring_azimuths(e_i)):
            for ear, name in enumerate("LR"):
                q = np.round(h[e_i, a_i, ear] * 2.0**15).astype(">i2")
                q.tofile(d / f"{name}{e_deg}e{int(round(az)) % 360:03d}a.dat")


@pytest.mark.parametrize("decompose", [False, True])
def test_kemar_compact_bit_equal(tmp_path, decompose):
    h, g = synthesize_hrirs(taps=32, noise=0.0)
    _kemar_compact(tmp_path, h, g)
    t = _both(str(tmp_path), decompose=decompose)
    assert t.h.shape == (2, 45, 2, 32) and t.sample_rate == 44100
    # a mirrored azimuth: slot 30 of the 45-azimuth ring is 240°, the
    # mirror of 120° with the ears swapped
    az = g.ring_azimuths(list(g.elevs).index(50.0))[30]
    src = int(round((360 - az) / (360 / 45)))
    if not decompose:
        want = h[list(g.elevs).index(50.0), src][::-1].astype(np.float32)
        np.testing.assert_allclose(t.h[0, 30], want, atol=1e-7)


def test_kemar_dat_bit_equal(tmp_path):
    h, g = synthesize_hrirs(taps=64, noise=1e-4)
    _kemar_dat(tmp_path, h, g)
    t = _both(str(tmp_path))
    assert t.h.shape == (3, 72, 2, 64) and t.decomposed
    assert list(t.az_counts) == [72, 12, 1]


def test_kemar_target_sample_rate(tmp_path):
    h, g = synthesize_hrirs(taps=32, noise=0.0)
    _kemar_compact(tmp_path, h, g)
    t = _both(str(tmp_path), target_sample_rate=48000)
    assert t.sample_rate == 48000 and t.taps == 36
    t = _both(str(tmp_path), target_sample_rate=22050, decompose=False)
    assert t.sample_rate == 22050 and t.taps == 16


def test_kemar_malformed_directories(tmp_path):
    (tmp_path / "elev33").mkdir()
    _both_raise(str(tmp_path), ValueError, "not in the KEMAR grid")
    shutil.rmtree(tmp_path / "elev33")
    (tmp_path / "elev90").mkdir()  # the pole ring needs one file
    _both_raise(str(tmp_path), FileNotFoundError, "missing HRIR")


def test_unknown_source_raises(tmp_path):
    for source in (str(tmp_path / "nothing"), "kemar"):
        with pytest.raises(FileNotFoundError, match="unknown HRIR source"):
            tinaural_torch.load_hrir_set(source)
    empty = tmp_path / "empty"
    empty.mkdir()
    _both_raise(str(empty), FileNotFoundError, "no elev")


# ------------------------------------------------------------------ SOFA


def _sofa_rows(swap=False, wrap_noise=False):
    """The elevation-0 ring of the 64-tap synthetic set as SOFA rows, with
    counterclockwise azimuths (90° = left) as SOFA stores them."""
    h, g = synthesize_hrirs(taps=64, noise=0.0)
    e_i = list(g.elevs).index(0.0)
    rows, pos = [], []
    for a_i, az in enumerate(g.ring_azimuths(e_i)):
        rows.append(h[e_i, a_i][::-1] if swap else h[e_i, a_i])
        sofa_az = (360.0 - az) % 360.0
        if wrap_noise and a_i == 0:
            sofa_az = 359.95  # the zero point measured just under 360
        pos.append([sofa_az, 0.0, 1.4])
    return np.stack(rows), np.array(pos)


def _write_sofa(path, ir, pos, sp_attrs=None, rp=None, rp_attrs=None):
    import h5py

    with h5py.File(path, "w") as f:
        f["Data.IR"] = ir
        sp = f.create_dataset("SourcePosition", data=pos)
        for k, v in (sp_attrs or {}).items():
            sp.attrs[k] = np.bytes_(v)
        if rp is not None:
            ds = f.create_dataset("ReceiverPosition", data=rp)
            for k, v in (rp_attrs or {}).items():
                ds.attrs[k] = np.bytes_(v)
        f["Data.SamplingRate"] = np.array([44100.0])
    return str(path)


def _sofa_two_rings(path):
    h, g = synthesize_hrirs(taps=64, noise=0.0)
    rows, pos = [], []
    for e_deg in (0.0, 10.0):
        e_i = list(g.elevs).index(e_deg)
        for a_i, az in enumerate(g.ring_azimuths(e_i)):
            rows.append(h[e_i, a_i])
            pos.append([(360.0 - az) % 360.0, e_deg, 1.4])
    return _write_sofa(path, np.stack(rows), np.array(pos))


def _sofa_swapped_receivers(path):
    ir, pos = _sofa_rows(swap=True, wrap_noise=True)
    return _write_sofa(path, ir, pos,
                       {"Type": "spherical", "Units": "degree, degree, metre"},
                       np.array([[0.0, -0.09, 0.0], [0.0, 0.09, 0.0]]),
                       {"Type": "cartesian"})


def _sofa_radians(path):
    ir, pos = _sofa_rows()
    pos[:, :2] = np.radians(pos[:, :2])
    return _write_sofa(path, ir, pos, {"Units": "radian, radian, metre"})


def _sofa_radian_receivers(path):
    ir, pos = _sofa_rows()
    return _write_sofa(path, ir, pos,
                       {"Type": "spherical", "Units": "degree, degree, metre"},
                       np.array([[np.pi / 2, 0.0, 0.09],
                                 [3 * np.pi / 2, 0.0, 0.09]]),
                       {"Type": "spherical", "Units": "radian, radian, metre"})


SOFA_FILES = {"two_rings": _sofa_two_rings,
              "swapped_receivers": _sofa_swapped_receivers,
              "radians": _sofa_radians,
              "radian_receivers": _sofa_radian_receivers}


@pytest.mark.parametrize("decompose", [False, True])
@pytest.mark.parametrize("case", sorted(SOFA_FILES))
def test_sofa_bit_equal(tmp_path, case, decompose):
    pytest.importorskip("h5py")
    path = SOFA_FILES[case](tmp_path / f"{case}.sofa")
    t = _both(path, decompose=decompose)
    h, g = synthesize_hrirs(taps=64, noise=0.0)
    e_i = list(g.elevs).index(0.0)
    if not decompose:  # every case lands in (L, R) order, clockwise
        np.testing.assert_allclose(t.h[0], h[e_i, :72].astype(np.float32),
                                   atol=1e-7)
    assert t.h.shape[1:] == (72, 2, 64) and t.sample_rate == 44100


def _sofa_mono(path):
    return _write_sofa(path, np.zeros((4, 1, 32)), np.zeros((4, 3)))


def _sofa_scattered(path):
    return _write_sofa(path, np.zeros((3, 2, 32)),
                       np.array([[0.0, 0.0, 1], [10.0, 0.0, 1],
                                 [200.0, 0.0, 1]]))


def _sofa_cartesian(path):
    ir, pos = _sofa_rows()
    return _write_sofa(path, ir, pos, {"Type": "cartesian"})


@pytest.mark.parametrize("case,match", [(_sofa_mono, "must be"),
                                        (_sofa_scattered, "ring"),
                                        (_sofa_cartesian, "not supported")])
def test_sofa_malformed(tmp_path, case, match):
    pytest.importorskip("h5py")
    _both_raise(case(tmp_path / "bad.sofa"), ValueError, match)


def test_sofa_without_h5py_names_it(tmp_path, monkeypatch):
    """Where h5py is missing, a .sofa source raises an ImportError that
    names it, before anything is read."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tinaural_torch.load_hrir_set(str(tmp_path / "set.sofa"))


def test_table_grid_matches_jax():
    ours = tinaural_torch.load_hrir_set("synthetic").grid()
    theirs = tinaural.load_hrir_set("synthetic").grid()
    for f in ("elevs", "az_counts"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours.n_directions == 710

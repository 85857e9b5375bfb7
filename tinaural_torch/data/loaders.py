"""HRIR dataset loaders (host numpy, a copy of `tinaural.data.loaders`).

Four sources, all normalised into one `HrirArrays`:

  * ``"synthetic"`` — the deterministic spherical-head set;
  * a directory in MIT KEMAR layout — either the compact set
    (``elev{E}/H{E}e{AAA}a.wav`` stereo WAVs, azimuths 0–180 with the far
    side obtained by mirroring with the ears swapped) or the full set
    (``elev{E}/{L,R}{E}e{AAA}a.dat`` 16-bit big-endian raw files);
  * a ``.sofa`` file (SimpleFreeFieldHRIR convention, read with h5py,
    which is imported only when a ``.sofa`` source is loaded), accepted
    when its measurement positions form per-elevation rings of equally
    spaced azimuths;
  * a ``.npz`` table saved by `save_table` (by either package).
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..utils.log import get_logger
from .grids import SphericalGrid, kemar_grid
from .synthetic import synthesize_hrirs
from .table import HrirArrays, build_table, load_table
from .wav import read_wav

_log = get_logger("tinaural_torch.data")

KEMAR_SAMPLE_RATE = 44100


def resample_hrirs(h: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase-resample a dense HRIR array (..., T) to ``sr_out``.

    Tap count scales by sr_out/sr_in (rounded up to even). Applied to the
    raw responses before decomposition.
    """
    from math import gcd

    from scipy.signal import resample_poly

    if sr_in == sr_out:
        return h
    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    out = resample_poly(h, up, down, axis=-1)
    if out.shape[-1] % 2:  # keep tap counts even (rfft-friendly)
        out = np.concatenate([out, np.zeros((*out.shape[:-1], 1))], axis=-1)
    return out


def load_hrir_set(source: str = "synthetic", *, decompose: bool | None = None,
                  sample_rate: int = KEMAR_SAMPLE_RATE, taps: int = 128,
                  noise: float = 1e-4, seed: int = 0,
                  target_sample_rate: int | None = None) -> HrirArrays:
    """Load an HRIR set into `HrirArrays` (host numpy).

    ``source`` is ``"synthetic"``, a KEMAR-layout directory, a ``.sofa``
    path, or a ``.npz`` saved by `save_table`. ``sample_rate``/``taps``/
    ``noise``/``seed`` apply to the synthetic source only; file sources
    carry their own rate/length. ``target_sample_rate`` polyphase-resamples
    any raw source to the given rate before decomposition. ``decompose``
    defaults to True for raw sources; for ``.npz`` tables it must match
    the stored table (or be left unset). Carry the result to a device with
    `TorchTable.from_hrir_table`.
    """
    dec = True if decompose is None else decompose

    def finish(h, grid, sr):
        if target_sample_rate is not None and target_sample_rate != sr:
            h = resample_hrirs(h, sr, target_sample_rate)
            sr = target_sample_rate
        _log.debug("loaded HRIR set %r: %d directions, %d taps @ %d Hz, "
                   "decompose=%s", source, grid.n_directions, h.shape[-1],
                   sr, dec)
        return build_table(h, grid, sr, decompose=dec)

    if source == "synthetic":
        h, grid = synthesize_hrirs(sample_rate=sample_rate, taps=taps,
                                   noise=noise, seed=seed)
        return finish(h, grid, sample_rate)
    if str(source).endswith(".npz"):
        table = load_table(source)
        if target_sample_rate is not None and target_sample_rate != table.sample_rate:
            raise ValueError(
                ".npz tables are preprocessed; re-export at the target rate")
        if decompose is not None and decompose != table.decomposed:
            raise ValueError(
                f".npz table was saved with decomposed={table.decomposed} and "
                f"cannot be re-decomposed after the fact; re-export from the "
                f"original source, e.g. `tinaural-torch export --hrir "
                f"<kemar-dir|.sofa|synthetic>{'' if decompose else ' --raw'} "
                f"out.npz`")
        return table
    if str(source).endswith(".sofa"):
        h, grid, sr = _load_sofa(source)
        return finish(h, grid, sr)
    if os.path.isdir(source):
        h, grid = _load_kemar_dir(source)
        return finish(h, grid, KEMAR_SAMPLE_RATE)
    raise FileNotFoundError(f"unknown HRIR source {source!r}")


# ---------------------------------------------------------------- KEMAR dir

_ELEV_DIR_RE = re.compile(r"^elev(-?\d+)$")


def _kemar_read_pair(root: str, elev: int, az_deg: float) -> np.ndarray | None:
    """Read the (2, T) HRIR pair at (elev, az) from a KEMAR tree, or None.

    Handles the compact stereo-WAV layout and the full L/R .dat layout.
    """
    azi = int(round(az_deg)) % 360
    d = os.path.join(root, f"elev{elev}")
    wav = os.path.join(d, f"H{elev}e{azi:03d}a.wav")
    if os.path.exists(wav):
        _, data = read_wav(wav)
        if data.ndim != 2 or data.shape[1] != 2:
            raise ValueError(f"{wav}: expected stereo HRIR pair")
        return data.T  # (2, T)
    ldat = os.path.join(d, f"L{elev}e{azi:03d}a.dat")
    rdat = os.path.join(d, f"R{elev}e{azi:03d}a.dat")
    if os.path.exists(ldat) and os.path.exists(rdat):
        read = lambda p: np.fromfile(p, dtype=">i2").astype(np.float64) / 2.0**15
        return np.stack([read(ldat), read(rdat)])
    return None


def _load_kemar_dir(root: str) -> tuple[np.ndarray, SphericalGrid]:
    elevs = sorted(
        int(m.group(1))
        for name in os.listdir(root)
        if (m := _ELEV_DIR_RE.match(name)) and os.path.isdir(os.path.join(root, name))
    )
    if not elevs:
        raise FileNotFoundError(f"{root}: no elev* subdirectories")
    full = kemar_grid()
    counts = []
    for e in elevs:
        idx = np.where(full.elevs == float(e))[0]
        if len(idx) != 1:
            raise ValueError(f"{root}: elevation {e} not in the KEMAR grid")
        counts.append(int(full.az_counts[idx[0]]))
    grid = SphericalGrid(elevs=np.array(elevs, dtype=np.float64),
                         az_counts=np.array(counts, dtype=np.int64))

    pairs: list[list[np.ndarray]] = []
    taps = None
    for e_i, e in enumerate(elevs):
        ring = []
        for az in grid.ring_azimuths(e_i):
            pair = _kemar_read_pair(root, e, az)
            if pair is None:
                # KEMAR ships azimuths 0..180; θ>180 is the mirror of
                # 360−θ with ears swapped (head symmetry).
                mirror = _kemar_read_pair(root, e, 360.0 - az)
                if mirror is None:
                    raise FileNotFoundError(
                        f"{root}: missing HRIR for elev {e} az {az} (and mirror)")
                pair = mirror[::-1]
            if taps is None:
                taps = pair.shape[1]
            elif pair.shape[1] != taps:
                raise ValueError(f"{root}: inconsistent tap counts")
            ring.append(pair)
        pairs.append(ring)

    h = np.zeros((grid.n_elevs, grid.a_max, 2, taps))
    for e_i, ring in enumerate(pairs):
        for a_i, pair in enumerate(ring):
            h[e_i, a_i] = pair
    return h, grid


# -------------------------------------------------------------------- SOFA


def _attr_str(ds, name: str, default: str) -> str:
    v = ds.attrs.get(name, default)
    return v.decode() if isinstance(v, (bytes, np.bytes_)) else str(v)


def _load_sofa(path: str) -> tuple[np.ndarray, SphericalGrid, int]:
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path}: reading a .sofa source needs h5py, which is not "
            "installed; export the set to .npz where h5py is available") from e

    with h5py.File(path, "r") as f:
        ir = np.asarray(f["Data.IR"])  # (M, 2, T)
        pos = np.asarray(f["SourcePosition"])  # (M, 3): az, el, r
        sr = int(np.asarray(f["Data.SamplingRate"]).reshape(-1)[0])
        # SOFA allows cartesian SourcePosition and radian units; reading
        # them as spherical degrees would build a garbage grid. Absent
        # attrs default to the SimpleFreeField convention.
        sp_type = _attr_str(f["SourcePosition"], "Type", "spherical")
        sp_units = _attr_str(f["SourcePosition"], "Units",
                             "degree, degree, metre")
        rp = (np.asarray(f["ReceiverPosition"])
              if "ReceiverPosition" in f else None)
        rp_type = (_attr_str(f["ReceiverPosition"], "Type", "cartesian")
                   if rp is not None else "cartesian")
        rp_units = (_attr_str(f["ReceiverPosition"], "Units",
                              "metre" if "cartesian" in rp_type.lower()
                              else "degree, degree, metre")
                    if rp is not None else "metre")
    if ir.ndim != 3 or ir.shape[1] != 2:
        raise ValueError(f"{path}: Data.IR must be (M, 2, T)")
    if "spherical" not in sp_type.lower():
        raise ValueError(
            f"{path}: SourcePosition Type {sp_type!r} is not supported "
            "(only 'spherical'); convert the file's source coordinates")
    if "radian" in sp_units.lower():
        pos = pos.copy()
        pos[:, :2] = np.degrees(pos[:, :2])
    # SOFA does not mandate the receiver (ear) order: read it from
    # ReceiverPosition when present (+y is the listener's LEFT) and swap
    # to (L, R) if the file lists the right ear first.
    if rp is not None and rp.shape[0] == 2:
        rp2 = rp.reshape(2, 3, -1)[:, :, 0] if rp.ndim == 3 else rp[:, :3]
        if "cartesian" in rp_type.lower():
            left_y = rp2[:, 1]
        else:  # spherical az/el/r: y = r·sin(az)·cos(el), in the Units
            # attr's angle unit
            ang = (rp2[:, :2] if "radian" in rp_units.lower()
                   else np.deg2rad(rp2[:, :2]))
            left_y = rp2[:, 2] * np.sin(ang[:, 0]) * np.cos(ang[:, 1])
        if left_y[0] < left_y[1]:
            ir = ir[:, ::-1]
    # SOFA's spherical convention is counterclockwise azimuth (90° = the
    # listener's LEFT); this package uses KEMAR's clockwise convention
    # (90° = RIGHT). Convert on load.
    az = (360.0 - pos[:, 0]) % 360.0
    el = pos[:, 1]

    elevs = np.unique(np.round(el, 3))
    counts, rings = [], []
    for e in elevs:
        sel = np.where(np.round(el, 3) == e)[0]
        ring_az = az[sel]
        c = len(sel)
        spacing = 360.0 / c
        if c > 1:
            # slot-based check: each az must sit within tolerance of some
            # multiple of the ring spacing, and the slots must cover the
            # ring exactly once (an az = 0 point measured just under 360
            # lands in slot 0).
            slots = np.round(ring_az / spacing).astype(int) % c
            err = np.abs(ring_az - np.round(ring_az / spacing) * spacing)
            if err.max() > spacing * 0.05 or len(np.unique(slots)) != c:
                raise ValueError(
                    f"{path}: elevation ring {e} is not equally spaced "
                    "from az 0; only ring-structured SOFA grids are "
                    "supported")
            sel = sel[np.argsort(slots)]
        counts.append(c)
        rings.append(sel)
    grid = SphericalGrid(elevs=elevs.astype(np.float64),
                         az_counts=np.array(counts, dtype=np.int64))
    h = np.zeros((grid.n_elevs, grid.a_max, 2, ir.shape[-1]))
    for e_i, sel in enumerate(rings):
        h[e_i, : len(sel)] = ir[sel]
    return h, grid, sr

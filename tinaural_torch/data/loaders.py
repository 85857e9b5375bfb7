"""HRIR dataset loaders: the ``"synthetic"`` spherical-head set and ``.npz``
tables saved by `save_table` (by either package).

KEMAR-directory and SOFA sources are not loaded by this package yet; they
raise a `ValueError` naming the source kind.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from .synthetic import synthesize_hrirs
from .table import HrirArrays, build_table, load_table

_log = logging.getLogger("tinaural_torch.data")

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

    ``source`` is ``"synthetic"`` or a ``.npz`` saved by `save_table`.
    ``sample_rate``/``taps``/``noise``/``seed`` apply to the synthetic
    source only. ``target_sample_rate`` polyphase-resamples the synthetic
    source before decomposition. ``decompose`` defaults to True; for
    ``.npz`` tables it must match the stored table (or be left unset).
    Carry the result to a device with `TorchTable.from_hrir_table`.
    """
    dec = True if decompose is None else decompose

    if source == "synthetic":
        h, grid = synthesize_hrirs(sample_rate=sample_rate, taps=taps,
                                   noise=noise, seed=seed)
        sr = sample_rate
        if target_sample_rate is not None and target_sample_rate != sr:
            h = resample_hrirs(h, sr, target_sample_rate)
            sr = target_sample_rate
        _log.debug("loaded HRIR set %r: %d directions, %d taps @ %d Hz, "
                   "decompose=%s", source, grid.n_directions, h.shape[-1],
                   sr, dec)
        return build_table(h, grid, sr, decompose=dec)
    if str(source).endswith(".npz"):
        table = load_table(source)
        if target_sample_rate is not None and target_sample_rate != table.sample_rate:
            raise ValueError(
                ".npz tables are preprocessed; re-export at the target rate")
        if decompose is not None and decompose != table.decomposed:
            raise ValueError(
                f".npz table was saved with decomposed={table.decomposed} and "
                f"cannot be re-decomposed after the fact; re-export from the "
                f"original source")
        return table
    if str(source).endswith(".sofa"):
        raise ValueError(
            f"{source!r}: SOFA sources are not supported by tinaural_torch "
            "yet; export the set to .npz with the JAX package")
    if os.path.isdir(source):
        raise ValueError(
            f"{source!r}: KEMAR-directory sources are not supported by "
            "tinaural_torch yet; export the set to .npz with the JAX package")
    raise FileNotFoundError(f"unknown HRIR source {source!r}")

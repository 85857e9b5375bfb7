"""Trajectory path helpers: waypoints → per-block directions (host numpy,
a copy of `tinaural.utils.paths`).

The renderers take one (az, el) per block. `waypoints_to_block_dirs`
resamples sparse (time, az, el) waypoints onto block centres, azimuth
along the shortest arc; `circular_sweep` is a constant-elevation sweep.
"""

from __future__ import annotations

import numpy as np


def waypoints_to_block_dirs(waypoints, n_blocks: int, block_size: int,
                            sample_rate: int) -> np.ndarray:
    """Resample waypoints to per-block directions.

    waypoints: (K, 3) array-like of (time_sec, azimuth_deg, elevation_deg),
    times ascending. → (n_blocks, 2) float32; blocks before the first /
    after the last waypoint clamp to it.
    """
    w = np.asarray(waypoints, dtype=np.float64)
    if w.ndim != 2 or w.shape[1] != 3 or len(w) == 0:
        raise ValueError("waypoints must be (K, 3) of (t, az, el)")
    if np.any(np.diff(w[:, 0]) < 0):
        raise ValueError("waypoint times must be ascending")
    t_blocks = (np.arange(n_blocks) + 0.5) * block_size / sample_rate
    az = np.deg2rad(w[:, 1])
    az_unwrapped = np.rad2deg(np.unwrap(az))
    az_b = np.interp(t_blocks, w[:, 0], az_unwrapped) % 360.0
    el_b = np.interp(t_blocks, w[:, 0], w[:, 2])
    return np.stack([az_b, el_b], axis=1).astype(np.float32)


def circular_sweep(n_blocks: int, az_start: float = 0.0, az_end: float = 360.0,
                   elevation: float = 0.0) -> np.ndarray:
    """Constant-elevation azimuth sweep → (n_blocks, 2) float32.

    The sweep always moves forward (clockwise, increasing azimuth): when
    az_end < az_start it wraps through 0/360, so 350→10 is the 20°
    crossing through the front. Equal endpoints hold one direction.
    Multi-revolution sweeps pass az_end > az_start + 360; for
    counterclockwise motion use `waypoints_to_block_dirs`."""
    if az_end < az_start:
        az_end += 360.0
    az = np.linspace(az_start, az_end, n_blocks) % 360.0
    return np.stack([az, np.full(n_blocks, elevation)], axis=1).astype(np.float32)

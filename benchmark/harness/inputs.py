"""The general generator: signals and direction paths from a traffic mix's
parameters and the run's seed.

Every size comes from the mix and never from the seed, so every seed does
the same work; the seed picks the samples, the paths' phases, speeds and
ranges. Signals are white noise of a stated rms. A path is smooth, as a
source moves: ``sweep`` (a moving source over nb blocks) takes azimuth
from az0 through ``turns`` full circles (either way) with a wobble, and
elevation wandering through [el_lo, el_hi] over ``el_cycles`` periods.
"""

from __future__ import annotations

import numpy as np

SEED_SALT = {"hrir": 1, "signal": 2, "path": 3, "sample": 4}


def rng(seed: int, what: str, k: int = 0) -> np.random.Generator:
    """An independent stream for one purpose of one run."""
    return np.random.default_rng([int(seed) % (1 << 64), SEED_SALT[what],
                                  int(k)])


def signals(seed: int, k: int, shape, rms: float) -> np.ndarray:
    """White noise of the given shape and rms, float32."""
    g = rng(seed, "signal", k)
    return (g.standard_normal(shape, dtype=np.float32) * np.float32(rms))


def sweep(g: np.random.Generator, nb: int, p: dict) -> np.ndarray:
    """One moving source's per-block (az, el), (nb, 2) float32."""
    t = np.arange(nb) / nb
    az0 = g.uniform(0.0, 360.0)
    turns = g.uniform(*p["turns"]) * g.choice([-1.0, 1.0])
    wob = g.uniform(0.0, p["wobble_deg"])
    ph = g.uniform(0.0, 2 * np.pi, size=2)
    az = az0 + 360.0 * turns * t + wob * np.sin(2 * np.pi * 3 * t + ph[0])
    lo, hi = p["el_range"]
    span = g.uniform(*p["el_span"]) * (hi - lo)
    mid = g.uniform(lo + span / 2, hi - span / 2)
    el = mid + span / 2 * np.sin(2 * np.pi * p["el_cycles"] * t + ph[1])
    return np.stack([np.remainder(az, 360.0), el], -1).astype(np.float32)


def sweeps(seed: int, k: int, S: int, nb: int, p: dict) -> np.ndarray:
    """S sources' paths, (S, nb, 2) float32."""
    g = rng(seed, "path", k)
    return np.stack([sweep(g, nb, p) for _ in range(S)])

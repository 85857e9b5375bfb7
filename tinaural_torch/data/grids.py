"""Spherical measurement-grid geometry (numpy copy of `tinaural.data.grids`).

The MIT KEMAR grid is ragged: each elevation ring holds a different number
of equally spaced azimuths. This host-side numpy runs once at load time; the
dense padded arrays it yields feed the render-time lookup in
`tinaural_torch.ops.interp`.

Conventions (KEMAR's): elevation in degrees, -90 (below) … +90 (above);
azimuth in degrees, 0 = straight ahead, increasing clockwise seen from above
(90 = the listener's right ear). Rings start at azimuth 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# MIT KEMAR: elevations -40..90 in 10° steps; azimuth count per ring.
KEMAR_ELEVS = np.arange(-40.0, 91.0, 10.0)
KEMAR_AZ_COUNTS = np.array([56, 60, 72, 72, 72, 72, 72, 60, 56, 45, 36, 24, 12, 1])
assert KEMAR_ELEVS.shape == KEMAR_AZ_COUNTS.shape


@dataclasses.dataclass(frozen=True)
class SphericalGrid:
    """A ragged lat/ring grid: per-elevation rings of equally spaced azimuths.

    elevs:     (E,) float64, strictly increasing elevation of each ring (deg).
    az_counts: (E,) int, number of equally spaced azimuths in each ring.
    """

    elevs: np.ndarray
    az_counts: np.ndarray

    def __post_init__(self):
        if self.elevs.ndim != 1 or self.elevs.shape != self.az_counts.shape:
            raise ValueError("elevs and az_counts must be matching 1-D arrays")
        if not np.all(np.diff(self.elevs) > 0):
            raise ValueError("elevations must be strictly increasing")
        if np.any(self.az_counts < 1):
            raise ValueError("each ring needs at least one azimuth")

    @property
    def n_elevs(self) -> int:
        return len(self.elevs)

    @property
    def a_max(self) -> int:
        return int(self.az_counts.max())

    @property
    def n_directions(self) -> int:
        return int(self.az_counts.sum())

    def ring_azimuths(self, e: int) -> np.ndarray:
        """The azimuths (deg) measured in ring ``e``."""
        c = int(self.az_counts[e])
        return np.arange(c) * (360.0 / c)

    def validity_mask(self) -> np.ndarray:
        """(E, A_max) bool: which dense (ring, az-slot) cells hold real data."""
        mask = np.zeros((self.n_elevs, self.a_max), dtype=bool)
        for e in range(self.n_elevs):
            mask[e, : int(self.az_counts[e])] = True
        return mask


def kemar_grid() -> SphericalGrid:
    return SphericalGrid(elevs=KEMAR_ELEVS.copy(), az_counts=KEMAR_AZ_COUNTS.copy())


"""Deterministic synthetic HRIR dataset (numpy copy of `tinaural.data.synthetic`).

A physically plausible KEMAR-shaped set from a spherical-head model, so the
loader, interpolator, ITD/ILD decomposition and renderers run on the real
dataset's grid geometry without real data:

  * Woodworth/Schlosberg interaural time difference from a rigid sphere
    (radius 8.75 cm), applied as a per-ear pure delay.
  * Brown–Duda first-order head-shadow filter per ear.
  * A mild elevation-dependent pinna notch so elevation is observable.
  * Optional seeded measurement noise.

Host-side numpy float64, computed once at load time. `test_torch_data.py`
keeps it bit-equal to the JAX package's copy.
"""

from __future__ import annotations

import numpy as np

from .grids import SphericalGrid, kemar_grid

SPEED_OF_SOUND = 343.0  # m/s
HEAD_RADIUS = 0.0875  # m, KEMAR-ish


def _woodworth_delay(cos_theta: np.ndarray, radius: float, c: float) -> np.ndarray:
    """Arrival delay (s) at an ear relative to the head centre; negative
    means the wavefront arrives early. ``cos_theta`` is the cosine of the
    angle between the source direction and the ear's outward axis: near
    side ``-(a/c)·cos(theta)``, far side ``(a/c)·(theta - 90°)``."""
    theta = np.arccos(np.clip(cos_theta, -1.0, 1.0))
    near = -(radius / c) * np.cos(theta)
    far = (radius / c) * (theta - np.pi / 2.0)
    return np.where(theta < np.pi / 2.0, near, far)


def _brown_duda_shadow(freqs: np.ndarray, cos_theta: np.ndarray,
                       radius: float, c: float) -> np.ndarray:
    """First-order spherical head-shadow response, complex, broadcast.

    H(jw) = (1 + j·w·alpha/(2 w0)) / (1 + j·w/(2 w0)),  w0 = c / a,
    alpha(theta) = 1 + cos(theta).
    """
    w = 2.0 * np.pi * freqs  # (..., F)
    w0 = c / radius
    alpha = 1.0 + cos_theta  # (...)
    num = 1.0 + 1j * (alpha[..., None] * w) / (2.0 * w0)
    den = 1.0 + 1j * w / (2.0 * w0)
    return num / den


def _pinna_notch(freqs: np.ndarray, elev_deg: np.ndarray) -> np.ndarray:
    """Mild elevation-steered spectral notch (magnitude only)."""
    fn = 6000.0 + 35.0 * elev_deg[..., None]  # Hz
    depth = 0.45
    width = 1500.0
    return 1.0 - depth * np.exp(-(((freqs - fn) / width) ** 2))


def synthesize_hrirs(
    grid: SphericalGrid | None = None,
    taps: int = 128,
    sample_rate: int = 44100,
    head_radius: float = HEAD_RADIUS,
    noise: float = 1e-4,
    seed: int = 0,
) -> tuple[np.ndarray, SphericalGrid]:
    """Generate a dense HRIR table for ``grid``.

    Returns ``(hrirs, grid)`` with ``hrirs`` of shape (E, A_max, 2, taps)
    float64; invalid (padded) cells are zero. Ear 0 = left, ear 1 = right.
    """
    grid = grid or kemar_grid()
    E, A = grid.n_elevs, grid.a_max
    elevs = np.deg2rad(grid.elevs)  # (E,)

    # Dense azimuth table (deg→rad); padded slots replicate slot 0 and are
    # masked out at the end.
    az = np.zeros((E, A))
    for e in range(E):
        ring = np.deg2rad(grid.ring_azimuths(e))
        az[e, : len(ring)] = ring

    # Source unit vector: x front, y right, z up.
    cos_el = np.cos(elevs)[:, None]  # (E, 1)
    sy = cos_el * np.sin(az)  # (E, A) — rightward component
    # cos of angle to each ear's outward axis (+y right ear, -y left ear).
    cos_theta = np.stack([-sy, sy], axis=-1)  # (E, A, 2)

    freqs = np.fft.rfftfreq(taps, d=1.0 / sample_rate)  # (F,)

    tau = _woodworth_delay(cos_theta, head_radius, SPEED_OF_SOUND)
    # Causal base delay: worst-case lead is a/c; add a small margin.
    t0 = head_radius / SPEED_OF_SOUND + 8.0 / sample_rate
    delay = tau + t0  # (E, A, 2) seconds, all positive

    shadow = _brown_duda_shadow(freqs, cos_theta, head_radius, SPEED_OF_SOUND)
    notch = _pinna_notch(freqs, np.broadcast_to(np.rad2deg(elevs)[:, None, None], cos_theta.shape))
    phase = np.exp(-2j * np.pi * freqs * delay[..., None])
    G = shadow * notch * phase  # (E, A, 2, F)

    h = np.fft.irfft(G, n=taps, axis=-1)  # (E, A, 2, taps)

    # Fade the last taps to suppress circular wraparound energy.
    fade = np.ones(taps)
    nf = max(8, taps // 8)
    fade[-nf:] = 0.5 * (1.0 + np.cos(np.linspace(0.0, np.pi, nf)))
    h *= fade

    if noise > 0.0:
        rng = np.random.default_rng(seed)
        h = h + noise * rng.standard_normal(h.shape)

    h *= grid.validity_mask()[..., None, None]
    return h, grid

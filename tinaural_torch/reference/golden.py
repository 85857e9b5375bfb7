"""The numpy float64 golden reference of the render modes that the CLI's
``--cpu-golden`` calls: `render_static`, `render_trajectory`,
`render_scene` and `GoldenStream` (`push`, `push_held`), with their
helpers.

A copy of `tinaural.reference.golden`, which defines the numerical
semantics of every render mode; this package cannot import it, and the
CLI flag is part of its public surface. `tests/test_torch_golden.py` keeps
the copy equal in bits to the original, and the port's tests still hold
the port against the original.

Conventions (the renderers reproduce them):
  * Interpolation weights: bracket the elevation between rings,
    interpolate within each ring at that ring's own azimuth spacing (with
    0/360 wraparound), then lerp across rings. Aligned HRIR shapes,
    delays and gains share the same weights.
  * Every render mode convolves the same per-direction FIR, the effective
    filter ``gain · delay(aligned shape)``, materialised once at the
    canonical FFT size to ``taps + DELAY_PAD`` samples.
  * The trajectory crossfade is input-side: block b contributes
    ``conv(ramp·x_b, filt_b) + conv((1-ramp)·x_b, filt_{b-1})`` with a
    linear ramp over the block.
  * Streaming partitions the effective filter into hop-sized chunks and
    runs a frequency-domain delay line with 50%-overlap-save frames.
"""

from __future__ import annotations

import numpy as np

from ..config import RenderConfig
from ..data.table import (ALIGN_GUARD, DELAY_PAD, MAX_RENDER_SHIFT,
                          HrirArrays, delay_ramp)


def next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


# ------------------------------------------------------------ interpolation


def grid_weights(elevs: np.ndarray, az_counts: np.ndarray, az: float, el: float,
                 mode: str):
    """4 dense (e, a) indices + weights for direction (az, el).

    Returns (idx, w): idx int array (4, 2) of (elev_row, az_slot), w (4,)
    summing to 1. Nearest mode returns one nonzero weight.
    """
    el = float(np.clip(el, elevs[0], elevs[-1]))
    az = float(az) % 360.0

    if len(elevs) == 1:  # single-ring grid (e.g. horizontal-plane-only set)
        e0 = e1 = 0
        we = 0.0
    else:
        e1 = int(np.searchsorted(elevs, el, side="right"))
        e1 = min(max(e1, 1), len(elevs) - 1)
        e0 = e1 - 1
        we = (el - elevs[e0]) / (elevs[e1] - elevs[e0])

    def ring(e, want_nearest):
        c = int(az_counts[e])
        pos = az * c / 360.0
        if want_nearest:
            a = int(np.floor(pos + 0.5)) % c
            return [(a, 1.0)]
        a0 = int(np.floor(pos))
        wa = pos - a0
        return [(a0 % c, 1.0 - wa), ((a0 + 1) % c, wa)]

    if mode == "nearest":
        e = e0 if we < 0.5 else e1
        (a, _), = ring(e, True)
        idx = [(e, a)] * 4
        w = [1.0, 0.0, 0.0, 0.0]
    elif mode == "bilinear":
        idx, w = [], []
        for e, wgt in ((e0, 1.0 - we), (e1, we)):
            # ring() always yields exactly 2 entries (a count==1 ring
            # yields its one slot twice), so idx is always length 4 here.
            for a, wa in ring(e, False):
                idx.append((e, a))
                w.append(wgt * wa)
    else:
        raise ValueError(f"unknown interp mode {mode!r}")
    return np.array(idx, dtype=np.int64), np.array(w, dtype=np.float64)


def interpolate(table: HrirArrays, az: float, el: float, config: RenderConfig):
    """→ (h (2, T) aligned shapes, delays (2,), gains (2,)) at (az, el)."""
    elevs = np.asarray(table.elevs, dtype=np.float64)
    counts = np.asarray(table.az_counts, dtype=np.int64)
    idx, w = grid_weights(elevs, counts, az, el, config.interp)
    h = np.asarray(table.h, dtype=np.float64)
    d = np.asarray(table.delays, dtype=np.float64)
    g = np.asarray(table.gains, dtype=np.float64)
    hs = np.einsum("i,ijk->jk", w, h[idx[:, 0], idx[:, 1]])  # (2, T)
    ds = w @ d[idx[:, 0], idx[:, 1]]  # (2,)
    gs = w @ g[idx[:, 0], idx[:, 1]]  # (2,)
    if not (table.decomposed and config.apply_itd):
        # Neutral delay: filter assembly shifts by (d − ALIGN_GUARD), so
        # ALIGN_GUARD means "use the stored shape as-is" — correct both
        # for raw tables (TOA already in the data) and for ITD-less
        # renders of decomposed tables.
        ds = np.full(2, ALIGN_GUARD)
    if not (table.decomposed and config.apply_ild):
        gs = np.ones(2)
    return hs, ds, gs


# ------------------------------------------------- effective-filter assembly

# DELAY_PAD — the extra FIR length reserved for the materialised
# fractional delay — is imported from the table module, which shares it
# with the loaders' clip threshold and the renderers' assembly.


def t_eff(table: HrirArrays) -> int:
    """Length of the materialised effective filter."""
    return table.taps + DELAY_PAD


def effective_filter(h: np.ndarray, d: np.ndarray, g: np.ndarray,
                     taps: int) -> np.ndarray:
    """Materialise gain·delay(aligned shape) as a (2, taps+DELAY_PAD) FIR.

    This FIR *defines* the per-direction filter; every render mode
    convolves it verbatim (see module docstring). The delay is applied at
    the canonical FFT size `next_pow2(taps+DELAY_PAD)` — large enough that
    the shift is linear (no wraparound into the retained span). Aligned
    shapes carry their onset at +ALIGN_GUARD samples (see
    `tinaural_torch.data.table`), so the re-applied shift is `d − ALIGN_GUARD`.
    """
    T_pad = taps + DELAY_PAD
    L = next_pow2(T_pad)
    d = np.clip(d - ALIGN_GUARD, -ALIGN_GUARD, MAX_RENDER_SHIFT)
    H = np.fft.rfft(h, L) * delay_ramp(L, d) * g[..., None]
    return np.fft.irfft(H, L)[..., :T_pad]


def direction_filter(table: HrirArrays, az: float, el: float,
                     config: RenderConfig) -> np.ndarray:
    """Interpolate + assemble the (2, t_eff) effective FIR for a direction."""
    h, d, g = interpolate(table, az, el, config)
    return effective_filter(h, d, g, table.taps)


def _out_len(n: int, table: HrirArrays, config: RenderConfig) -> int:
    return n + t_eff(table) - 1 if config.out_length == "full" else n


# ------------------------------------------------------------- static render


def render_static(table: HrirArrays, x: np.ndarray, az: float, el: float,
                  config: RenderConfig = RenderConfig()) -> np.ndarray:
    """Direct FFT convolution render at a fixed direction → (2, out_len)."""
    x = np.asarray(x, dtype=np.float64)
    h_eff = direction_filter(table, az, el, config)  # (2, T_eff)
    n = next_pow2(len(x) + h_eff.shape[-1] - 1)
    X = np.fft.rfft(x, n)
    out = np.empty((2, _out_len(len(x), table, config)))
    for ear in range(2):
        out[ear] = np.fft.irfft(X * np.fft.rfft(h_eff[ear], n), n)[: out.shape[1]]
    return out


# ---------------------------------------------- trajectory (crossfade)


def snap_dirs(dirs: np.ndarray, dir_rate: int) -> np.ndarray:
    """THE definition of ``RenderConfig.dir_rate``: the per-block
    direction track (nb, 2) snapped to its value at the start of each
    ``dir_rate``-group — block b renders with dirs[(b // dir_rate) *
    dir_rate]. Everything else (crossfade, OLA, filters) is unchanged:
    a dir_rate=k render IS the dir_rate=1 render of the snapped track,
    which is what makes the fast path (assemble only the unique
    filters) provably identical rather than approximately so. The
    approximation is purely directional: the filter lags the true path
    by at most (dir_rate−1) blocks."""
    if dir_rate == 1:
        return dirs
    nb = dirs.shape[0]
    idx = (np.arange(nb) // dir_rate) * dir_rate
    return np.asarray(dirs)[idx]


def render_trajectory(table: HrirArrays, x: np.ndarray, dirs: np.ndarray,
                      config: RenderConfig = RenderConfig()) -> np.ndarray:
    """Moving-source render with crossfaded OLA block convolution.

    dirs: (n_blocks, 2) per-block (az, el); n_blocks = ceil(len(x)/block).
    → (2, out_len).
    """
    x = np.asarray(x, dtype=np.float64)
    B = config.block_size
    N = len(x)
    nb = -(-N // B)
    xp = np.zeros(nb * B)
    xp[:N] = x
    if dirs.shape != (nb, 2):
        raise ValueError(f"dirs must be ({nb}, 2), got {dirs.shape}")
    dirs = snap_dirs(dirs, config.dir_rate)

    n_fft = next_pow2(B + t_eff(table) - 1)
    ramp = (np.arange(B) + 0.5) / B if config.crossfade else np.ones(B)

    filt = [direction_filter(table, a, e, config) for a, e in dirs]  # (2, T_eff)
    acc = np.zeros((2, (nb - 1) * B + n_fft))
    for b in range(nb):
        xb = xp[b * B : (b + 1) * B]
        h_c = filt[b]
        h_p = filt[b - 1] if b > 0 else filt[0]
        Xu = np.fft.rfft(ramp * xb, n_fft)
        Xd = np.fft.rfft((1.0 - ramp) * xb, n_fft)
        for ear in range(2):
            Y = Xu * np.fft.rfft(h_c[ear], n_fft) + Xd * np.fft.rfft(h_p[ear], n_fft)
            acc[ear, b * B : b * B + n_fft] += np.fft.irfft(Y, n_fft)
    return acc[:, : _out_len(N, table, config)]


# ------------------------------------------------------------- scene mixdown


def render_scene(table: HrirArrays, xs: np.ndarray, dirs: np.ndarray,
                 config: RenderConfig = RenderConfig()) -> np.ndarray:
    """Multi-source scene → stereo mixdown (sum over sources).

    xs: (S, N). dirs: (S, 2) static directions, or (S, n_blocks, 2) for
    per-source trajectories. → (2, out_len).
    """
    xs = np.asarray(xs, dtype=np.float64)
    dirs = np.asarray(dirs, dtype=np.float64)
    S, N = xs.shape
    if dirs.ndim == 2:
        B = config.block_size
        nb = -(-N // B)
        dirs = np.broadcast_to(dirs[:, None, :], (S, nb, 2))
    out = None
    for s in range(S):
        y = render_trajectory(table, xs[s], dirs[s], config)
        out = y if out is None else out + y
    return out


# ---------------------------------------------- streaming (partition)


def partition_filter(h_eff: np.ndarray, block: int) -> np.ndarray:
    """Split a (2, T_eff) filter into hop-sized chunks → (P, 2, 2·block)
    rfft spectra for a 50%-overlap-save FDL."""
    T_eff = h_eff.shape[-1]
    P = -(-T_eff // block)
    parts = np.zeros((P, 2, block))
    for p in range(P):
        seg = h_eff[:, p * block : (p + 1) * block]
        parts[p, :, : seg.shape[-1]] = seg
    return np.fft.rfft(parts, 2 * block, axis=-1)  # (P, 2, block+1... 2B bins)


class GoldenStream:
    """Low-latency streaming renderer: uniformly partitioned
    convolution with a frequency-domain delay line, per-block HRTF update.

    Latency = one block. State = (previous input block, FDL of past input
    spectra, previous filter partitions) — the state the renderers'
    `StreamState` carries from push to push.

    With ``config.crossfade`` (default), each block is rendered under both
    the previous and the current filter and the outputs are linearly
    crossfaded over the block — the streaming analog of the trajectory
    renderer's crossfaded block convolution, suppressing
    zipper noise under head rotation. The first block's "previous" filter
    is the current one (matching the trajectory's b=0 convention).
    """

    def __init__(self, table: HrirArrays, config: RenderConfig = RenderConfig()):
        self.table = table
        self.config = config
        self.block = config.stream_block
        self.n_parts = -(-t_eff(table) // self.block)
        self.reset()

    def reset(self):
        B = self.block
        self.prev_in = np.zeros(B)
        self.fdl = np.zeros((self.n_parts, B + 1), dtype=np.complex128)
        self.prev_H = None  # set on first push

    def filter_partitions(self, az: float, el: float) -> np.ndarray:
        h_eff = direction_filter(self.table, az, el, self.config)
        return partition_filter(h_eff, self.block)  # (P, 2, B+1)

    def push(self, xb: np.ndarray, az: float, el: float) -> np.ndarray:
        """Feed one block (B,) at the current head-relative direction →
        one stereo block (2, B)."""
        B = self.block
        xb = np.asarray(xb, dtype=np.float64)
        if xb.shape != (B,):
            raise ValueError(f"block must be ({B},), got {xb.shape}")
        X = np.fft.rfft(np.concatenate([self.prev_in, xb]))  # (B+1,) bins of 2B
        self.fdl = np.concatenate([X[None], self.fdl[:-1]], axis=0)
        H = self.filter_partitions(az, el)  # (P, 2, B+1)
        Y = np.einsum("pf,pef->ef", self.fdl, H)
        y = np.fft.irfft(Y, 2 * B, axis=-1)[:, B:]
        if self.config.crossfade:
            Hp = H if self.prev_H is None else self.prev_H
            Yp = np.einsum("pf,pef->ef", self.fdl, Hp)
            yp = np.fft.irfft(Yp, 2 * B, axis=-1)[:, B:]
            w = (np.arange(B) + 0.5) / B
            y = w * y + (1.0 - w) * yp
        self.prev_in = xb
        self.prev_H = H
        return y

    def push_held(self, xb: np.ndarray) -> np.ndarray:
        """Hold-filter push: advance the FDL one block and render under
        the CARRIED filter partitions, with no reassembly and no
        crossfade blend (the filter is unchanged; blending two identical
        outputs is the identity up to one rounding). This DEFINES
        `RenderConfig.stream_update_rate` semantics: a burst at
        update_rate=k is `push` at each burst-local multiple of k and
        `push_held` in between — equivalent to update_rate=1 on the
        push-snapped direction track to f64 rounding (oracle test)."""
        B = self.block
        xb = np.asarray(xb, dtype=np.float64)
        if xb.shape != (B,):
            raise ValueError(f"block must be ({B},), got {xb.shape}")
        if self.prev_H is None:
            raise ValueError("push_held before any push: no carried filter")
        X = np.fft.rfft(np.concatenate([self.prev_in, xb]))
        self.fdl = np.concatenate([X[None], self.fdl[:-1]], axis=0)
        Y = np.einsum("pf,pef->ef", self.fdl, self.prev_H)
        y = np.fft.irfft(Y, 2 * B, axis=-1)[:, B:]
        self.prev_in = xb
        return y

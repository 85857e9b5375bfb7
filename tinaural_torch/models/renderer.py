"""Static, moving-source, batch and scene renderers.

Counterpart of `tinaural.models.renderer`'s default route. Each render
ends in one call of a route — the hand-written CUDA kernels for tensors on
the card, the plain torch versions for tensors on the CPU — picked from the
shapes and the device:
- a moving source and `render_batch`: `block_render` and
  `block_step_render` below an FFT of 4096 points, `assembly_mac_render`
  (the natural-order route) from there (`_natural_order`);
- a static scene, and a moving scene of fewer blocks than the card has SMs:
  `scene_step_render`; a larger moving scene `block_render`
  (`_scene_mixes`);
- a long static `render`: `block_step_render`; `render_streamed`:
  `partitioned_render`.
A short static `render` is one direct FFT convolution in `torch.fft` on
either device. Numerical semantics are those of
`tinaural.reference.golden` (≥60 dB SNR; f32 against f64 in practice
~90 dB).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..data.table import DELAY_PAD, TorchTable
from ..ops._layout import sm_count
from ..ops.assembly_mac import assembly_mac_render
from ..ops.block_render import block_render
from ..ops.block_step import block_step_render, scene_step_render
from ..ops.filters import effective_filter, next_pow2
from ..ops.interp import direction_weights, gather_rows
from ..ops.partitioned_conv import partitioned_render

# From this FFT size on, moving sources and render_batch take the
# natural-order route: the shapes where the JAX package refuses its
# four-step layout (n_fft/128 ≥ 32) and runs `fused_assembly_mac`.
NATURAL_ORDER_MIN_FFT = 4096


def _n_fft(table: TorchTable, B: int) -> int:
    return next_pow2(B + table.taps + DELAY_PAD - 1)


def _snap_dirs(dirs, dir_rate: int):
    """THE `RenderConfig.dir_rate` semantics (`golden.snap_dirs`): block b
    takes the direction of its group start ⌊b/k⌋·k. dirs: (..., nb, 2),
    a numpy array or a tensor."""
    if dir_rate == 1:
        return dirs
    nb = dirs.shape[-2]
    idx = (np.arange(nb) // dir_rate) * dir_rate
    return dirs[..., idx, :]


def _neighbours(table: TorchTable, dirs: torch.Tensor, config: RenderConfig):
    """dirs (..., 2) → flat table rows idx (..., 4) int32 and bilinear (or
    nearest) weights w (..., 4) f32, contiguous."""
    lead = dirs.shape[:-1]
    flat = dirs.reshape(-1, 2)
    eidx, aidx, w = direction_weights(table.elevs, table.az_counts,
                                      flat[:, 0], flat[:, 1], config.interp)
    idx = (eidx * table.a_max + aidx).to(torch.int32).reshape(*lead, 4)
    return idx, w.to(torch.float32).reshape(*lead, 4).contiguous()


def _flags(table: TorchTable, config: RenderConfig) -> dict:
    """ITD/ILD apply only to decomposed tables."""
    return dict(apply_itd=bool(table.decomposed and config.apply_itd),
                apply_ild=bool(table.decomposed and config.apply_ild))


def _natural_order(n_fft: int) -> bool:
    """Whether moving sources and render_batch take the natural-order
    route (`assembly_mac_render`) at this FFT size."""
    return n_fft >= NATURAL_ORDER_MIN_FFT


def _scene_mixes(S: int, nb: int, static: bool, sms: int) -> bool:
    """Whether a scene takes the mixdown route (`scene_step_render`)
    rather than `block_render`: always for static sources, which then
    assemble one filter each instead of one per block; for moving sources
    when there are several and fewer blocks than SMs (``sms``, 0 off the
    card), where `block_render`'s grid of nb CUDA blocks underfills the
    card and the mix kernel's (source chunk, block) grid does not."""
    return static or (S > 1 and nb < sms)


def _block_render(table: TorchTable, xbs: torch.Tensor, dirs: torch.Tensor,
                  config: RenderConfig, crossfade: bool,
                  render) -> torch.Tensor:
    """Neighbour rows/weights per (source, block) — or per source, with
    dirs (S, 1, 2) — then one render call. xbs: (S, nb, B); ``render`` is
    a route or, for checks, its plain version."""
    idx, w = _neighbours(table, dirs, config)
    return render(xbs, idx, w, table, _n_fft(table, xbs.shape[-1]),
                  crossfade=crossfade, **_flags(table, config))


def _static_core(table: TorchTable, x: torch.Tensor, dir2: torch.Tensor,
                 config: RenderConfig, n: int) -> torch.Tensor:
    """Direct FFT convolution at one direction, in x's precision. x: (N,)
    with N + taps + DELAY_PAD − 1 ≤ n; dir2: (2,) → (2, n) circular
    frame."""
    idx, w = _neighbours(table, dir2[None], config)
    h, d, g = gather_rows(table, idx, w.to(x.dtype), **_flags(table, config))
    h_eff = effective_filter(h[0], d[0], g[0], table.taps)  # (2, T_eff)
    X = torch.fft.rfft(x, n=n)
    return torch.fft.irfft(X * torch.fft.rfft(h_eff, n=n), n=n)


def _static_block_core(table: TorchTable, xb: torch.Tensor,
                       dir2: torch.Tensor, config: RenderConfig,
                       render=block_step_render) -> torch.Tensor:
    """OLA block convolution at one fixed direction: one filter, assembled
    once, serves every block, with no crossfade (between equal filters it
    is the identity). xb: (nb, B); dir2: (2,) → (2, (nb−1)·B + n_fft).
    ``render`` is `block_step_render` or, for checks, its plain version."""
    idx, w = _neighbours(table, dir2[None, None], config)
    return render(xb[None], idx, w, table, _n_fft(table, xb.shape[-1]),
                  crossfade=False, **_flags(table, config))[0]


def _batch_core(table: TorchTable, xbs: torch.Tensor, dirs: torch.Tensor,
                config: RenderConfig, render=None) -> torch.Tensor:
    """Independent renders, no mixdown: xbs (S, nb, B); dirs (S, nb, 2) →
    (S, 2, (nb−1)·B + n_fft). Crossfades per ``config.crossfade`` even
    where a source's track is constant, as the JAX package does.
    ``render`` (a route, or its plain version for checks) defaults to
    the one the shapes pick."""
    if render is None:
        render = (assembly_mac_render
                  if _natural_order(_n_fft(table, xbs.shape[-1]))
                  else block_step_render)
    dirs = _snap_dirs(dirs, config.dir_rate)
    return _block_render(table, xbs, dirs, config, config.crossfade, render)


def _trajectory_core(table: TorchTable, xb: torch.Tensor, dirs: torch.Tensor,
                     config: RenderConfig, render=None) -> torch.Tensor:
    """Crossfaded OLA block convolution. xb: (nb, B); dirs: (nb, 2) →
    (2, (nb−1)·B + n_fft). ``render`` as in `_batch_core`."""
    if render is None:
        render = (assembly_mac_render
                  if _natural_order(_n_fft(table, xb.shape[-1]))
                  else block_render)
    dirs = _snap_dirs(dirs, config.dir_rate)
    # one source: (2, out) mixed or (1, 2, out) per source, as the route has it
    return _block_render(table, xb[None], dirs[None], config,
                         config.crossfade, render).reshape(2, -1)


def _scene_core(table: TorchTable, xbs: torch.Tensor, dirs: torch.Tensor,
                config: RenderConfig, render=None) -> torch.Tensor:
    """Moving scene + stereo mixdown. xbs: (S, nb, B); dirs: (S, nb, 2) →
    (2, out). ``render`` as in `_batch_core`."""
    S, nb, _ = xbs.shape
    if render is None:
        render = (scene_step_render
                  if _scene_mixes(S, nb, False, sm_count(xbs.device))
                  else block_render)
    dirs = _snap_dirs(dirs, config.dir_rate)
    return _block_render(table, xbs, dirs, config, config.crossfade, render)


def _scene_static_core(table: TorchTable, xbs: torch.Tensor,
                       dirs: torch.Tensor, config: RenderConfig,
                       render=None) -> torch.Tensor:
    """Static-direction scene: xbs (S, nb, B); dirs (S, 2) → (2, out).
    One filter per source serves all its blocks; between equal filters the
    crossfade is the identity, so it is skipped. ``render`` as in
    `_batch_core`."""
    S, nb, _ = xbs.shape
    if render is None:
        render = (scene_step_render
                  if _scene_mixes(S, nb, True, sm_count(xbs.device))
                  else block_render)
    return _block_render(table, xbs, dirs[:, None, :], config, False, render)


def _partitioned_core(table: TorchTable, xb: torch.Tensor,
                      dirs: torch.Tensor, config: RenderConfig,
                      render=partitioned_render) -> torch.Tensor:
    """Batched partitioned convolution: the streaming renderer's map with
    every block at once. xb: (nb, B); dirs: (nb, 2) → (2, nb·B). Reads
    ``dir_rate`` (snapped track); ``stream_update_rate`` is the streams'
    knob. ``render`` is `partitioned_render` or, for checks, its plain
    version."""
    dirs = _snap_dirs(dirs, config.dir_rate)
    idx, w = _neighbours(table, dirs, config)
    return render(xb, idx, w, table, crossfade=config.crossfade,
                  **_flags(table, config))


def _dedupe_sources(xs: np.ndarray, dirs: np.ndarray, config: RenderConfig):
    """Host-side pre-mix of sources whose snapped direction tracks are
    identical: returns (xs', dirs') with one summed signal per unique
    track. Exact by linearity — every source in a group convolves the same
    per-direction FIR. The deduped count is bucketed up to a multiple of
    scene_chunk with silent sources; if bucketing erases the win, the scene
    is returned untouched."""
    S = xs.shape[0]
    static = dirs.ndim == 2
    if static:
        key = dirs
    else:
        key = np.stack([_snap_dirs(d, config.dir_rate) for d in dirs])
    uniq, inv = np.unique(key.reshape(S, -1), axis=0, return_inverse=True)
    U = uniq.shape[0]
    ch = max(config.scene_chunk, 1)
    Ub = -(-U // ch) * ch
    if Ub >= S:
        return xs, dirs
    xs_u = np.zeros((Ub, xs.shape[1]), np.float32)
    np.add.at(xs_u, np.asarray(inv).reshape(-1), xs)
    dirs_u = uniq.reshape((U, 2) if static else (U, -1, 2))
    pad = np.broadcast_to(dirs_u[-1:], (Ub - U, *dirs_u.shape[1:]))
    return xs_u, np.concatenate([dirs_u, pad], axis=0).astype(np.float32)


class BinauralRenderer:
    """Renderer facade: holds the table (on its device) and the config.
    Signals and directions come in as host arrays; outputs are tensors on
    the table's device."""

    def __init__(self, table: TorchTable, config: RenderConfig = DEFAULT_CONFIG):
        if not isinstance(table, TorchTable):
            raise TypeError("BinauralRenderer takes a TorchTable; carry host "
                            "arrays across with TorchTable.from_hrir_table")
        self.table = table
        self.config = config

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def t_eff(self) -> int:
        return self.table.taps + DELAY_PAD

    def _out_len(self, n_samples: int) -> int:
        if self.config.out_length == "full":
            return n_samples + self.t_eff - 1
        return n_samples

    def _true_nb(self, N: int) -> int:
        return -(-N // self.config.block_size)

    def _blockify(self, x: np.ndarray) -> tuple[torch.Tensor, int]:
        """Zero-pad (..., N) to whole blocks → ((..., nb, B) f32 on the
        table's device, N)."""
        B = self.config.block_size
        x = np.asarray(x, dtype=np.float32)
        N = x.shape[-1]
        nb = self._true_nb(N)
        pad = [(0, 0)] * (x.ndim - 1) + [(0, nb * B - N)]
        xb = np.pad(x, pad).reshape(*x.shape[:-1], nb, B)
        return torch.from_numpy(xb).to(self.device), N

    def _dirs(self, dirs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(dirs, np.float32)).to(self.device)

    # Signals of at least this many blocks take the OLA block route, one
    # filter for every block; shorter ones one direct FFT convolution.
    STATIC_BLOCK_THRESHOLD_BLOCKS = 8

    def render(self, x, az: float, el: float) -> torch.Tensor:
        """Render a mono signal at a fixed direction → (2, out_len)."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 1:
            raise ValueError(f"x must be a mono signal (N,), got {x.shape}")
        N = x.shape[0]
        dir2 = self._dirs(np.array([az, el], np.float32))
        if N >= self.STATIC_BLOCK_THRESHOLD_BLOCKS * self.config.block_size:
            xb, _ = self._blockify(x)
            y = _static_block_core(self.table, xb, dir2, self.config)
        else:
            n = next_pow2(N + self.t_eff - 1)
            y = _static_core(self.table, torch.from_numpy(x).to(self.device),
                             dir2, self.config, n)
        return y[:, : self._out_len(N)]

    def render_trajectory(self, x, dirs) -> torch.Tensor:
        """Moving-source render. x: (N,); dirs: (n_blocks, 2) per-block
        (az, el) → (2, out_len)."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 1:
            raise ValueError(f"x must be a mono signal (N,), got {x.shape}")
        xb, N = self._blockify(x)
        dirs = np.asarray(dirs, dtype=np.float32)
        if dirs.shape != (self._true_nb(N), 2):
            raise ValueError(
                f"dirs must be ({self._true_nb(N)}, 2), got {dirs.shape}")
        y = _trajectory_core(self.table, xb, self._dirs(dirs), self.config)
        return y[:, : self._out_len(N)]

    def render_scene(self, xs, dirs, dedupe: bool = True) -> torch.Tensor:
        """Multi-source scene → stereo mixdown. xs: (S, N); dirs: (S, 2)
        static or (S, n_blocks, 2) trajectories → (2, out_len).
        ``dedupe``: sources with identical snapped direction tracks are
        pre-mixed on the host and rendered once (exact by linearity)."""
        xs = np.asarray(xs, dtype=np.float32)
        if xs.ndim != 2:
            raise ValueError(f"xs must be (S, N), got {xs.shape}")
        S, N = xs.shape
        dirs = np.asarray(dirs, dtype=np.float32)
        static = dirs.ndim == 2
        if static and dirs.shape != (S, 2):
            raise ValueError(f"dirs must be ({S}, 2), got {dirs.shape}")
        if not static and dirs.shape != (S, self._true_nb(N), 2):
            raise ValueError(
                f"dirs must be ({S}, {self._true_nb(N)}, 2), "
                f"got {dirs.shape}")
        if dedupe:
            xs, dirs = _dedupe_sources(xs, dirs, self.config)
        xbs, N = self._blockify(xs)
        core = _scene_static_core if static else _scene_core
        y = core(self.table, xbs, self._dirs(dirs), self.config)
        return y[:, : self._out_len(N)]

    def render_batch(self, xs, dirs) -> torch.Tensor:
        """S independent mono signals, each along its own path, in one
        call, with no mixdown → (S, 2, out_len). xs: (S, N); dirs: (S, 2)
        static (broadcast to every block, so (1, 2) serves all) or
        (S, n_blocks, 2)."""
        xs = np.asarray(xs, dtype=np.float32)
        if xs.ndim != 2:
            raise ValueError(f"xs must be (S, N), got {xs.shape}")
        S, N = xs.shape
        nb = self._true_nb(N)
        dirs = np.asarray(dirs, dtype=np.float32)
        if dirs.ndim == 2:
            dirs = np.broadcast_to(dirs[:, None, :], (S, nb, 2))
        elif dirs.shape != (S, nb, 2):
            raise ValueError(f"dirs must be ({S}, {nb}, 2), got {dirs.shape}")
        xbs, N = self._blockify(xs)
        y = _batch_core(self.table, xbs, self._dirs(dirs), self.config)
        return y[:, :, : self._out_len(N)]

    def render_streamed(self, x, dirs) -> torch.Tensor:
        """What `Stream.push` would give block by block, as one batched
        partitioned convolution (frame 2·stream_block, so the filter length
        never grows the FFT). x: (N,), N a positive multiple of
        ``config.stream_block``; dirs: (n_blocks, 2) → (2, N).

        Equal to `Stream.render_offline` at the default knobs. This route
        reads ``dir_rate`` (snapped track) and ignores
        ``stream_update_rate``; the streams do the reverse, so at either
        knob > 1 the two differ by design."""
        B = self.config.stream_block
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 1:
            raise ValueError(f"x must be a mono signal (N,), got {x.shape}")
        if x.shape[0] == 0 or x.shape[0] % B:
            raise ValueError(f"signal length must be a positive multiple of {B}")
        nb = x.shape[0] // B
        dirs = np.asarray(dirs, dtype=np.float32)
        if dirs.shape != (nb, 2):
            raise ValueError(f"dirs must be ({nb}, 2), got {dirs.shape}")
        xb = torch.from_numpy(x.reshape(nb, B)).to(self.device)
        return _partitioned_core(self.table, xb, self._dirs(dirs), self.config)


def render(table: TorchTable, x, az: float, el: float,
           config: RenderConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Render a mono signal at a fixed direction (az, el) → (2, out)."""
    return BinauralRenderer(table, config).render(x, az, el)


def render_trajectory(table: TorchTable, x, dirs,
                      config: RenderConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Render a mono signal along a per-block direction path."""
    return BinauralRenderer(table, config).render_trajectory(x, dirs)


def render_scene(table: TorchTable, xs, dirs,
                 config: RenderConfig = DEFAULT_CONFIG,
                 dedupe: bool = True) -> torch.Tensor:
    """Scene render: sources → stereo mixdown."""
    return BinauralRenderer(table, config).render_scene(xs, dirs,
                                                        dedupe=dedupe)

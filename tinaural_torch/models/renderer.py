"""Static, moving-source, batch and scene renderers.

Counterpart of `tinaural.models.renderer`'s default route. Each render
ends in one call of a route — the hand-written CUDA kernels for tensors on
the card, the plain torch versions for tensors on the CPU — that `route`
picks from the kind of render, the shapes and the device:
- a moving source and `render_batch`: `block_render` and
  `block_step_render` below an FFT of 4096 points, `assembly_mac_render`
  (the natural-order route) from there;
- a static scene, and a moving scene of several sources and fewer blocks
  than the card has SMs (where `block_render`'s grid of nb CUDA blocks
  would underfill the card and the mix kernel's (source chunk, block)
  grid does not): `scene_step_render`; another moving scene
  `block_render`;
- a long static `render`: `block_step_render`; `render_streamed`:
  `partitioned_render`.
A short static `render` is one direct FFT convolution in `torch.fft` on
either device. Numerical semantics are those of
`tinaural.reference.golden` (≥60 dB SNR; f32 against f64 in practice
~90 dB).

``RenderConfig.dir_rate`` = k snaps a moving track (block b takes the
direction of block ⌊b/k⌋·k), and every route then works on one filter per
group of k blocks: the cores look up rows [::k] of the snapped track,
⌈nb/k⌉ directions a source, and pass ``dir_rate=k`` to the route, which
assembles those filters only (the JAX kernels' unique-filter path). The
output is the same as one filter per block of the snapped track. A static
source is the case k ≥ nb: one filter for all its blocks.
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
from ..utils.profiling import count, span

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


def _group_dirs(dirs, dir_rate: int):
    """One direction per group of ``dir_rate`` blocks: rows [::k] of the
    snapped track (`_snap_dirs`), block b's at row ⌊b/k⌋. dirs: (..., nb,
    2) → (..., ⌈nb/k⌉, 2). Row g of the snapped track's rows [::k] is the
    track's own row g·k, so this is a view of dirs: snapping by a gather
    first would copy a numpy index to the card, a copy that waits for
    the card."""
    return dirs[..., ::dir_rate, :]


def _neighbours(table: TorchTable, dirs: torch.Tensor, config: RenderConfig):
    """dirs (..., 2) → flat table rows idx (..., 4) int32 and bilinear (or
    nearest) weights w (..., 4) f32, contiguous. Span ``tt.lookup``."""
    with span("tt.lookup"):
        lead = dirs.shape[:-1]
        flat = dirs.reshape(-1, 2)
        eidx, aidx, w = direction_weights(table.elevs, table.az_counts,
                                          flat[:, 0], flat[:, 1],
                                          config.interp)
        idx = (eidx * table.a_max + aidx).to(torch.int32).reshape(*lead, 4)
        return idx, w.to(torch.float32).reshape(*lead, 4).contiguous()


def _flags(table: TorchTable, config: RenderConfig) -> dict:
    """ITD/ILD apply only to decomposed tables."""
    return dict(apply_itd=bool(table.decomposed and config.apply_itd),
                apply_ild=bool(table.decomposed and config.apply_ild))


def route(kind: str, S: int, nb: int, n_fft: int, sms: int):
    """THE route rule, as the module's docstring lists it: the route a
    render of ``kind`` ("trajectory", "batch", "scene", "static_scene",
    "static" or "streamed") takes over S sources × nb blocks at FFT size
    ``n_fft`` on a device of ``sms`` SMs (0 off the card), read from the
    module's globals at each call."""
    if kind in ("trajectory", "batch"):
        if n_fft >= NATURAL_ORDER_MIN_FFT:
            return assembly_mac_render
        return block_render if kind == "trajectory" else block_step_render
    if kind == "static_scene" or (kind == "scene" and S > 1 and nb < sms):
        return scene_step_render
    if kind == "scene":
        return block_render
    if kind == "static":
        return block_step_render
    if kind == "streamed":
        return partitioned_render
    raise ValueError(f"no route for a render of kind {kind!r}")


def _block_render(kind: str, table: TorchTable, xbs: torch.Tensor,
                  dirs: torch.Tensor, config: RenderConfig, crossfade: bool,
                  render, dir_rate: int) -> torch.Tensor:
    """Neighbour rows/weights of each group of ``dir_rate`` blocks, then
    one render call (span ``tt.route``). xbs: (S, nb, B); dirs: (S,
    ⌈nb/dir_rate⌉, 2); ``render`` is a route or, for checks, its plain
    version; None takes the one `route` picks for ``kind``."""
    S, nb, B = xbs.shape
    n_fft = _n_fft(table, B)
    render = render or route(kind, S, nb, n_fft, sm_count(xbs.device))
    idx, w = _neighbours(table, dirs, config)
    with span("tt.route"):
        return render(xbs, idx, w, table, n_fft, crossfade=crossfade,
                      dir_rate=dir_rate, **_flags(table, config))


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
                       render=None) -> torch.Tensor:
    """OLA block convolution at one fixed direction: one filter, assembled
    once, serves every block (dir_rate nb), with no crossfade (between
    equal filters it is the identity). xb: (nb, B); dir2: (2,) → (2,
    (nb−1)·B + n_fft). ``render`` as in `_batch_core`."""
    return _block_render("static", table, xb[None], dir2[None, None], config,
                         False, render, xb.shape[0])[0]


def _batch_core(table: TorchTable, xbs: torch.Tensor, dirs: torch.Tensor,
                config: RenderConfig, render=None) -> torch.Tensor:
    """Independent renders, no mixdown: xbs (S, nb, B); dirs (S, nb, 2) →
    (S, 2, (nb−1)·B + n_fft). Crossfades per ``config.crossfade`` even
    where a source's track is constant, as the JAX package does.
    ``render`` (a route, or its plain version for checks) defaults to
    the one `route` picks. One filter per group of ``dir_rate`` blocks
    of each source at every S: the JAX package keeps k = 1 above one
    source, where its kernel's matmuls over chunk/k rows per source would
    run too few rows for the TPU's matrix unit; a CUDA block here takes
    one row at a time."""
    k = config.dir_rate
    return _block_render("batch", table, xbs, _group_dirs(dirs, k), config,
                         config.crossfade, render, k)


def _trajectory_core(table: TorchTable, xb: torch.Tensor, dirs: torch.Tensor,
                     config: RenderConfig, render=None) -> torch.Tensor:
    """Crossfaded OLA block convolution. xb: (nb, B); dirs: (nb, 2) →
    (2, (nb−1)·B + n_fft). ``render`` as in `_batch_core`; one filter per
    group of ``dir_rate`` blocks."""
    k = config.dir_rate
    # one source: (2, out) mixed or (1, 2, out) per source, as the route has it
    return _block_render("trajectory", table, xb[None],
                         _group_dirs(dirs, k)[None], config,
                         config.crossfade, render, k).reshape(2, -1)


def _scene_core(table: TorchTable, xbs: torch.Tensor, dirs: torch.Tensor,
                config: RenderConfig, render=None) -> torch.Tensor:
    """Moving scene + stereo mixdown. xbs: (S, nb, B); dirs: (S, nb, 2) →
    (2, out). ``render`` as in `_batch_core`; one filter per group of
    ``dir_rate`` blocks of each source."""
    k = config.dir_rate
    return _block_render("scene", table, xbs, _group_dirs(dirs, k), config,
                         config.crossfade, render, k)


def _scene_static_core(table: TorchTable, xbs: torch.Tensor,
                       dirs: torch.Tensor, config: RenderConfig,
                       render=None) -> torch.Tensor:
    """Static-direction scene: xbs (S, nb, B); dirs (S, 2) → (2, out).
    One filter per source serves all its blocks (dir_rate nb); between
    equal filters the crossfade is the identity, so it is skipped.
    ``render`` as in `_batch_core`."""
    return _block_render("static_scene", table, xbs, dirs[:, None, :],
                         config, False, render, xbs.shape[1])


def _partitioned_core(table: TorchTable, xb: torch.Tensor,
                      dirs: torch.Tensor, config: RenderConfig,
                      render=None) -> torch.Tensor:
    """Batched partitioned convolution: the streaming renderer's map with
    every block at once. xb: (nb, B); dirs: (nb, 2) → (2, nb·B). Reads
    ``dir_rate`` (snapped track, one filter per group of k blocks);
    ``stream_update_rate`` is the streams' knob. ``render`` as in
    `_batch_core`."""
    nb, B = xb.shape
    render = render or route("streamed", 1, nb, 2 * B, sm_count(xb.device))
    k = config.dir_rate
    idx, w = _neighbours(table, _group_dirs(dirs, k), config)
    with span("tt.route"):
        return render(xb, idx, w, table, crossfade=config.crossfade,
                      dir_rate=k, **_flags(table, config))


def _dedupe_sources(xs: np.ndarray, dirs: np.ndarray, config: RenderConfig):
    """Host-side pre-mix of sources whose snapped direction tracks are
    identical: returns (xs', dirs') with one summed signal per unique
    track. Exact by linearity — every source in a group convolves the same
    per-direction FIR. The deduped count is bucketed up to a multiple of
    scene_chunk with silent sources; if bucketing erases the win, the scene
    is returned untouched (counter ``dedupe_rows_merged``, S less the
    bucketed count, otherwise).

    The groups, their order and the sums are `np.unique(key, axis=0)`'s
    and `np.add.at`'s, in bits, at a cost linear in the key's bytes:
    tracks are grouped in a dict of their rows' bytes (−0.0 made 0.0
    first; where some rows match, a row holding a NaN equal to no other);
    only where the premix runs are the U groups sorted lexicographically,
    and each source's row added to its group's in source order. Span
    ``tt.dedupe``."""
    with span("tt.dedupe"):
        S = xs.shape[0]
        key = dirs if dirs.ndim == 2 else _snap_dirs(dirs, config.dir_rate)
        rows = key.reshape(S, -1) + 0.0  # −0.0 → 0.0: equal rows, equal bytes
        b, n = rows.tobytes(), rows.itemsize * rows.shape[1]
        keys = [b[s * n:(s + 1) * n] for s in range(S)]
        if len(set(keys)) < S:
            # np.unique keeps a row holding a NaN apart from its equals
            for s in np.flatnonzero(np.isnan(rows).any(axis=1)):
                keys[s] = s
        group = {}  # a track's key → its first source
        head = [group.setdefault(k, s) for s, k in enumerate(keys)]
        U = len(group)
        ch = max(config.scene_chunk, 1)
        Ub = -(-U // ch) * ch
        if Ub >= S:
            return xs, dirs
        count("dedupe_rows_merged", S - Ub)
        first = np.fromiter(group.values(), np.intp, U)
        # np.unique(axis=0)'s order, column 0 the primary key; a stable
        # sort, so NaN rows alike stay in source order
        first = first[np.lexsort(rows[first].T[::-1])]
        rank = np.empty(S, np.intp)
        rank[first] = np.arange(U)
        xs_u = np.zeros((Ub, xs.shape[1]), np.float32)
        for s, h in enumerate(head):
            xs_u[rank[h]] += xs[s]
        dirs_u = key[first]
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
        """(..., N) → ((..., nb, B) f32 on the table's device, zero past
        N; N). The N samples a source cross unpadded and are framed on the
        device: a view where N is whole blocks, else one device-side pad of
        the tail. The host copies only an input that is not C-contiguous
        (counter ``blockify_host_bytes``). The blocks are always the
        program's own memory (`_to_device`), never a view of the caller's
        array. Span ``tt.blockify``; the copy is its child ``tt.h2d``."""
        B = self.config.block_size
        with span("tt.blockify"):
            x = np.asarray(x, dtype=np.float32)
            if not x.flags.c_contiguous:
                x = np.ascontiguousarray(x)
                count("blockify_host_bytes", x.nbytes)
            N = x.shape[-1]
            nb = self._true_nb(N)
            out = self._to_device(x)
            if nb * B > N:
                out = torch.nn.functional.pad(out, (0, nb * B - N))
            return out.reshape(*x.shape[:-1], nb, B), N

    def _dirs(self, dirs: np.ndarray) -> torch.Tensor:
        return self._to_device(np.ascontiguousarray(dirs, np.float32))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array's copy to the table's device, always a fresh tensor
        (span ``tt.h2d``, counter ``h2d_bytes``). On the card the array is
        copied into page-locked memory from torch's process-wide caching
        host allocator, on torch's intra-op threads, before this returns,
        then sent on the current stream without waiting for it (counter
        ``h2d_pinned_bytes``): the caller may overwrite its array at once,
        and the allocator hands the block out again only after the copy's
        recorded event has passed. One block for the whole array: on the
        H100's host more blocks, each overlapping the last one's copy to
        the card, made the host's part slower."""
        with span("tt.h2d"):
            count("h2d_bytes", a.nbytes)
            host = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type != "cuda":
                return host.to(self.device, copy=True)
            count("h2d_pinned_bytes", a.nbytes)
            # not `pin_memory()`, which hands back an array already in
            # page-locked memory as it is: the caller's own memory
            stage = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            stage.copy_(host)
            return stage.to(self.device, non_blocking=True)

    # Signals of at least this many blocks take the OLA block route, one
    # filter for every block; shorter ones one direct FFT convolution.
    STATIC_BLOCK_THRESHOLD_BLOCKS = 8

    def render(self, x, az: float, el: float) -> torch.Tensor:
        """Render a mono signal at a fixed direction → (2, out_len)."""
        with span("tt.render"):
            x = np.asarray(x, dtype=np.float32)
            if x.ndim != 1:
                raise ValueError(
                    f"x must be a mono signal (N,), got {x.shape}")
            N = x.shape[0]
            dir2 = self._dirs(np.array([az, el], np.float32))
            if N >= (self.STATIC_BLOCK_THRESHOLD_BLOCKS
                     * self.config.block_size):
                xb, _ = self._blockify(x)
                y = _static_block_core(self.table, xb, dir2, self.config)
            else:
                n = next_pow2(N + self.t_eff - 1)
                y = _static_core(self.table, self._to_device(x), dir2,
                                 self.config, n)
            return y[:, : self._out_len(N)]

    def render_trajectory(self, x, dirs) -> torch.Tensor:
        """Moving-source render. x: (N,); dirs: (n_blocks, 2) per-block
        (az, el) → (2, out_len)."""
        with span("tt.render_trajectory"):
            x = np.asarray(x, dtype=np.float32)
            if x.ndim != 1:
                raise ValueError(
                    f"x must be a mono signal (N,), got {x.shape}")
            xb, N = self._blockify(x)
            dirs = np.asarray(dirs, dtype=np.float32)
            if dirs.shape != (self._true_nb(N), 2):
                raise ValueError(
                    f"dirs must be ({self._true_nb(N)}, 2), got {dirs.shape}")
            y = _trajectory_core(self.table, xb, self._dirs(dirs),
                                 self.config)
            return y[:, : self._out_len(N)]

    def render_scene(self, xs, dirs, dedupe: bool = True) -> torch.Tensor:
        """Multi-source scene → stereo mixdown. xs: (S, N); dirs: (S, 2)
        static or (S, n_blocks, 2) trajectories → (2, out_len).
        ``dedupe``: sources with identical snapped direction tracks are
        pre-mixed on the host and rendered once (exact by linearity)."""
        with span("tt.render_scene"):
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
        with span("tt.render_batch"):
            xs = np.asarray(xs, dtype=np.float32)
            if xs.ndim != 2:
                raise ValueError(f"xs must be (S, N), got {xs.shape}")
            S, N = xs.shape
            nb = self._true_nb(N)
            dirs = np.asarray(dirs, dtype=np.float32)
            if dirs.ndim == 2:
                dirs = np.broadcast_to(dirs[:, None, :], (S, nb, 2))
            elif dirs.shape != (S, nb, 2):
                raise ValueError(
                    f"dirs must be ({S}, {nb}, 2), got {dirs.shape}")
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
        with span("tt.render_streamed"):
            B = self.config.stream_block
            x = np.asarray(x, dtype=np.float32)
            if x.ndim != 1:
                raise ValueError(
                    f"x must be a mono signal (N,), got {x.shape}")
            if x.shape[0] == 0 or x.shape[0] % B:
                raise ValueError(
                    f"signal length must be a positive multiple of {B}")
            nb = x.shape[0] // B
            dirs = np.asarray(dirs, dtype=np.float32)
            if dirs.shape != (nb, 2):
                raise ValueError(f"dirs must be ({nb}, 2), got {dirs.shape}")
            xb = self._to_device(x.reshape(nb, B))
            return _partitioned_core(self.table, xb, self._dirs(dirs),
                                     self.config)


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

"""Low-latency streaming renderer.

Counterpart of `tinaural.models.streaming`: uniformly partitioned
overlap-save convolution with a frequency-domain delay line (FDL) and a
per-block head-rotation filter update, on the semantics of
`tinaural.reference.golden.GoldenStream` (`push`, `push_held`).

The carried state is a `StreamState` with the JAX package's six field
names, shapes and float32 re/im planes (a leading S axis for
`BatchedStream`), so a state carries across with `StreamState.from_numpy`
and back with `to_numpy`. Each push returns a new state and writes no
tensor in place, so a saved ``state`` survives later pushes and resumes
bit-identically.

Every update push is `ops.partitioned_conv.stream_step`, every held push
(``stream_update_rate`` k > 1: burst-local pushes 0, k, 2k, … update, the
rest hold the carried partitions) `stream_hold`. The table's device picks
the route: the CUDA kernels on the card, the plain torch versions on the
CPU. A push on device-staged inputs makes no host synchronisation.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..data.table import TorchTable
from ..ops.filters import n_parts
from ..ops.partitioned_conv import stream_hold, stream_step
from .renderer import _flags, _neighbours


def _as_f32(x, device: torch.device) -> torch.Tensor:
    """DIRECTION inputs (degrees) → float32 on ``device``. No PCM scaling:
    an int16 direction array means degrees, not samples."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def _as_pcm_f32(x, device: torch.device) -> torch.Tensor:
    """AUDIO-block inputs → float32 on ``device``, except int16, which moves
    as int16 and scales by 2^-15 on the device (the `read_wav` PCM
    convention; half the host→device bytes)."""
    if isinstance(x, np.ndarray) and x.dtype == np.int16:
        x = torch.from_numpy(x)
    if isinstance(x, torch.Tensor) and x.dtype == torch.int16:
        return x.to(device).to(torch.float32) * 2.0**-15
    return _as_f32(x, device)


class StreamState(NamedTuple):
    """Carried streaming state: the previous input block (B,), the FDL of
    the last P frame spectra (P, B+1) as re/im planes, the previous filter
    partitions (P, 2, B+1) as re/im planes, and a started flag (0.0 before
    the first push). `BatchedStream` adds a leading S axis to each."""

    prev_in: torch.Tensor
    fdl_re: torch.Tensor
    fdl_im: torch.Tensor
    prev_h_re: torch.Tensor
    prev_h_im: torch.Tensor
    started: torch.Tensor

    @classmethod
    def from_numpy(cls, fields: Any, device) -> "StreamState":
        """Carry any state with these six attributes across (the JAX
        package's `StreamState`, or one from `to_numpy`), reading each
        through `np.asarray` into a float32 tensor on ``device``."""
        return cls(*(torch.tensor(np.asarray(getattr(fields, f)),
                                  dtype=torch.float32, device=device)
                     for f in cls._fields))

    def to_numpy(self) -> "StreamState":
        """The state as float32 numpy arrays, field by field."""
        return StreamState(*(t.detach().to("cpu", torch.float32).numpy()
                             for t in self))


def _n_parts(table: TorchTable, config: RenderConfig) -> int:
    return n_parts(table.taps, config.stream_block)


def init_state(table: TorchTable, config: RenderConfig,
               n_streams: int | None = None) -> StreamState:
    """A fresh state on the table's device; with ``n_streams``, one for
    each of S streams."""
    B = config.stream_block
    P = _n_parts(table, config)
    lead = () if n_streams is None else (n_streams,)
    z = lambda *shape: torch.zeros((*lead, *shape), dtype=torch.float32,
                                   device=table.device)
    return StreamState(prev_in=z(B), fdl_re=z(P, B + 1), fdl_im=z(P, B + 1),
                       prev_h_re=z(P, 2, B + 1), prev_h_im=z(P, 2, B + 1),
                       started=z())


def _lift(state: StreamState) -> StreamState:
    return StreamState(*(t[None] for t in state))


def _drop(state: StreamState) -> StreamState:
    return StreamState(*(t[0] for t in state))


def _batch_step_core(table: TorchTable, state: StreamState, xbs, azs, els,
                     config: RenderConfig, step=stream_step):
    """S streams advance one block under filters assembled for (azs, els).
    xbs (S, B); azs, els (S,) → (state', y (S, 2, B)). ``step`` is
    `stream_step` or, for checks, its plain version. The kernels take
    contiguous blocks, and a burst may be a view (``render_offline``
    transposes (S, nb, B) to (nb, S, B))."""
    idx, w = _neighbours(table, torch.stack([azs, els], dim=-1), config)
    y, pin, fr, fi, hr, hi = step(
        table, idx, w, xbs.contiguous(), state.prev_in, state.fdl_re,
        state.fdl_im, state.prev_h_re, state.prev_h_im, state.started,
        crossfade=config.crossfade, **_flags(table, config))
    return StreamState(pin, fr, fi, hr, hi,
                       torch.ones_like(state.started)), y


def _batch_hold_core(state: StreamState, xbs, hold=stream_hold):
    """S streams advance one block under their carried partitions, with
    no blend (`GoldenStream.push_held`); prev_h is carried unchanged."""
    y, pin, fr, fi = hold(xbs.contiguous(), state.prev_in, state.fdl_re,
                          state.fdl_im, state.prev_h_re, state.prev_h_im,
                          state.started)
    return StreamState(pin, fr, fi, state.prev_h_re, state.prev_h_im,
                       torch.ones_like(state.started)), y


def _step_core(table, state, xb, az, el, config, step=stream_step):
    """One stream, one block: xb (B,); az, el () → (state', y (2, B))."""
    st, y = _batch_step_core(table, _lift(state), xb[None], az[None],
                             el[None], config, step)
    return _drop(st), y[0]


def _batch_scan_core(table, state, xbs, azs, els, config, step=stream_step,
                     hold=stream_hold):
    """K chained batched pushes: xbs (K, S, B), azs/els (K, S) →
    (state', ys (K, S, 2, B)). At ``stream_update_rate`` k, burst-local
    pushes 0, k, 2k, … update the filter and the rest hold it (their
    directions are ignored); every burst starts with an update, so the
    schedule needs no counter in the state."""
    k = config.stream_update_rate
    ys = []
    for i in range(xbs.shape[0]):
        if i % k == 0:
            state, y = _batch_step_core(table, state, xbs[i], azs[i], els[i],
                                        config, step)
        else:
            state, y = _batch_hold_core(state, xbs[i], hold)
        ys.append(y)
    return state, torch.stack(ys)


def _scan_core(table, state, xbs, dirs, config, step=stream_step,
               hold=stream_hold):
    """One stream over nb blocks: xbs (nb, B), dirs (nb, 2) → (state',
    (2, nb·B)), on `_batch_scan_core`'s schedule."""
    st, ys = _batch_scan_core(table, _lift(state), xbs[:, None],
                              dirs[:, None, 0], dirs[:, None, 1], config,
                              step, hold)
    return _drop(st), ys[:, 0].permute(1, 0, 2).reshape(2, -1)


def _validate_many(blocks, azs, els, n_streams: int, B: int, device):
    """`push_many`'s input contract: blocks (K, S, B); azs/els (K, S), or
    (S,) held over the burst → the validated float32 triple on device."""
    blocks = _as_pcm_f32(blocks, device)
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (n_streams, B):
        raise ValueError(f"blocks must be (K, {n_streams}, {B}), "
                         f"got {tuple(blocks.shape)}")
    K = blocks.shape[0]
    azs, els = _as_f32(azs, device), _as_f32(els, device)
    if tuple(azs.shape) == (n_streams,):
        azs = azs[None].expand(K, n_streams)
    if tuple(els.shape) == (n_streams,):
        els = els[None].expand(K, n_streams)
    if tuple(azs.shape) != (K, n_streams) or els.shape != azs.shape:
        raise ValueError(f"azs/els must be ({K}, {n_streams}) or "
                         f"({n_streams},), got {tuple(azs.shape)}/"
                         f"{tuple(els.shape)}")
    return blocks, azs, els


class _StreamBase:
    """State handling shared by `Stream` and `BatchedStream`."""

    _n_streams: int | None = None

    def __init__(self, table: TorchTable,
                 config: RenderConfig = DEFAULT_CONFIG):
        if not isinstance(table, TorchTable):
            raise TypeError("streams take a TorchTable; carry host arrays "
                            "across with TorchTable.from_hrir_table")
        self.table = table
        self.config = config
        self.reset()

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def block_size(self) -> int:
        return self.config.stream_block

    @property
    def state(self) -> StreamState:
        """The checkpointable state. Pushes never write it in place."""
        return self._state

    @state.setter
    def state(self, value) -> None:
        if isinstance(value, StreamState) and all(
                isinstance(t, torch.Tensor) for t in value):
            value = StreamState(*(t.to(self.device, torch.float32)
                                  .contiguous() for t in value))
        else:
            value = StreamState.from_numpy(value, self.device)
        want = init_state(self.table, self.config, self._n_streams)
        for f, t, ref in zip(StreamState._fields, value, want):
            if t.shape != ref.shape:
                raise ValueError(f"state.{f} must be {tuple(ref.shape)}, "
                                 f"got {tuple(t.shape)}")
        self._state = value

    def reset(self) -> None:
        self._state = init_state(self.table, self.config, self._n_streams)


class BatchedStream(_StreamBase):
    """S independent low-latency streams advanced by one call per block
    (serving mode): the state carries a leading S axis.

    >>> bs = BatchedStream(table, n_streams=16, config=cfg)
    >>> stereo = bs.push(blocks, azs, els)   # (16, B), (16,), (16,) → (16, 2, B)
    """

    def __init__(self, table: TorchTable, n_streams: int,
                 config: RenderConfig = DEFAULT_CONFIG):
        if n_streams < 1:
            raise ValueError(f"n_streams must be ≥ 1, got {n_streams}")
        self._n_streams = n_streams
        super().__init__(table, config)

    @property
    def n_streams(self) -> int:
        return self._n_streams

    def push(self, blocks, azs, els) -> torch.Tensor:
        """blocks (S, B); azs, els (S,) → (S, 2, B). Always updates the
        filters. Tensors already on the table's device are used as they
        are."""
        blocks = _as_pcm_f32(blocks, self.device)
        azs, els = _as_f32(azs, self.device), _as_f32(els, self.device)
        S, B = self.n_streams, self.block_size
        if tuple(blocks.shape) != (S, B):
            raise ValueError(f"blocks must be ({S}, {B}), "
                             f"got {tuple(blocks.shape)}")
        if tuple(azs.shape) != (S,) or els.shape != azs.shape:
            raise ValueError(f"azs/els must be ({S},), got "
                             f"{tuple(azs.shape)}/{tuple(els.shape)}")
        self._state, y = _batch_step_core(self.table, self._state, blocks,
                                          azs, els, self.config)
        return y

    def push_many(self, blocks, azs, els) -> torch.Tensor:
        """Advance every stream K blocks in one call: blocks (K, S, B);
        azs, els (K, S), or (S,) held over the burst → (K, S, 2, B).

        At ``stream_update_rate`` 1 this equals K `push` calls. At k > 1
        only burst-local pushes 0, k, 2k, … reassemble the filters; the
        rest render under the carried partitions and their directions are
        ignored (golden `push`/`push_held`)."""
        blocks, azs, els = _validate_many(blocks, azs, els, self.n_streams,
                                          self.block_size, self.device)
        self._state, ys = _batch_scan_core(self.table, self._state, blocks,
                                           azs, els, self.config)
        return ys

    def render_offline(self, xs, dirs) -> torch.Tensor:
        """Whole signals of every stream through the streaming schedule
        (the state advances): xs (S, N), N a multiple of the block size;
        dirs (S, nb, 2) → (S, 2, N)."""
        B, S = self.block_size, self.n_streams
        xs = _as_pcm_f32(xs, self.device)
        if xs.dim() != 2 or xs.shape[0] != S or xs.shape[1] % B:
            raise ValueError(f"xs must be ({S}, N) with N a multiple of {B}, "
                             f"got {tuple(xs.shape)}")
        nb = xs.shape[1] // B
        dirs = _as_f32(dirs, self.device)
        if tuple(dirs.shape) != (S, nb, 2):
            raise ValueError(f"dirs must be ({S}, {nb}, 2), "
                             f"got {tuple(dirs.shape)}")
        ys = self.push_many(xs.reshape(S, nb, B).transpose(0, 1),
                            dirs[..., 0].T, dirs[..., 1].T)  # (nb, S, 2, B)
        return ys.permute(1, 2, 0, 3).reshape(S, 2, nb * B)


class Stream(_StreamBase):
    """Real-time streaming binaural renderer; latency = one block.

    >>> s = Stream(table, RenderConfig(stream_block=256))
    >>> stereo = s.push(mono_block, az=30.0, el=0.0)   # (2, 256)
    """

    def push(self, block, az, el) -> torch.Tensor:
        """One mono block (B,) at the current head-relative direction →
        one stereo block (2, B). Always updates the filter."""
        block = _as_pcm_f32(block, self.device)
        if tuple(block.shape) != (self.block_size,):
            raise ValueError(f"block must be ({self.block_size},), "
                             f"got {tuple(block.shape)}")
        self._state, y = _step_core(self.table, self._state, block,
                                    _as_f32(az, self.device),
                                    _as_f32(el, self.device), self.config)
        return y

    def push_many(self, blocks, azs, els) -> torch.Tensor:
        """K blocks in one call: blocks (K, B); azs, els (K,), or scalars
        held over the burst → (K, 2, B), on `BatchedStream.push_many`'s
        update schedule."""
        blocks = _as_pcm_f32(blocks, self.device)
        if blocks.dim() != 2:
            raise ValueError(f"blocks must be (K, {self.block_size}), "
                             f"got {tuple(blocks.shape)}")
        # (K,) → (K, 1) per push; a scalar → (1,), held over the burst
        azs, els = (a.reshape(-1, 1) if a.dim() else a.reshape(1)
                    for a in (_as_f32(azs, self.device),
                              _as_f32(els, self.device)))
        blocks, azs, els = _validate_many(blocks[:, None], azs, els, 1,
                                          self.block_size, self.device)
        st, ys = _batch_scan_core(self.table, _lift(self._state), blocks,
                                  azs, els, self.config)
        self._state = _drop(st)
        return ys[:, 0]

    def render_offline(self, x, dirs) -> torch.Tensor:
        """Whole-signal streaming render (the state advances): x (N,) with
        N a multiple of the block size; dirs (nb, 2) → (2, N)."""
        B = self.block_size
        x = _as_pcm_f32(x, self.device)
        if x.dim() != 1 or x.shape[0] % B:
            raise ValueError(f"signal length must be a multiple of {B}")
        nb = x.shape[0] // B
        dirs = _as_f32(dirs, self.device)
        if tuple(dirs.shape) != (nb, 2):
            raise ValueError(f"dirs must be ({nb}, 2), got {tuple(dirs.shape)}")
        self._state, y = _scan_core(self.table, self._state,
                                    x.reshape(nb, B), dirs, self.config)
        return y

"""Stream-sharded real-time serving.

Streams are independent: a listener's state never meets another's. So
serving shards the listeners over the mesh's ``src`` axis with no
collective at all: each rank advances its slice of the listeners through
the single-device streaming step (`models.streaming`) and holds that
slice's state. The state keeps `StreamState`'s fields and shapes, with a
leading axis of the rank's listeners, so checkpoint and resume work per
rank, and a slice of the JAX package's sharded state carries across.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..data.table import TorchTable
from ..models.streaming import (BatchedStream, StreamState, _as_f32,
                                _as_pcm_f32, _validate_many)
from .mesh import axis, check_table


class ShardedBatchedStream:
    """``n_streams`` low-latency streams sharded over the mesh's ``src``
    axis: each rank serves its ``rows`` of the listeners, one step a
    block, with no collective.

    >>> svc = ShardedBatchedStream(table, n_streams=256, mesh=mesh)
    >>> stereo = svc.push(blocks, azs, els)  # (256, B) → (256/src, 2, B)

    ``push`` and ``push_many`` take every listener's inputs and return the
    rank's rows. ``n_streams`` must divide over the ``src`` size (pad with
    silent listeners: their states are independent, so padding is exact).
    Ranks along ``blk`` serve the same rows."""

    def __init__(self, table: TorchTable, n_streams: int, mesh,
                 config: RenderConfig = DEFAULT_CONFIG):
        check_table(table, mesh)
        rank, shards = axis(mesh, "src")
        if n_streams % shards:
            raise ValueError(
                f"n_streams ({n_streams}) must be a multiple of the mesh's "
                f"src shards ({shards}); pad with silent listeners")
        per = n_streams // shards
        self.config = config
        self.n_streams = n_streams
        self.mesh = mesh
        self.rows = slice(rank * per, (rank + 1) * per)
        self._local = BatchedStream(table, per, config)

    @property
    def device(self) -> torch.device:
        return self._local.device

    @property
    def state(self) -> StreamState:
        """This rank's checkpointable state: a `StreamState` whose fields
        lead with the rank's listeners, ``rows``."""
        return self._local.state

    @state.setter
    def state(self, value) -> None:
        """Takes the rank's slice, or a state of every listener (leading
        axis ``n_streams``: this package's, the JAX package's, or numpy
        arrays with `StreamState`'s field names), of which it keeps
        ``rows``."""
        lead = getattr(value, StreamState._fields[0]).shape[0]
        if lead == self.n_streams != self._local.n_streams:
            value = StreamState(*(getattr(value, f)[self.rows]
                                  for f in StreamState._fields))
        self._local.state = value

    def push(self, blocks, azs, els) -> torch.Tensor:
        """blocks (S, B); azs, els (S,) for every listener → the rank's
        rows of the output, (S/src, 2, B)."""
        S, B = self.n_streams, self.config.stream_block
        blocks = _as_pcm_f32(blocks, self.device)
        azs, els = _as_f32(azs, self.device), _as_f32(els, self.device)
        if tuple(blocks.shape) != (S, B):
            raise ValueError(f"blocks must be ({S}, {B}), "
                             f"got {tuple(blocks.shape)}")
        if tuple(azs.shape) != (S,) or els.shape != azs.shape:
            raise ValueError(f"azs/els must be ({S},), got "
                             f"{tuple(azs.shape)}/{tuple(els.shape)}")
        r = self.rows
        return self._local.push(blocks[r], azs[r], els[r])

    def push_many(self, blocks, azs, els) -> torch.Tensor:
        """K blocks of every listener in one call: blocks (K, S, B); azs,
        els (K, S), or (S,) held over the burst → the rank's rows,
        (K, S/src, 2, B), on `BatchedStream.push_many`'s update
        schedule."""
        blocks, azs, els = _validate_many(blocks, azs, els, self.n_streams,
                                          self.config.stream_block,
                                          self.device)
        r = self.rows
        return self._local.push_many(blocks[:, r], azs[:, r], els[:, r])

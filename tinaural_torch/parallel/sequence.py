"""Block-sharded long-signal rendering: the sequence-parallel axis.

The blocks of one long signal shard over the mesh's ``blk`` axis: each
rank renders its contiguous span with the single-device trajectory core
(`models.renderer._trajectory_core`). The only dependency between spans
is each span's overlap-add tail (n_fft − B samples), which one send
carries to the next rank (`batch_isend_irecv` on the ``blk`` group), a
nearest-neighbour halo. The span count is padded so that every span
covers a whole tail, and one hop suffices.

The crossfade needs one more, smaller halo: a span's first block
crossfades against the previous span's last filter. Directions are
passed to every rank whole, so each span renders one leading silent
block that carries the previous span's last direction, and drops its
output.

``dir_rate`` snaps the direction track at global block indices, before
the track is cut into spans; the spans then render at dir_rate 1 on the
snapped track. Snapping per span would misalign every group with the
leading block and the span's offset. dir_rate k is dir_rate 1 on the
snapped track, so the output is the same; the spans assemble a filter
for every block.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG, RenderConfig
from ..data.table import DELAY_PAD, TorchTable
from ..models.renderer import _n_fft, _snap_dirs, _trajectory_core
from .mesh import axis, check_table


def _halo(main: torch.Tensor, tail: torch.Tensor, mesh) -> None:
    """Send this span's tail to the next rank along ``blk`` and add the
    previous rank's tail onto the head of ``main``, in place."""
    i, n = axis(mesh, "blk")
    if n == 1:
        return
    peers = mesh["blk"].mesh.tolist()  # global ranks along blk
    group = mesh.get_group("blk")
    incoming = torch.empty_like(tail)
    ops = []
    if i + 1 < n:
        ops.append(dist.P2POp(dist.isend, tail, peers[i + 1], group))
    if i > 0:
        ops.append(dist.P2POp(dist.irecv, incoming, peers[i - 1], group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if i > 0:
        main[:, :tail.shape[-1]] += incoming


def render_long_sharded(table: TorchTable, x, dirs, mesh,
                        config: RenderConfig = DEFAULT_CONFIG
                        ) -> torch.Tensor:
    """One long mono signal, its blocks sharded over the mesh's ``blk``
    axis → (2, N) for ``out_length="same"`` or (2, N + t_eff − 1) for
    ``"full"``, as the unsharded `render_trajectory`, on every rank.

    Every rank passes the whole signal: x (N,); dirs (n_blocks, 2). The
    block count pads up to the shards, at least ⌈(n_fft − B)/B⌉ blocks a
    shard; padded blocks are silent and hold the last direction. Ranks
    along ``src`` render the same spans."""
    check_table(table, mesh)
    B = config.block_size
    x = np.asarray(x, dtype=np.float32)
    if x.ndim != 1:
        raise ValueError(f"x must be a mono signal (N,), got {x.shape}")
    N = x.shape[0]
    nb = -(-N // B)
    dirs = np.asarray(dirs, dtype=np.float32)
    if dirs.shape != (nb, 2):
        raise ValueError(f"dirs must be ({nb}, 2), got {dirs.shape}")
    dirs = _snap_dirs(dirs, config.dir_rate)
    config = config.replace(dir_rate=1)

    i, n = axis(mesh, "blk")
    n_fft = _n_fft(table, B)
    per = max(-(-nb // n), -(-(n_fft - B) // B))  # blocks a shard
    dirs_p = np.concatenate([dirs, np.repeat(dirs[-1:], per * n - nb, 0)])
    lo = i * per
    # the span behind one silent block, which takes the previous span's
    # last direction; blocks past the signal are silent
    span = x[lo * B:(lo + per) * B]
    xb_ext = np.zeros((per + 1) * B, np.float32)
    xb_ext[B:B + span.size] = span
    dirs_ext = dirs_p[max(lo - 1, 0):lo + per]
    if lo == 0:
        dirs_ext = np.concatenate([dirs_p[:1], dirs_ext])
    dev = table.device
    xb = torch.from_numpy(xb_ext.reshape(per + 1, B)).to(dev)
    dirs_t = torch.from_numpy(np.ascontiguousarray(dirs_ext)).to(dev)
    y = _trajectory_core(table, xb, dirs_t, config)
    y = y[:, B:].contiguous()  # (2, per·B + n_fft − B): span, then tail
    _halo(y[:, :per * B], y[:, per * B:].contiguous(), mesh)

    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=mesh.get_group("blk"))
    spans = [p[:, :per * B] for p in parts] + [parts[-1][:, per * B:]]
    full = torch.cat(spans, dim=1)
    out = N + table.taps + DELAY_PAD - 1 if config.out_length == "full" else N
    return full[:, :out]

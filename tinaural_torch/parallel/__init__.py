"""The parallel layer over `torch.distributed`: a (src, blk) device mesh,
source-sharded scenes, block-sharded long signals with their overlap-add
halo, stream-sharded serving and source-sharded fitting."""

from .fit import fit_step_sharded, scene_loss_sharded
from .mesh import make_mesh
from .scene import render_scene_sharded
from .sequence import render_long_sharded
from .streams import ShardedBatchedStream

__all__ = [
    "make_mesh",
    "render_scene_sharded",
    "render_long_sharded",
    "fit_step_sharded",
    "scene_loss_sharded",
    "ShardedBatchedStream",
]

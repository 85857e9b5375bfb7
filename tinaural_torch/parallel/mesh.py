"""The (src, blk) device mesh over `torch.distributed`.

The workload has two shardable axes:

  * ``"src"``: scene sources and stream listeners (data parallel). Each
    rank renders its slice of the sources; a scene ends in one SUM
    all-reduce of the stereo mixdown, the streams in none.
  * ``"blk"``: the blocks of one long signal (the sequence axis). Block
    convolutions are independent but for the overlap-add tail, which one
    send to the next rank carries: a nearest-neighbour halo.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with those two
dimension names, over a default process group that the caller
initialised (`launch.spawn`, ``torchrun``, or `init_process_group` with a
``file://`` or ``tcp://`` rendezvous). NCCL runs the collectives of a CUDA
mesh, gloo those of a CPU mesh.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

AXES = ("src", "blk")
DEVICE_TYPES = ("cuda", "cpu")


def make_mesh(shape: tuple[int, int] | None = None,
              device_type: str = "cuda"):
    """A 2-D (src, blk) mesh over every rank of the default group.

    With ``shape=None`` all ranks go to the source axis. Raises
    RuntimeError without an initialised default group, or for a CUDA mesh
    without a card (there is no fallback to the CPU); ValueError for a
    shape whose product is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in DEVICE_TYPES:
        raise ValueError(f"device_type must be one of {DEVICE_TYPES}, "
                         f"got {device_type!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group, "
                           "tinaural_torch.parallel.launch.spawn or torchrun)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') needs a CUDA card; "
                           "pass device_type='cpu' for a CPU mesh")
    n = dist.get_world_size()
    shape = (n, 1) if shape is None else tuple(shape)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def rank_device(mesh) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` on a CUDA mesh (LOCAL_RANK
    as `launch.spawn` and torchrun set it, else the global rank modulo the
    card count), the CPU on a CPU mesh."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else dist.get_rank() % torch.cuda.device_count())
    return torch.device("cuda", index)


def axis(mesh, name: str) -> tuple[int, int]:
    """(this rank's index along the mesh axis ``name``, the axis' size)."""
    return mesh.get_local_rank(name), mesh.size(AXES.index(name))


def check_table(table, mesh) -> None:
    """The table must sit on the mesh's kind of device: NCCL moves CUDA
    tensors only, and a CPU mesh renders on the CPU."""
    if table.device.type != mesh.device_type:
        raise ValueError(f"the table is on {table.device}, the mesh on "
                         f"{mesh.device_type} devices")

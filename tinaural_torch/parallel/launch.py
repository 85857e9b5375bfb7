"""Start one process a rank, joined by a file rendezvous.

    spawn(fn, world_size, "cpu", *args)   # gloo
    spawn(fn, world_size, "cuda", *args)  # NCCL, rank r on cuda:r

Each rank initialises the default process group, calls ``fn(*args)`` and
destroys the group; rank 0's return value comes back to the caller. ``fn``
and ``args`` are pickled into each rank (fn by its import path), and each
rank starts from a fresh interpreter. A user who starts the ranks with
``torchrun`` initialises the group there and does not need this module.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_RESULT = "rank0.pkl"


def spawn(fn, world_size: int, device_type: str, *args, workdir=None):
    """Run fn(*args) on ``world_size`` ranks over the backend that
    ``device_type`` implies (never another) → rank 0's return value.

    The rendezvous file and rank 0's result live in a fresh temporary
    directory, under ``workdir`` where given. A rank that raises ends the
    others, and the error comes back as torch's ProcessRaisedException."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {tuple(BACKENDS)}, "
                         f"got {device_type!r}")
    if world_size < 1:
        raise ValueError(f"world_size must be ≥ 1, got {world_size}")
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, args, world_size, device_type, d),
            nprocs=world_size, join=True, start_method="spawn")
        with open(os.path.join(d, _RESULT), "rb") as f:
            return pickle.load(f)


def _rank_main(rank: int, fn, args, world_size: int, device_type: str,
               workdir: str) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        BACKENDS[device_type],
        init_method="file://" + os.path.join(workdir, "rendezvous"),
        world_size=world_size, rank=rank)
    try:
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(workdir, _RESULT), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()

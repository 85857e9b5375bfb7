#!/usr/bin/env python3
"""Host-to-device staging rates of one host float32 array on one CUDA card:
the forms `BinauralRenderer._to_device` could take, timed side by side.

    python3 scripts/torch_h2d_staging.py [--mb 33.5] [--reps 8]
        [--out FILE] [--small]

The array is white noise as the benchmark's offline cells make it (2^23
float32 samples, 33.5 MB, by default); four such arrays are cycled, so no
copy finds its source in the CPU's caches. Forms:

- ``pageable``: ``torch.from_numpy(a).to(dev)``;
- ``pinned``: one page-locked block from torch's caching host allocator,
  filled by a CPU ``copy_`` on ``t`` intra-op threads, then one
  ``non_blocking`` copy to the card;
- ``chunked``: the same a chunk at a time, each chunk its own block of the
  cache, so the host copy of chunk k+1 overlaps the card's read of chunk
  k;
- ``ring``: a fixed ring of 4 page-locked chunks allocated once, each
  reused after its CUDA event says the card has read it.

each pinned form at 1, 2, 4 threads and at torch's default, the chunked
ones at several chunk sizes. A form's host ms is from its start to its
return; its end ms stops after `torch.cuda.synchronize()`. Each line gives
the median and quartiles of each over ``reps`` × 4 calls, and the rates
they give (GB/s, 1e9 bytes). Every form's output is checked equal in bits
to the array. The card's name and power limit, the CPUs this process may
run on and torch's thread count come first; with ``--out`` the lines are
also written to that file as JSON. ``--small`` runs a 1 MB array on the
CPU's own copies, to rehearse the script without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

RING_SLOTS = 4
PIN = torch.cuda.is_available()  # page-locked blocks need a card


def card() -> dict:
    info = {"cpus": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(),
            "torch": torch.__version__}
    if torch.cuda.is_available():
        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    return info


def pageable(a, dev, chunk):
    return torch.from_numpy(a).to(dev)


def chunked(a, dev, chunk):
    src = torch.from_numpy(a).view(-1)
    dst = torch.empty_like(src, device=dev)
    step = chunk // src.element_size()
    for i in range(0, src.numel(), step):
        part = src[i:i + step]
        stage = torch.empty(part.shape, dtype=part.dtype, pin_memory=PIN)
        stage.copy_(part)
        dst[i:i + step].copy_(stage, non_blocking=True)
    return dst


class Ring:
    """RING_SLOTS page-locked chunks of ``chunk`` bytes, allocated once;
    slot k is rewritten only after its event has passed."""

    def __init__(self, chunk: int):
        self.slots = [torch.empty(chunk // 4, dtype=torch.float32,
                                  pin_memory=True) for _ in range(RING_SLOTS)]
        self.events = [None] * RING_SLOTS
        self.k = 0

    def __call__(self, a, dev, chunk):
        src = torch.from_numpy(a).view(-1)
        dst = torch.empty_like(src, device=dev)
        step = self.slots[0].numel()
        for i in range(0, src.numel(), step):
            part = src[i:i + step]
            k = self.k
            self.k = (k + 1) % RING_SLOTS
            if self.events[k] is not None:
                self.events[k].synchronize()
            stage = self.slots[k][:part.numel()]
            stage.copy_(part)
            dst[i:i + step].copy_(stage, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self.events[k] = ev
        return dst


def quartiles(v):
    q = statistics.quantiles(v, n=4)
    return [round(q[0], 4), round(statistics.median(v), 4), round(q[2], 4)]


def time_form(fn, arrays, dev, chunk, reps):
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for a in arrays:  # warm: the cache's blocks, the card's allocator
        if not torch.equal(fn(a, dev, chunk).cpu(), torch.from_numpy(a)):
            raise SystemExit(f"{fn} changed the bytes")
    sync()
    host, end = [], []
    for _ in range(reps):
        for a in arrays:
            t0 = time.perf_counter()
            out = fn(a, dev, chunk)
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            host.append((t1 - t0) * 1e3)
            end.append((t2 - t0) * 1e3)
            del out
    nbytes = arrays[0].nbytes
    return {"host_ms": quartiles(host), "end_ms": quartiles(end),
            "host_gbps": round(nbytes / statistics.median(host) / 1e6, 3),
            "end_gbps": round(nbytes / statistics.median(end) / 1e6, 3)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mb", type=float, default=33.554432)
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--out")
    p.add_argument("--small", action="store_true")
    args = p.parse_args()
    info = card()
    print(json.dumps(info), flush=True)
    if args.small:
        dev, mb, chunks = torch.device("cpu"), 1.0, [1 << 18]
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card (use --small on the CPU)")
        dev, mb = torch.device("cuda"), args.mb
        chunks = [1 << 21, 1 << 22, 1 << 23, 1 << 24]
    n = int(mb * 1e6) // 4
    arrays = [np.random.default_rng([2501, k]).standard_normal(
        n, dtype=np.float32) for k in range(4)]
    lines = []
    default = torch.get_num_threads()
    plans = [("pageable", pageable, default, 0)]
    for t in sorted({1, 2, 4, default}):
        plans.append(("pinned", chunked, t, arrays[0].nbytes))
        for c in chunks:
            plans.append(("chunked", chunked, t, c))
        if dev.type == "cuda":
            plans += [("ring", None, t, c) for c in chunks]
    for name, fn, t, chunk in plans:
        torch.set_num_threads(t)
        fn = fn or Ring(chunk)
        row = {"form": name, "threads": t, "chunk_mb": round(chunk / 2**20, 3),
               **time_form(fn, arrays, dev, chunk, args.reps)}
        print(json.dumps(row), flush=True)
        lines.append(row)
    torch.set_num_threads(default)
    if dev.type == "cuda" and hasattr(torch.cuda, "host_memory_stats"):
        stats = torch.cuda.host_memory_stats()
        print(json.dumps({"host_memory_stats": stats}), flush=True)
        info["host_memory_stats"] = stats
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"info": info, "rows": lines}, f, indent=1)


if __name__ == "__main__":
    main()

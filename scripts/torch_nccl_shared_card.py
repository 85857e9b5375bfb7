#!/usr/bin/env python3
"""Two NCCL ranks on one card: does NCCL take them?

    python3 scripts/torch_nccl_shared_card.py [--timeout 120]

Starts two processes, both on cuda:0, joined by a ``file://`` rendezvous.
Each makes a (2, 1) mesh with `tinaural_torch.parallel.make_mesh` and
renders a 4-source scene with `render_scene_sharded` (one NCCL all-reduce
of the mixdown). Prints the card's name and power limit, then one JSON
line: each rank's outcome (the mixdown's shape and whether it equals the
unsharded render to 1e-5, or the error it raised) and its exit code.
Processes still running after ``--timeout`` seconds are ended and
reported so. Exits 0 whatever NCCL answers: the answer is the output;
non-zero only without a card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rank(rank: int, rdv: str, out: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    import tinaural_torch as tt
    from tinaural_torch.parallel import make_mesh, render_scene_sharded

    res = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{rdv}",
                                world_size=2, rank=rank)
        try:
            mesh = make_mesh((2, 1), "cuda")
            table = tt.TorchTable.from_hrir_table(
                tt.load_hrir_set("synthetic"), torch.device("cuda", 0))
            rng = np.random.default_rng(0)
            xs = rng.standard_normal((4, 8 * 1024)).astype(np.float32)
            dirs = np.stack([rng.uniform(0, 360, 4),
                             rng.uniform(-40, 90, 4)], 1)
            y = render_scene_sharded(table, xs, dirs, mesh)
            torch.cuda.synchronize()
            want = tt.BinauralRenderer(table).render_scene(xs, dirs)
            res.update(shape=list(y.shape), equal_to_unsharded=bool(
                torch.allclose(y, want, rtol=1e-5, atol=1e-5)))
        finally:
            dist.destroy_process_group()
    except Exception as e:  # the outcome is the report: record and exit
        res.update(error=f"{type(e).__name__}: {e}"[-2000:],
                   traceback=traceback.format_exc()[-4000:])
    with open(out, "w") as f:
        json.dump(res, f)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_nccl_shared_card: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, NCCL {torch.cuda.nccl.version()}",
          flush=True)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        outs = [os.path.join(d, f"rank{r}.json") for r in range(2)]
        procs = [ctx.Process(target=_rank,
                             args=(r, os.path.join(d, "rdv"), outs[r]))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(args.timeout)
        report = []
        for p, out in zip(procs, outs):
            ended = p.is_alive()
            if ended:
                p.kill()
                p.join()
            r = {"exitcode": p.exitcode, "ended_after_timeout": ended}
            if os.path.exists(out):
                with open(out) as f:
                    r.update(json.load(f))
            report.append(r)
    print(json.dumps({"nccl_two_ranks_one_card": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

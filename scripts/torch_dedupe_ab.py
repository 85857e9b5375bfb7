#!/usr/bin/env python3
"""`render_scene`'s host dedupe, `_dedupe_sources`, timed against its
former form on the host alone (no card needed).

    python3 scripts/torch_dedupe_ab.py [--reps 21] [--out FILE]

``before`` is the former `_dedupe_sources`, copied here: it grouped the
snapped tracks with `np.unique(axis=0)` (a structured dtype of one float
field a column, sorted field by field) and premixed with `np.add.at`.
``after`` is the port's: grouping by the key rows' bytes, a loop premix.
Two shapes, float32 like the renderer's:

- ``scene``: the kemar128.scene cell's, 64 sources × 2^17 samples, 128
  blocks a track, each source its own sweep (0.05–0.5 turns): every
  track distinct, so both return the scene untouched;
- ``choir``: the same 64 sources on 8 tracks, shuffled, so the premix
  runs (U = 8 at ``scene_chunk`` 8).

Each line gives the median, first and third quartile ms of each form over
``reps`` calls, the ratio of the medians, and whether the two outputs are
identical: the same objects where the scene comes back untouched, else
equal in value and dtype. The host's CPU count and numpy's version come
first; ``--out`` also writes the lines to FILE as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tinaural_torch.config import RenderConfig  # noqa: E402
from tinaural_torch.models.renderer import (_dedupe_sources,  # noqa: E402
                                            _snap_dirs)
from tinaural_torch.utils.profiling import span  # noqa: E402

S, N, NB = 64, 2 ** 17, 128


def before(xs: np.ndarray, dirs: np.ndarray, config: RenderConfig):
    """The former `_dedupe_sources`."""
    with span("tt.dedupe"):
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


def tracks(rng, n: int) -> np.ndarray:
    """n moving tracks (n, NB, 2), each its own sweep of 0.05–0.5 turns."""
    t = np.linspace(0.0, 1.0, NB)
    az = (rng.uniform(0, 360, (n, 1))
          + rng.uniform(0.05, 0.5, (n, 1)) * 360 * t) % 360
    el = rng.uniform(-40, 90, (n, 1)) + rng.uniform(-10, 10, (n, 1)) * t
    return np.stack([az, el], -1).astype(np.float32)


def identical(xs, dirs, a, b) -> bool:
    if a[0] is xs or b[0] is xs:
        return all(p is q for p, q in zip((*a, *b), (xs, dirs, xs, dirs)))
    return all(p.dtype == q.dtype and np.array_equal(p, q)
               for p, q in zip(a, b))


def timed(fn, xs, dirs, config, reps: int) -> list[float]:
    fn(xs, dirs, config)  # warm
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(xs, dirs, config)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--out")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((S, N)).astype(np.float32)
    config = RenderConfig()
    shapes = {"scene": tracks(rng, S),
              "choir": tracks(rng, 8)[rng.permutation(np.repeat(
                  np.arange(8), S // 8))]}
    lines = [{"cpus": len(os.sched_getaffinity(0)),
              "numpy": np.__version__}]
    print(json.dumps(lines[0]))
    for name, dirs in shapes.items():
        line = {"shape": name, "S": S, "N": N, "nb": NB,
                "identical": identical(xs, dirs, before(xs, dirs, config),
                                       _dedupe_sources(xs, dirs, config))}
        for form, fn in (("before", before), ("after", _dedupe_sources)):
            q1, med, q3 = statistics.quantiles(
                timed(fn, xs, dirs, config, args.reps), n=4)
            line[f"{form}_ms"] = [round(med, 4), round(q1, 4), round(q3, 4)]
        line["ratio"] = round(line["before_ms"][0] / line["after_ms"][0], 2)
        lines.append(line)
        print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()

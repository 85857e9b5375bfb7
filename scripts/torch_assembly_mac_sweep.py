#!/usr/bin/env python3
"""Time tinaural_torch's `assembly_mac` kernel on one CUDA card.

    python3 scripts/torch_assembly_mac_sweep.py [--waves 1 2 4] [--reps 10]

Builds the kernels, prints the compiler's registers and spills of
`assembly_mac_kernel`, then at the natural-order route's shapes — 8192 rows
at n_fft 4096 and 2048 taps (render (k) of chip_smoke.py) with and without
crossfade, and 4096 rows at n_fft 4096 and 128 taps (render (l)) — holds
the kernel against its plain float64 version (SNR) and times it with CUDA
events for each RUN_WAVES value given (the runs' count per concurrent
block). Then a correctness pass at n_fft 8192 and 16384. One JSON line
per measurement; the card's name and power limit first. Runs against
whatever tinaural_torch is first on sys.path.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

import tinaural_torch as tt
from tinaural_torch.config import RenderConfig
from tinaural_torch.models.renderer import _neighbours
from tinaural_torch.ops import _build
from tinaural_torch.ops import assembly_mac as am

FLAGS = dict(apply_itd=True, apply_ild=True)


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def snr_db(ref, test) -> float:
    ref = torch.view_as_real(ref.to(torch.complex128))
    test = torch.view_as_real(test.to(torch.complex128))
    return float(10 * torch.log10(ref.pow(2).sum() / (ref - test).pow(2).sum()))


def inputs(table, rows: int, n_fft: int, seed: int, sources: int):
    rng = np.random.default_rng(seed)
    dirs = np.stack([rng.uniform(0, 360, rows), rng.uniform(-40, 90, rows)],
                    -1).astype(np.float32)
    idx, w = _neighbours(table, torch.tensor(dirs, device=table.device),
                         RenderConfig())
    F = n_fft // 2 + 1
    X = torch.tensor((rng.standard_normal((2, rows, F))
                      + 1j * rng.standard_normal((2, rows, F))).astype(
                          np.complex64), device=table.device)
    first = torch.zeros(rows, device=table.device)
    first[::rows // sources] = 1.0
    return idx, w, X[0], X[1], first


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", type=int, nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    log = lib.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry" in line and "assembly_mac" in line:
            name = line.split("assembly_mac_kernel")[1].split("'")[0]
            print("ptxas:", name[:12], "|", log[i + 2].strip(), "|",
                  log[i + 3].strip(), flush=True)
    dev = torch.device("cuda", 0)
    tables = {taps: tt.TorchTable.from_hrir_table(
        tt.load_hrir_set("synthetic", taps=taps), dev) for taps in (128, 2048)}
    waves = args.waves or [getattr(am, "RUN_WAVES", None)]
    for name, taps, rows, cf in (("k", 2048, 8192, True),
                                 ("k_no_crossfade", 2048, 8192, False),
                                 ("l", 128, 4096, True)):
        t = tables[taps]
        idx, w, Xu, Xd, first = inputs(t, rows, 4096, rows + taps, 64)
        kw = dict(crossfade=cf, **FLAGS)
        kern = lambda: am.assembly_mac_cuda(idx, w, t, Xu, Xd, first, 4096,
                                            **kw)
        Y64 = am.assembly_mac_reference(idx, w.double(), t,
                                        Xu.to(torch.complex128),
                                        Xd.to(torch.complex128), first, 4096,
                                        **kw)
        rec = {"shape": name, "rows": rows, "taps": taps,
               "snr_db": snr_db(Y64, kern())}
        for wv in waves:
            if wv is not None:
                am.RUN_WAVES = wv
            rec[f"ms_waves_{wv}"] = cuda_ms(kern, args.reps)
        print(json.dumps(rec), flush=True)
    # correctness at the larger shared plans
    for taps, n_fft, rows in ((2048, 8192, 300), (128, 16384, 100),
                              (2048, 16384, 100)):
        t = tables[taps]
        idx, w, Xu, Xd, first = inputs(t, rows, n_fft, rows, 4)
        kw = dict(crossfade=True, **FLAGS)
        Y = am.assembly_mac_cuda(idx, w, t, Xu, Xd, first, n_fft, **kw)
        Y64 = am.assembly_mac_reference(idx, w.double(), t,
                                        Xu.to(torch.complex128),
                                        Xd.to(torch.complex128), first,
                                        n_fft, **kw)
        print(json.dumps({"taps": taps, "n_fft": n_fft, "rows": rows,
                          "snr_db": snr_db(Y64, Y),
                          "ms": cuda_ms(lambda: am.assembly_mac_cuda(
                              idx, w, t, Xu, Xd, first, n_fft, **kw), 3)}),
              flush=True)


if __name__ == "__main__":
    main()

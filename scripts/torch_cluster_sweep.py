#!/usr/bin/env python3
"""Check and time tinaural_torch's cluster-mode kernels on one CUDA card.

    python3 scripts/torch_cluster_sweep.py [--check-only] [--reps 10]

Builds the kernels and prints the compiler's registers and spills of every
`spectra_inverse_kernel` and `assemble_partitions_kernel` instance. Then:

- `spectra_inverse` at n_fft 32768, 65536 and 131072 (the cluster mode),
  1 and 7 rows and summed over 3 terms, against the float64 plain version
  (SNR) and for equal bits over two calls;
- `assemble_partitions` at L = 16384, 32768, 65536 and 131072 (taps 9000,
  16384, 44100, 70000) and blocks 64 … 2048, against its float64 plain
  version;

and unless ``--check-only`` times, with CUDA events, `spectra_inverse` at
128 × 32768, 64 × 65536 and 32 × 131072 beside `torch.fft.irfft`, and
`assemble_partitions` at PARTITION_SHAPES, the first of them render (j)'s
256 rows × 44,100 taps × B 512 beside the split mode (forced) and the
plain version. To compare variants of a kernel, run the script against
edited copies of the package in one call (``PYTHONPATH=<copy>:.``).
One JSON line per measurement; the card's name and power limit first.
Runs against whatever tinaural_torch (and chip_smoke, for its ptxas
report) is first on sys.path: ``PYTHONPATH=. python3 scripts/…``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

import tinaural_torch as tt
from chip_smoke import ptxas_summary
from tinaural_torch.config import RenderConfig
from tinaural_torch.models.renderer import _neighbours
from tinaural_torch.ops import _build, _layout
from tinaural_torch.ops import block_step as bs
from tinaural_torch.ops import partitioned_conv as pc
from tinaural_torch.ops.partitions_plan import partitions_plan

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
    if ref.is_complex():
        ref, test = torch.view_as_real(ref), torch.view_as_real(test)
    ref, test = ref.double(), test.double()
    return float(10 * torch.log10(ref.pow(2).sum() / (ref - test).pow(2).sum()))


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def rows_of(table, rows: int, seed: int):
    rng = np.random.default_rng(seed)
    dirs = np.stack([rng.uniform(0, 360, rows), rng.uniform(-40, 90, rows)],
                    -1).astype(np.float32)
    return _neighbours(table, torch.tensor(dirs, device=table.device),
                       RenderConfig())


def check_inverse(dev) -> bool:
    ok = True
    for n in (1 << 15, 1 << 16, 1 << 17):
        x = np.random.default_rng(n).standard_normal((3, 7, 2, n))
        P = torch.fft.rfft(torch.from_numpy(x)).to(torch.complex64).to(dev)
        for what, Y, summed in (("1 row", P[0, :1], False),
                                ("7 rows", P[0], False),
                                ("3 terms", P, True)):
            got = bs.spectra_inverse_cuda(Y, n, summed=summed)
            ref = bs.spectra_inverse_reference(
                Y.to(torch.complex128).sum(0) if summed
                else Y.to(torch.complex128), n)
            s = snr_db(ref, got)
            same = torch.equal(got, bs.spectra_inverse_cuda(Y, n,
                                                            summed=summed))
            ok &= s >= 120 and same
            emit(kernel="spectra_inverse", n_fft=n, case=what, snr_db=s,
                 same_bits=same)
    return ok


def check_partitions(dev) -> bool:
    ok = True
    for taps in (9000, 16384, 44100, 70000):
        t = tt.TorchTable.from_hrir_table(
            tt.load_hrir_set("synthetic", taps=taps), dev)
        for B in (64, 256, 512, 2048):
            plan = partitions_plan(taps, B, True)
            idx, w = rows_of(t, 5, seed=taps + B)
            hr, hi = pc.assemble_partitions_cuda(idx, w, t, B, **FLAGS)
            r64, i64 = pc.assemble_partitions_reference(idx, w.double(), t, B,
                                                        **FLAGS)
            s = snr_db(torch.complex(r64, i64), torch.complex(hr, hi))
            ok &= s >= 100 and plan.body == "cluster"
            emit(kernel="assemble_partitions", taps=taps, L=plan.L, B=B,
                 ranks=plan.ranks, snr_db_fp64=s)
    return ok


def time_inverse(dev, reps: int) -> None:
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    for rows, n in ((128, 1 << 15), (64, 1 << 16), (32, 1 << 17)):
        Y = torch.fft.rfft(torch.randn((rows, 2, n), generator=g, device=dev))
        emit(kernel="spectra_inverse", rows=rows, n_fft=n,
             ms=cuda_ms(lambda: bs.spectra_inverse_cuda(Y, n), reps),
             irfft_ms=cuda_ms(lambda: torch.fft.irfft(Y, n=n), reps),
             snr_db_fp32=snr_db(bs.spectra_inverse_reference(Y, n),
                                bs.spectra_inverse_cuda(Y, n)))


# (taps, B, rows) of the assemble_partitions timings: render (j)'s shape
# (L 65536, 4 blocks per row), the same 1024 blocks as clusters of one
# (L 16384), and (j)'s length at the smallest and largest cluster-mode B
PARTITION_SHAPES = ((44100, 512, 256), (9000, 512, 1024), (44100, 64, 256),
                    (44100, 2048, 256))


def time_partitions(dev, reps: int) -> None:
    tables = {}
    for taps, B, rows in PARTITION_SHAPES:
        if taps not in tables:
            tables[taps] = tt.TorchTable.from_hrir_table(
                tt.load_hrir_set("synthetic", taps=taps), dev)
        t = tables[taps]
        idx, w = rows_of(t, rows, seed=1)
        kern = lambda: pc.assemble_partitions_cuda(idx, w, t, B, **FLAGS)
        res = dict(kernel="assemble_partitions", rows=rows, taps=taps, B=B,
                   ranks=partitions_plan(taps, B, True).ranks,
                   ms=cuda_ms(kern, reps))
        if (taps, B, rows) == PARTITION_SHAPES[0]:
            ref = pc.assemble_partitions_reference(idx, w, t, B, **FLAGS)
            res["snr_db_fp32"] = snr_db(torch.complex(*ref),
                                        torch.complex(*kern()))
            _layout.force_work = _layout.SPLIT_WORK
            res["split_ms"] = cuda_ms(kern, max(2, reps // 4))
            _layout.force_work = 0
            res["plain_ms"] = cuda_ms(lambda: pc.assemble_partitions_reference(
                idx, w, t, B, **FLAGS), max(2, reps // 4))
        emit(**res)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    emit(build_s=time.perf_counter() - t0)
    for line in ptxas_summary(lib.with_suffix(".log").read_text()):
        if "spectra_inverse" in line or "assemble_partitions" in line:
            print(f"  ptxas: {line}", flush=True)
    dev = torch.device("cuda", 0)
    ok = check_inverse(dev)
    ok &= check_partitions(dev)
    if not args.check_only:
        time_inverse(dev, args.reps)
        time_partitions(dev, args.reps)
    emit(ok=bool(ok))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

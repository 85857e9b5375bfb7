#!/usr/bin/env python3
"""Check and time the block render's `assemble_filters` and
`block_spectra_mix_inverse` kernels on one CUDA card.

    python3 scripts/torch_block_render_sweep.py [--check-only | --time-only]
        [--reps 10]

Builds the kernels and prints the compiler's registers and spills of every
instance of them and of `assembly_mac_kernel` (which shares the assembly
stages). Then holds both kernels against their plain float64 versions
(SNR) at every n_fft 128 … 32768 (32768: the split mode), rows 1, 7 and
8193, sources 1 and 3, crossfade on and off. Unless --check-only, times
each kernel and its plain float32 version with CUDA events at
chip_smoke.py's shapes: 8192 rows of one
trajectory at 128 taps and n_fft 2048 (render (a)), 16 sources × 1024
blocks (render (m)) and 64 sources × 128 blocks (the scene check). One
JSON line per measurement; the card's name and power limit first. Runs
against whatever tinaural_torch is first on sys.path, so two trees can be
compared in one call.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import numpy as np
import torch

import tinaural_torch as tt
from tinaural_torch.config import RenderConfig
from tinaural_torch.models.renderer import _neighbours
from tinaural_torch.ops import _build
from tinaural_torch.ops import block_render as br

FLAGS = dict(apply_itd=True, apply_ild=True)
KERNELS = ("assemble_filters_kernel", "block_spectra_mix_inverse_kernel",
           "assembly_mac_kernel")


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


def ptxas(log: str) -> None:
    """Registers and spills of each instance of KERNELS."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            sym = m.group(1)
            name = next((k for k in KERNELS if k in sym), None)
            args = re.findall(r"L(b[01]|i\d+)E", sym)
            tag = f"{name}<{','.join(a[1:] for a in args)}>" if name else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"{m.group(1)}/{m.group(2)} B spill stores/loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"ptxas: {tag}: {m.group(1)} registers, {spills}", flush=True)
            name = None


def rows_of(table, S: int, nb: int, seed: int):
    rng = np.random.default_rng(seed)
    dirs = np.stack([rng.uniform(0, 360, (S, nb)),
                     rng.uniform(-40, 90, (S, nb))], -1).astype(np.float32)
    return _neighbours(table, torch.tensor(dirs, device=table.device),
                       RenderConfig())


def check(tables, n_fft: int, taps: int, rows: int) -> None:
    t = tables[taps]
    idx, w = rows_of(t, 1, rows, n_fft + rows)
    H = br.assemble_filters_cuda(idx, w, t, n_fft, **FLAGS)
    H64 = br.assemble_filters_reference(idx, w.double(), t, n_fft, **FLAGS)
    rec = {"n_fft": n_fft, "taps": taps, "rows": rows,
           "assemble_filters_snr_db": snr_db(H64, H),
           "equal_bits": bool(torch.equal(H, br.assemble_filters_cuda(
               idx, w, t, n_fft, **FLAGS)))}
    B = n_fft // 2
    for S in (1, 3):
        nb = max(1, min(rows, 7))
        rng = np.random.default_rng(S + n_fft)
        xbs = torch.tensor(rng.standard_normal((S, nb, B)).astype(np.float32),
                           device=t.device)
        Hs = torch.tensor((rng.standard_normal((S, nb, 2, n_fft // 2 + 1))
                           + 1j * rng.standard_normal(
                               (S, nb, 2, n_fft // 2 + 1))).astype(
                                   np.complex64), device=t.device)
        for cf in (True, False):
            got = br.block_spectra_mix_inverse_cuda(xbs, Hs, n_fft,
                                                    crossfade=cf)
            ref = br.block_spectra_mix_inverse_reference(
                xbs.double(), Hs.to(torch.complex128), n_fft, crossfade=cf)
            rec[f"mix_S{S}_cf{int(cf)}_snr_db"] = snr_db(ref, got)
    print(json.dumps(rec), flush=True)


def timing(table, S: int, nb: int, reps: int) -> None:
    n_fft, B = 2048, 1024
    idx, w = rows_of(table, S, nb, S * nb)
    rng = np.random.default_rng(S)
    xbs = torch.tensor(rng.standard_normal((S, nb, B)).astype(np.float32),
                       device=table.device)
    H = br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS)
    rec = {"S": S, "nb": nb, "n_fft": n_fft}
    for name, kern, plain in (
            ("assemble_filters",
             lambda: br.assemble_filters_cuda(idx, w, table, n_fft, **FLAGS),
             lambda: br.assemble_filters_reference(idx, w, table, n_fft,
                                                   **FLAGS)),
            ("block_spectra_mix_inverse",
             lambda: br.block_spectra_mix_inverse_cuda(xbs, H, n_fft,
                                                       crossfade=True),
             lambda: br.block_spectra_mix_inverse_reference(
                 xbs, H, n_fft, crossfade=True))):
        rec[f"{name}_snr_db_vs_plain_fp32"] = snr_db(plain(), kern())
        rec[f"{name}_ms"] = cuda_ms(kern, reps)
        rec[f"{name}_plain_ms"] = cuda_ms(plain, reps)
    print(json.dumps(rec), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check-only", action="store_true")
    mode.add_argument("--time-only", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "package": tt.__file__}), flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    ptxas(lib.with_suffix(".log").read_text())
    dev = torch.device("cuda", 0)
    tables = {taps: tt.TorchTable.from_hrir_table(
        tt.load_hrir_set("synthetic", taps=taps), dev)
        for taps in (16, 128, 2048, 8000)}
    shapes = () if args.time_only else (
        (128, 16), (256, 128), (512, 128), (1024, 128), (2048, 128),
        (4096, 128), (4096, 2048), (8192, 2048), (8192, 8000), (16384, 128),
        (16384, 8000), (32768, 2048))
    for n_fft, taps in shapes:
        for rows in (1, 7, 8193):
            if rows == 8193 and n_fft > 4096:
                continue
            check(tables, n_fft, taps, rows)
    if args.check_only:
        return
    for S, nb in ((1, 8192), (16, 1024), (64, 128)):
        timing(tables[128], S, nb, args.reps)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Count the device records a torch.profiler trace keeps of 10 launches.

    python3 scripts/torch_profiler_records.py

In a fresh process on one CUDA card, for three torch ops (a small and a
large elementwise multiply, a 4096² matmul), each traced twice under five
settings: CUDA activity only, CPU and CUDA activity, a 1 ms GPU spin or a
10 ms host sleep before the calls, and a GPU spin after them. Prints, for
each trace, the records of the op's kernel in ``prof.events()`` and in the
raw kineto results, and the first one's start. chip_smoke.py's
`kernel_device_ms` pads its traces with spin kernels because traces taken
late in its long process lost records at their edges; this script is the
fresh-process side of that comparison.
"""

import time

import torch
from torch.profiler import ProfilerActivity, profile


def count(fn, key: str, acts, pre=None, post=None, calls: int = 10):
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if pre:
            pre()
        for _ in range(calls):
            fn()
        if post:
            post()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events()
           if e.device_type == cuda and key in e.name.lower()]
    raw = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and key in e.name().lower()]
    first = min((e.time_range.start for e in evs), default=None)
    return len(evs), len(raw), first


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 2
    small = torch.randn(1 << 12, device="cuda")
    big = torch.randn(1 << 26, device="cuda")
    A = torch.randn(4096, 4096, device="cuda")
    ops = {"small_mul": (lambda: small.mul_(1.0000001), "elementwise"),
           "big_mul": (lambda: big.mul_(1.0000001), "elementwise"),
           "matmul": (lambda: A @ A, "gemm")}
    C = [ProfilerActivity.CUDA]
    settings = {
        "cuda-only": dict(acts=C),
        "cpu+cuda": dict(acts=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
        "cuda-only gpu sleep before": dict(
            acts=C, pre=lambda: torch.cuda._sleep(2_000_000)),
        "cuda-only host sleep before": dict(
            acts=C, pre=lambda: time.sleep(0.01)),
        "cuda-only gpu sleep after": dict(
            acts=C, post=lambda: torch.cuda._sleep(2_000_000))}
    for name, (fn, key) in ops.items():
        for _ in range(2):
            for setting, kw in settings.items():
                n, raw, first = count(fn, key, **kw)
                print(f"{name} {setting:30s} events {n:2d} raw {raw:2d} "
                      f"first start {first} us", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The yardstick of the roofline shares: the card's published peaks and the
least work of each stage of a render, at a cell's shapes.

The peaks are NVIDIA's published H100 SXM figures at 700 W: 3.35 TB/s of
HBM3 and 67 TFLOP/s of float32 outside the tensor cores. Each run prints
the card's power limit beside them.

Least work: each input read once and each output written once; a real
n-point transform 2.5·n·log2 n operations, and a block of b samples
zero-padded to n points 2.5·n·log2 min(n, Q) with Q = max(next_pow2(b),
128) (P = n/Q transforms of Q points of the pre-twiddled block); a complex
multiply 6 operations, a multiply-add 8. The counts follow the stage's
definition (the golden render map), never the program's plan, so no
redesign of a kernel can lift its share over 100%.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
PEAKS = "H100 SXM published peaks at 700 W: 3.35 TB/s, 67 TFLOP/s fp32"

ALIGN_TAPS = 64  # DELAY_PAD: the effective filter's samples past the taps


def next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(n)))


def rfft_flops(n: int, nonzero: int | None = None) -> float:
    """A real n-point transform, its input ``nonzero`` samples long (the
    rest zeros): 2.5·n·log2 min(n, Q), Q = max(next_pow2(nonzero), 128)."""
    q = n if nonzero is None else min(n, max(next_pow2(nonzero), 128))
    return 2.5 * n * math.log2(q)


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the fp32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def table_row_bytes(taps: int) -> int:
    """A table row read once: both ears' taps, delays and gains."""
    return 2 * taps * 4 + 2 * 4 + 2 * 4


def filter_flops(taps: int) -> float:
    """One direction's effective filter, both ears, at its canonical size
    L: the gather and lerp of 4 rows (and their delays and gains), then
    each ear's rfft_L, the delay ramp and gain, and irfft_L."""
    L = next_pow2(taps + ALIGN_TAPS)
    F = L // 2 + 1
    return 16 * taps + 32 + 2 * (2 * rfft_flops(L) + 8 * F)


def assembly(s: dict) -> tuple[float, float]:
    """(bytes, operations) of the filter spectra of one render call: R =
    ``rows`` filters, each the effective filter and its rfft at n_fft, in
    and out of memory once (idx and w, the table rows used, H out)."""
    R, n, taps = s["rows"], s["n_fft"], s["taps"]
    nbytes = R * 32 + s["table_rows"] * table_row_bytes(taps) \
        + R * 2 * (n // 2 + 1) * 8
    flops = R * (filter_flops(taps)
                 + 2 * rfft_flops(n, taps + ALIGN_TAPS))
    return nbytes, flops


def mix(s: dict) -> tuple[float, float]:
    """(bytes, operations) of the block spectra, their products with the
    filters and the sum over sources of one render call: the blocks and H
    read once, the summed spectra (nb, 2, F) written once. A block's
    forward: one real transform, or both ramps' under crossfade; 6
    operations an ear and bin, 14 under crossfade, 2 more for the sum over
    sources."""
    S, nb, B, n = s["S"], s["nb"], s["B"], s["n_fft"]
    F = n // 2 + 1
    xf = s["crossfade"]
    nbytes = S * nb * B * 4 + s["rows"] * 2 * F * 8 + nb * 2 * F * 8
    fwd = rfft_flops(n, B) * (2 if xf else 1)
    mac = (14 if xf else 6) + (2 if S > 1 else 0)
    return nbytes, S * nb * (fwd + 2 * F * mac)


def mix_inverse(s: dict) -> tuple[float, float]:
    """(bytes, operations) of `mix` and each output block's inverse in one
    pass: the summed spectra stay on chip, the frames (nb, 2, n_fft) are
    written once instead."""
    nb, n = s["nb"], s["n_fft"]
    nbytes, flops = mix(s)
    nbytes += nb * 2 * n * 4 - nb * 2 * (n // 2 + 1) * 8
    return nbytes, flops + nb * 2 * rfft_flops(n)


def roofline_pct(stage, shapes: dict, kernel_s: float | None):
    """A kernel's share of its roofline in %: the stage's least time over
    the kernel's device time a call; None when the trace holds no record
    of the kernel."""
    if not kernel_s:
        return None
    return 100.0 * least_seconds(*stage(shapes)) / kernel_s

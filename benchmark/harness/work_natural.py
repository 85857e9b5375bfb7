"""The least work of the natural-order route's two stages at a cell's
shapes, for the roofline shares of its kernels (`assembly_mac`,
`spectra_inverse`). The peaks, the transform count and the filter count
are `harness/work.py`'s; the counts follow the stage's definition (the
golden render map), never the program's plan, so no redesign of a kernel
can lift its share over 100%.

The route computes per block row r of the flattened (source, block) axis,
R = S·nb rows, F = n_fft/2 + 1 bins: Y[r] = Xu[r]·H[r] + Xd[r]·H[r−1],
where H[r] is the rfft at n_fft of the effective filter of the row's
direction. A filter that k = ``dir_rate`` blocks share is one filter of
the stage (``rows`` = S·⌈nb/k⌉ of them), however often a kernel
assembles it.
"""

from __future__ import annotations

from .work import ALIGN_TAPS, filter_flops, rfft_flops, table_row_bytes


def block_rows(s: dict) -> int:
    """R: the rows of spectra the route multiplies, one a block."""
    return s["S"] * s["nb"]


def assembly_mac(s: dict) -> tuple[float, float]:
    """(bytes, operations) of `assembly_mac`'s stage in one render call:
    idx and w of each filter and the table rows used read once, Xu (and
    Xd under crossfade) read once, Y (R, 2, F) written once; each
    filter's `filter_flops` and its two ears' rfft at n_fft (zero past
    taps + ALIGN_TAPS), then a multiply (6 operations an ear and bin), or
    the crossfaded pair of multiplies and their sum (14)."""
    R, n, taps = block_rows(s), s["n_fft"], s["taps"]
    F = n // 2 + 1
    xf = s["crossfade"]
    nbytes = s["rows"] * 32 + s["table_rows"] * table_row_bytes(taps) \
        + R * F * 8 * (2 if xf else 1) + R * 2 * F * 8
    flops = s["rows"] * (filter_flops(taps)
                         + 2 * rfft_flops(n, taps + ALIGN_TAPS)) \
        + R * 2 * F * (14 if xf else 6)
    return nbytes, flops


def spectra_inverse(s: dict) -> tuple[float, float]:
    """(bytes, operations) of `spectra_inverse`'s stage in one render
    call: Y (R, 2, F) read once, the frames (R, 2, n_fft) written once,
    a real inverse transform an ear and row (2.5·n·log2 n)."""
    R, n = block_rows(s), s["n_fft"]
    nbytes = R * 2 * (n // 2 + 1) * 8 + R * 2 * n * 4
    return nbytes, R * 2 * rfft_flops(n)

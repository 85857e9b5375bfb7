"""The least work of the partitioned route's three stages at a cell's
shapes, for the roofline shares of its kernels (`assemble_partitions`,
`frame_spectra`, `partitioned_conv`). The peaks, the transform count and
the filter count are `harness/work.py`'s; the counts follow the stage's
definition (the streamed map, `reference/streamed.py`), never the
program's plan (its chunks, its re-assembled rows), so no redesign of a
kernel can lift its share over 100%.

With nb blocks of B samples, P = ⌈(taps + ALIGN_TAPS)/B⌉ partitions of B
samples and F2 = B + 1 bins of a 2B frame: R = ⌈nb/k⌉ filters (k =
``dir_rate``), each cut into its P partitions' spectra H[r, p] (both
ears); X[c] = rfft_2B([x_{c−1} | x_c]) each block's frame once; block
b's output the last B samples of irfft_2B(Σ_p X[b−p]·H[⌊b/k⌋, p]), and,
under crossfade, the same under its predecessor's row, blended.
"""

from __future__ import annotations

from .work import ALIGN_TAPS, next_pow2, rfft_flops, table_row_bytes


def planes_bytes(s: dict) -> int:
    """The partition planes of all R filters, float32 re and im."""
    return s["rows"] * s["P"] * 2 * s["F2"] * 8


def assemble_partitions(s: dict) -> tuple[float, float]:
    """(bytes, operations) of the filters' partition spectra in one
    render call over a table kept whole (no ITD or ILD: the effective
    filter is the lerp of its rows, with no L-point chain): idx and w of
    each filter and the table rows used read once, the planes written
    once; a filter's gather and lerp of 4 rows (`work.filter_flops`'
    first term), and each ear's P transforms of a B-sample partition at
    2B points."""
    R, taps, B = s["rows"], s["taps"], s["B"]
    nbytes = R * 32 + s["table_rows"] * table_row_bytes(taps) \
        + planes_bytes(s)
    return nbytes, R * (16 * taps + 32 + 2 * s["P"] * rfft_flops(2 * B, B))


def frame_spectra(s: dict) -> tuple[float, float]:
    """(bytes, operations) of the frame spectra in one render call: the
    blocks read once, the nb spectra (complex64) written once, a real
    2B-point transform a frame."""
    nb, B = s["nb"], s["B"]
    return nb * B * 4 + nb * s["F2"] * 8, nb * rfft_flops(2 * B)


def partitioned_conv(s: dict) -> tuple[float, float]:
    """(bytes, operations) of the convolution in one render call: the
    planes of every block's row and its predecessor's read once (the R
    rows), the frame spectra read once, the output (2, nb·B) written
    once; a complex multiply-add (8) an ear, partition and bin, and an
    inverse an ear a block, twice under crossfade, then the blend (3 an
    output sample)."""
    nb, B, F2 = s["nb"], s["B"], s["F2"]
    twice = 2 if s["crossfade"] else 1
    nbytes = planes_bytes(s) + nb * F2 * 8 + 2 * nb * B * 4
    flops = nb * twice * 2 * (s["P"] * F2 * 8 + rfft_flops(2 * B))
    if s["crossfade"]:
        flops += nb * 2 * B * 3
    return nbytes, flops


def shapes(taps: int, B: int, nb: int, dir_rate: int, crossfade: bool,
           table_rows: float) -> dict:
    """The shapes the counts read, from a render's settings."""
    T = taps + ALIGN_TAPS
    return dict(nb=nb, B=B, taps=taps, P=-(-T // B), L=next_pow2(T),
                F2=B + 1, rows=-(-nb // dir_rate), crossfade=crossfade,
                table_rows=table_rows)

"""Overlap-add as the k-stream sum.

With ``n_fft = k·hop``, chunk j of block b lands at offset ``(b+j)·hop``,
so all j-th chunks form one contiguous stream shifted by j·hop, and the OLA
is k shifted adds — no scatter.
"""

from __future__ import annotations

import torch


def overlap_add(blocks: torch.Tensor, hop: int) -> torch.Tensor:
    """OLA-reduce ``blocks`` (..., nb, n_fft) at stride ``hop`` →
    (..., (nb-1)·hop + n_fft). Requires n_fft % hop == 0."""
    *lead, nb, n_fft = blocks.shape
    if n_fft % hop != 0:
        raise ValueError(f"n_fft={n_fft} must be a multiple of hop={hop}")
    k = n_fft // hop
    out_len = (nb - 1) * hop + n_fft
    chunks = blocks.reshape(*lead, nb, k, hop)
    acc = blocks.new_zeros((*lead, out_len))
    for j in range(k):  # k = n_fft/hop is small (typically 2–4)
        stream = chunks[..., :, j, :].reshape(*lead, nb * hop)
        acc[..., j * hop: j * hop + nb * hop] += stream
    return acc

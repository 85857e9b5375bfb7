"""The streamed render map (`golden.GoldenStream`, block by block) in plain
torch, over chunks of blocks at once.

A stream of blocks of B samples takes block b's filter h_b (the effective
filter of its direction, `fast.filters`, T = taps + DELAY_PAD samples)
and gives

    y_b(i) = w_i · (x ∗ h_b)(bB + i) + (1 − w_i) · (x ∗ h_{b−1})(bB + i),

w_i = (i + 0.5)/B under crossfade (else 1), h_{−1} = h_0, and x zero
before its first sample: the whole history passes under the current
filter, and the crossfade is on the output side. That is the uniformly
partitioned overlap-save of `GoldenStream.push` summed over its
partitions. Here each block's two values come from one FFT convolution
of its window x[bB − T + 1 … bB + B − 1] with the whole filter, at n =
next_pow2(T + B − 1) points, so nothing of the partitioning is shared
with the program. Output (2, N), N = nb·B.

In ``fast.BFLOAT16`` every stored stage (signal, filters, their spectra,
the windows' spectra, the products, both outputs, the result) is rounded
to bfloat16. Nothing here imports the program under test.
"""

from __future__ import annotations

import torch

from . import fast
from .table import DELAY_PAD


def render(tab: fast.DeviceTable, x, dirs, cfg: fast.Config) -> torch.Tensor:
    """One source x (N,), N = nb·B, B = ``cfg.block_size``, along
    per-block directions dirs (nb, 2) → (2, N) in the table's precision,
    on its device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prec, dev = tab.prec, tab.device
    B = cfg.block_size
    x = prec.q(torch.as_tensor(x, device=dev).to(prec.dtype))
    (N,) = x.shape
    nb = N // B
    if N != nb * B or nb == 0:
        raise ValueError(f"the signal must be whole blocks of {B}, got {N}")
    dirs = fast.snap_dirs(torch.as_tensor(dirs, device=dev)
                          .to(torch.float64), cfg.dir_rate)
    if tuple(dirs.shape) != (nb, 2):
        raise ValueError(f"dirs must be ({nb}, 2), got {tuple(dirs.shape)}")
    T = tab.taps + DELAY_PAD
    M = T + B - 1  # a block's window
    n = fast.next_pow2(M)
    windows = torch.nn.functional.pad(x, (T - 1, 0)).unfold(0, M, B)
    up = ((torch.arange(B, dtype=torch.float64, device=dev) + 0.5) / B
          if cfg.crossfade else torch.ones(B, dtype=torch.float64,
                                           device=dev)).to(prec.dtype)
    out = torch.empty((2, nb, B), dtype=prec.dtype, device=dev)
    tile = fast._tile(n)
    for b0 in range(0, nb, tile):
        b1 = min(nb, b0 + tile)
        lo = max(b0 - 1, 0)
        Hs = prec.q(torch.fft.rfft(fast.filters(tab, dirs[lo:b1], cfg), n))
        Hc = Hs[b0 - lo:]
        Hp = torch.cat([Hs[:1], Hs[:-1]]) if b0 == 0 else Hs[:-1]
        X = prec.q(torch.fft.rfft(windows[b0:b1], n))[:, None]  # (n_b, 1, F)

        def under(H):  # the blocks' B samples of x ∗ h, (n_b, 2, B)
            y = torch.fft.irfft(prec.q(X * H), n)[..., T - 1:T - 1 + B]
            return prec.q(y)

        out[:, b0:b1] = (up * under(Hc)
                         + (1.0 - up) * under(Hp)).transpose(0, 1)
    return prec.q(out.reshape(2, N))

"""The numbers that decide ``correct``: an output against the reference's.

- ``max_err_rel``: the worst sample's error over the reference's peak. It
  catches a fault in any one block, and it swings by nature: the render
  map's delay ramp is discontinuous at a half-sample fractional delay (the
  first-order Lagrange phase at the Nyquist bin is the sign of 1 − 2·frac),
  so where a float32 delay rounds onto the other side of one half than the
  float64 reference's, one block's Nyquist component changes sign.
- ``p90_block_err_rel``: the 90th percentile over the output's blocks of a
  block's rms error over the whole output's rms. Steady from seed to seed
  (an isolated block does not move it), it catches a loss of precision
  everywhere, as the control's.

`PERF.md` gives the readings each cell's limits were set from.
"""

from __future__ import annotations

import torch

NUMBERS = ("max_err_rel", "p90_block_err_rel")


def compare(y: torch.Tensor, ref: torch.Tensor, block: int) -> dict:
    """y, ref (..., T) with the time axis last, cut into blocks of
    ``block`` samples (the last zero-padded) over all leading axes."""
    ref = ref.to(torch.float64)
    err = y.to(device=ref.device, dtype=torch.float64) - ref
    T = ref.shape[-1]
    pad = (-T) % block
    e = torch.nn.functional.pad(err, (0, pad)).reshape(*err.shape[:-1], -1, block)
    # a block's rms over its samples in every channel together
    e = e.movedim(-2, 0).reshape(e.shape[-2], -1)
    block_rms = e.pow(2).mean(dim=1).sqrt()
    rms = ref.pow(2).mean().sqrt()
    return {"max_err_rel": float(err.abs().max() / ref.abs().max()),
            "p90_block_err_rel": float(torch.quantile(block_rms / rms, 0.9))}


def worst(readings) -> dict:
    """Each number's worst over several outputs' readings."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for r in readings:
        for k in NUMBERS:
            out[k] = max(out[k], r[k])
    return out

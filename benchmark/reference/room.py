"""A room's diffuse tail on the head model's responses: binaural room
impulse responses (BRIRs) from the anechoic HRIRs of `synthetic.py`.

For each ear, seeded Gaussian noise from ``predelay_ms`` after the direct
sound onward, under the envelope exp(−3·ln 10 · t / ``rt60_s``) (−60 dB
at T60), scaled so that the direct sound's energy over the tail's is
``drr_db``. The direct sound arrives at the head model's causal base
delay (the head centre's arrival, `synthetic.synthesize_hrirs`); its
energy is an ear's mean over the grid's valid directions. One tail an
ear is shared by every direction: a diffuse field does not turn with the
head.

`raw_table` holds the responses as they are, with no ITD/ILD
decomposition: a renderer of binaural room synthesis convolves its BRIRs
whole, and the decomposition's delay estimate (a phase fit over 300–6000
Hz) does not find the direct sound under a tail of comparable energy.

Host-side numpy float64, from the run's seed; nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np

from .grids import SphericalGrid
from .synthetic import SPEED_OF_SOUND
from .table import Table

ROOM_SALT = 5  # after `harness/inputs.py`'s salts: a stream of its own


def onset(config: dict) -> int:
    """The tail's first sample: the direct sound's arrival plus the
    predelay, in samples."""
    fs = config["sample_rate"]
    direct = config["hrir"]["head_radius_m"] / SPEED_OF_SOUND + 8.0 / fs
    return math.ceil((direct + config["hrir"]["room"]["predelay_ms"] / 1e3)
                     * fs)


def envelope(config: dict) -> np.ndarray:
    """The tail's amplitude envelope over the taps, 0 before `onset`."""
    fs, taps = config["sample_rate"], config["taps"]
    n0 = onset(config)
    t = (np.arange(taps) - n0) / fs
    env = np.exp(-3.0 * math.log(10.0) * t / config["hrir"]["room"]["rt60_s"])
    return np.where(t >= 0.0, env, 0.0)


def tail(h: np.ndarray, valid: np.ndarray, config: dict,
         seed: int) -> np.ndarray:
    """The tail of each ear, (2, taps), for the anechoic responses h (E,
    A_max, 2, taps) whose valid directions are ``valid`` (E, A_max)."""
    g = np.random.default_rng([int(seed) % (1 << 64), ROOM_SALT])
    shaped = g.standard_normal((2, config["taps"])) * envelope(config)
    direct = (h ** 2).sum(-1)[valid > 0].mean(0)  # (2,)
    want = direct * 10.0 ** (-config["hrir"]["room"]["drr_db"] / 10.0)
    return shaped * np.sqrt(want / (shaped ** 2).sum(-1))[:, None]


def with_tail(h: np.ndarray, valid: np.ndarray, config: dict,
              seed: int) -> np.ndarray:
    """h (E, A_max, 2, taps) with the room's tail added to every valid
    direction."""
    return h + tail(h, valid, config, seed) * valid[..., None, None]


def raw_table(h: np.ndarray, grid: SphericalGrid, sample_rate: int) -> Table:
    """The float64 table of responses h (E, A_max, 2, T) kept whole: no
    delays, unit gains, ``decomposed`` False."""
    valid = grid.validity_mask().astype(np.float64)
    E, A = h.shape[:2]
    return Table(h=h * valid[..., None, None], delays=np.zeros((E, A, 2)),
                 gains=np.ones((E, A, 2)),
                 elevs=np.asarray(grid.elevs, dtype=np.float64),
                 az_counts=np.asarray(grid.az_counts, dtype=np.int64),
                 valid=valid, sample_rate=int(sample_rate), decomposed=False)

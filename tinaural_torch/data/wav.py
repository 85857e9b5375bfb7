"""WAV file I/O (host numpy, a copy of `tinaural.data.wav`).

Reads any integer/float PCM WAV into float64 in [-1, 1]; writes int16
(default) or float32, through ``scipy.io.wavfile``.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

_INT_SCALES = {
    np.dtype(np.int16): 2.0**15,
    np.dtype(np.int32): 2.0**31,
    np.dtype(np.uint8): 2.0**7,  # offset binary
}


def read_wav(path) -> tuple[int, np.ndarray]:
    """Read a WAV file → ``(sample_rate, samples)``.

    Samples are float64 scaled to [-1, 1], shape (n,) for mono or
    (n, channels) otherwise.
    """
    sr, data = wavfile.read(path)
    dt = data.dtype
    if dt == np.uint8:
        out = (data.astype(np.float64) - 128.0) / _INT_SCALES[np.dtype(np.uint8)]
    elif dt in (np.int16, np.int32):
        out = data.astype(np.float64) / _INT_SCALES[np.dtype(dt)]
    else:  # float32/float64 WAV
        out = data.astype(np.float64)
    return int(sr), out


def write_wav(path, sample_rate: int, samples: np.ndarray, dtype: str = "int16",
              normalize: bool = False) -> None:
    """Write samples (shape (n,) or (n, ch), float in [-1, 1]) to ``path``.

    With ``normalize=True``, peak-normalize to 0.99 full scale first
    (useful after stereo mixdowns that can exceed unity).
    """
    x = np.asarray(samples, dtype=np.float64)
    if normalize:
        peak = np.max(np.abs(x))
        if peak > 0:
            x = x * (0.99 / peak)
    if dtype == "int16":
        x = np.clip(x, -1.0, 1.0)
        # round, don't truncate: truncation toward zero adds up to 1 LSB
        # of signal-correlated error
        wavfile.write(path, sample_rate,
                      np.round(x * (2.0**15 - 1)).astype(np.int16))
    elif dtype == "float32":
        wavfile.write(path, sample_rate, x.astype(np.float32))
    else:
        raise ValueError(f"unsupported dtype {dtype!r}")

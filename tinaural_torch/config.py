"""Render configuration.

The semantic fields of `tinaural.config.RenderConfig`, under the same names,
defaults and validation. The TPU-only knobs (Pallas routing, kernel
precision, FFT packing, filter-assembly path) have no counterpart: the
device of the tensors decides the route (see `tinaural_torch.ops.block_render`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Immutable render settings.

    Attributes:
      sample_rate: audio sample rate in Hz.
      interp: HRTF interpolation on the spherical grid, ``"nearest"`` or
        ``"bilinear"``.
      apply_itd: re-apply the interaural time difference as a phase ramp
        from the table's delay track (decomposed tables only).
      apply_ild: re-apply the interaural level difference as a per-ear gain
        (decomposed tables only).
      block_size: hop size in samples of the trajectory / scene block
        convolution. A power of two.
      stream_block: block size of the streaming renderer. A power of two.
      crossfade: crossfade a moving source's per-block filters.
      scene_chunk: sources per bucket when `render_scene` de-duplicates
        sources (the de-duplicated count is rounded up to a multiple).
      out_length: ``"full"`` → N + taps + DELAY_PAD - 1 samples,
        ``"same"`` → N samples.
      dir_rate: block b of a moving source renders with the direction of
        block ⌊b/dir_rate⌋·dir_rate, and the renders assemble one filter
        per group of ``dir_rate`` blocks (⌈nb/dir_rate⌉ a source), which
        serves the group's blocks. One of 1, 2, 4, 8.
      stream_update_rate: streaming counterpart of ``dir_rate``. One of
        1, 2, 4, 8.
    """

    sample_rate: int = 44100
    interp: str = "bilinear"
    apply_itd: bool = True
    apply_ild: bool = True
    block_size: int = 1024
    stream_block: int = 256
    crossfade: bool = True
    scene_chunk: int = 8
    out_length: str = "full"
    dir_rate: int = 1
    stream_update_rate: int = 1

    def __post_init__(self):
        if self.interp not in ("nearest", "bilinear"):
            raise ValueError(f"interp must be nearest|bilinear, got {self.interp!r}")
        if self.out_length not in ("full", "same"):
            raise ValueError(f"out_length must be full|same, got {self.out_length!r}")
        for name in ("block_size", "stream_block"):
            v = getattr(self, name)
            if v <= 0 or (v & (v - 1)) != 0:
                raise ValueError(f"{name} must be a positive power of two, got {v}")
        if self.dir_rate not in (1, 2, 4, 8):
            raise ValueError(
                f"dir_rate must be one of 1, 2, 4, 8, got {self.dir_rate}")
        if self.stream_update_rate not in (1, 2, 4, 8):
            raise ValueError(
                f"stream_update_rate must be one of 1, 2, 4, 8, "
                f"got {self.stream_update_rate}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()

"""tinaural_torch — binaural audio synthesis in PyTorch, with hand-written
CUDA kernels for the NVIDIA H100.

A port of `tinaural` (JAX on a TPU), which stays the reference it is held
against. It imports torch, numpy and scipy, never jax or flax. Routes are
picked by the device of the tensors: CUDA tensors run the kernels of
``csrc/``, CPU tensors their plain torch versions.
"""

from .config import DEFAULT_CONFIG, RenderConfig
from .data import HrirArrays, TorchTable, load_hrir_set, read_wav, write_wav
from .models.renderer import (BinauralRenderer, render, render_scene,
                              render_trajectory)
from .models.streaming import BatchedStream, Stream, StreamState, init_state

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "DEFAULT_CONFIG",
    "HrirArrays",
    "TorchTable",
    "load_hrir_set",
    "read_wav",
    "write_wav",
    "BinauralRenderer",
    "render",
    "render_trajectory",
    "render_scene",
    "Stream",
    "BatchedStream",
    "StreamState",
    "init_state",
]

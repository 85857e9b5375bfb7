"""Data layer: HRIR grids, the synthetic set, tables, loaders and WAV
I/O."""

from .grids import SphericalGrid, kemar_grid
from .loaders import load_hrir_set
from .synthetic import synthesize_hrirs
from .table import (HrirArrays, TorchTable, build_table, decompose_table,
                    estimate_delays, fractional_shift, load_table, save_table)
from .wav import read_wav, write_wav

__all__ = [
    "SphericalGrid",
    "kemar_grid",
    "load_hrir_set",
    "synthesize_hrirs",
    "HrirArrays",
    "TorchTable",
    "build_table",
    "decompose_table",
    "estimate_delays",
    "fractional_shift",
    "save_table",
    "load_table",
    "read_wav",
    "write_wav",
]

"""The system under test and the reference, built from a configuration file
and the run's seed.

The raw HRIRs come from the benchmark's frozen copy of the synthetic head
model, seeded by the run; the program decomposes them with its own
`build_table` into its float32 `TorchTable`, and the reference decomposes
the same raw array with its own float64 copy of the decomposition. Only
`program_*` touches the program.
"""

from __future__ import annotations

import numpy as np

from ..reference import fast, synthetic
from ..reference import table as reference_table_mod
from ..reference.grids import SphericalGrid
from . import inputs


def grid(config: dict) -> SphericalGrid:
    g = config["grid"]
    return SphericalGrid(elevs=np.asarray(g["elevs"], dtype=np.float64),
                         az_counts=np.asarray(g["az_counts"], dtype=np.int64))


def raw_hrirs(config: dict, seed: int) -> np.ndarray:
    """(E, A_max, 2, taps) float64 raw HRIRs of the configuration's head
    model, its measurement noise drawn from the seed."""
    hr = config["hrir"]
    h, _ = synthetic.synthesize_hrirs(
        grid(config), taps=config["taps"], sample_rate=config["sample_rate"],
        head_radius=hr["head_radius_m"], noise=hr["noise"],
        seed=int(inputs.rng(seed, "hrir").integers(1 << 62)))
    return h


def program_table(config: dict, h: np.ndarray, device):
    """The program's table: its own decomposition of h, on ``device``."""
    from tinaural_torch.data.grids import SphericalGrid as ProgramGrid
    from tinaural_torch.data.table import TorchTable, build_table

    g = config["grid"]
    pg = ProgramGrid(elevs=np.asarray(g["elevs"], dtype=np.float64),
                     az_counts=np.asarray(g["az_counts"], dtype=np.int64))
    arrays = build_table(h, pg, config["sample_rate"], decompose=True)
    return TorchTable.from_hrir_table(arrays, device)


def program_config(config: dict):
    from tinaural_torch import RenderConfig

    return RenderConfig(sample_rate=config["sample_rate"], **config["render"])


def reference_table(config: dict, h: np.ndarray) -> reference_table_mod.Table:
    return reference_table_mod.build(h, grid(config), config["sample_rate"])


def reference_config(config: dict) -> fast.Config:
    r = config["render"]
    return fast.Config(**{k: r[k] for k in (
        "interp", "apply_itd", "apply_ild", "block_size", "crossfade",
        "out_length", "dir_rate")})


def launches() -> dict:
    """The program's launch counters, every kernel by name."""
    from tinaural_torch.ops import (assembly_mac, block_render, block_step,
                                    partitioned_conv)

    out = {}
    for mod in (block_render, block_step, assembly_mac, partitioned_conv):
        out.update(mod.launches)
    return out

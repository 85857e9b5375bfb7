"""Build the package's CUDA sources at first use and bind them with ctypes.

`nvcc` compiles each ``tinaural_torch/csrc/*.cu`` for ``sm_90a`` (all of
them at once, one process per source) and links them into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library lands in ``tinaural_torch/_build/`` under a name keyed
by a hash of the sources and flags, and is rebuilt only when they change.
A failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entry points of kernels with FFTs end in (scratch, slices, work,
# stream): see ops/_layout.py
_SPLIT = [_P, _I, _I, _P]
_SIGNATURES = {
    "tt_max_shared_bytes": [_I],
    "tt_assemble_filters": [_P] * 10 + [_I] * 11 + [_F] * 4 + _SPLIT,
    "tt_assemble_filters_clusters": [_I],
    "tt_block_spectra_mix_inverse": [_P] * 5 + [_I] * 10 + _SPLIT,
    "tt_overlap_add": [_P] * 2 + [_I] * 6 + [_P],
    "tt_assemble_partitions": [_P] * 11 + [_I] * 11 + [_F] * 4 + _SPLIT,
    "tt_stream_conv": [_P] * 14 + [_I] * 7 + _SPLIT,
    "tt_frame_spectra": [_P] * 3 + [_I] * 7 + [_P],
    "tt_partitioned_conv": [_P] * 6 + [_I] * 11 + _SPLIT,
    "tt_block_spectra": [_P] * 5 + [_I] * 9 + _SPLIT,
    "tt_block_spectra_mix": [_P] * 5 + [_I] * 10 + _SPLIT,
    "tt_spectra_inverse": [_P] * 4 + [_I] * 6 + _SPLIT,
    "tt_assembly_mac": [_P] * 13 + [_I] * 11 + [_F] * 4 + _SPLIT,
    "tt_assembly_mac_clusters": [_I],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _sources() -> list[Path]:
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtinaural_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library does not exist yet. The
    compiler's report (registers, shared memory, spills per kernel) is
    kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    compiles = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = [proc.communicate()[0] for _, _, proc in compiles]
    for (cmd, _, proc), text in zip(compiles, log):
        _check_nvcc(cmd, proc.returncode, text)
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *[str(obj) for _, obj, _ in compiles]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _check_nvcc(cmd, proc.returncode, proc.stdout + proc.stderr)
    for _, obj, _ in compiles:
        obj.unlink()
    out.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, out)
    return out


def _check_nvcc(cmd: list[str], rc: int, output: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{output}")


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tt_error_string.argtypes = [ctypes.c_int]
    lib.tt_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().tt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")

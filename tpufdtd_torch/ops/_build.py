"""Builds and loads the hand-written Hopper kernels.

All of `tpufdtd_torch/csrc/*.cu` is compiled on first use, with nvcc, into
one shared library with a plain C interface, cached in
`tpufdtd_torch/_build/` under a hash of the sources and flags, and loaded
with ctypes. Pointers and the CUDA stream cross as `c_void_p`; each C entry
returns `cudaGetLastError()` after its launch, and `check` raises on any
nonzero code. A missing nvcc raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # cur, prev, m (or null), target, nx, ny, nz, halo, radius, coeffs, stream
    "tpufdtd_leapfrog_step": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # uin, uout, nx, ny, nz, halo, radius, k, isotropic, xc, ty, tz, ythreads,
    # coeffs, stream
    "tpufdtd_sweep": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
}

_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the"
        " 'cuda' backend builds its kernels from tpufdtd_torch/csrc with it"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The kernel library, built on first call in this checkout."""
    if "lib" in _loaded:
        return _loaded["lib"]
    BUILD_DIR.mkdir(exist_ok=True)
    tag = _digest()
    so = BUILD_DIR / f"libtpufdtd_torch_{tag}.so"
    log = BUILD_DIR / f"libtpufdtd_torch_{tag}.log"
    if not so.exists():
        nvcc = nvcc_path()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        sources = [str(f) for f in sorted(CSRC.glob("*.cu"))]
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded["lib"] = lib
    _loaded["log"] = log.read_text() if log.exists() else ""
    return lib


def build_log() -> str:
    """nvcc's output for the loaded library, including the `-Xptxas -v`
    register and shared-memory lines of every kernel."""
    library()
    return _loaded["log"]


def check(code: int, what: str) -> None:
    if code >= 1000:
        raise ValueError(f"{what}: radius {code - 1000} is not built into this kernel")
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def coeff_array(values) -> ctypes.Array:
    """The 16 f32 scalars of csrc/fdtd_common.cuh:Coeffs, in its order."""
    arr = (ctypes.c_float * 16)()
    for i, v in enumerate(values):
        arr[i] = float(v)
    return arr

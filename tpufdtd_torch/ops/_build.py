"""Builds and loads the hand-written Hopper kernels.

All of `tpufdtd_torch/csrc/*.cu` is compiled on first use, with nvcc (one
process per source, all started together), and linked into one shared
library with a plain C interface, cached in `tpufdtd_torch/_build/` under a
hash of the sources and flags, and loaded with ctypes. Pointers and the CUDA stream cross as `c_void_p`; each C entry
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
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name: (argument types, return type)
_SIGNATURES = {
    # cur, prev, m (or null), target, nx, ny, nz, halo, radius, bf16_storage,
    # xc, ty, tz, coeffs, stream
    "tpufdtd_leapfrog_step": ([_P, _P, _P, _P] + [_I] * 9 + [_P, _P], _I),
    # radius, ty, tz, bf16_storage, per_point_m -> the bytes of shared
    # memory tpufdtd_leapfrog_step requests per block
    "tpufdtd_step_smem": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
    # radius, ty, tz, out[2] <- cells per thread, blocks per SM
    "tpufdtd_step_policy": ([_I, _I, _I, ctypes.POINTER(_I)], None),
    # uin, uout, w (or null), nx, ny, nz, halo, radius, k, isotropic,
    # bf16_storage, xc, ty, tz, frozen_lo, frozen_hi, frozen_ylo, frozen_yhi,
    # nxpa (the arrays' padded x extent: their level stride in planes),
    # coeffs, stream
    "tpufdtd_sweep": ([_P, _P, _P] + [_I] * 16 + [_P, _P], _I),
    # radius, k, ty, tz, bf16_storage, w_stream -> the bytes of shared
    # memory tpufdtd_sweep requests per block
    "tpufdtd_sweep_smem": ([_I, _I, _I, _I, _I, _I], ctypes.c_longlong),
    # radius, k, out[2] <- cells per thread, blocks per SM
    "tpufdtd_sweep_policy": ([_I, _I, ctypes.POINTER(_I)], None),
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
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            log.write_text(_compile_and_link(nvcc_path(), Path(tmp), so))
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _loaded["lib"] = lib
    _loaded["log"] = log.read_text() if log.exists() else ""
    return lib


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(cmd, proc) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return out


def _compile_and_link(nvcc: str, tmp: Path, so: Path) -> str:
    """One nvcc per source, all running at once, then one link; returns
    their output, with a line "nvcc <source>: <seconds> s" per source (its
    wall time from the common start). The library appears at `so` only
    when all succeeded."""
    sources = sorted(CSRC.glob("*.cu"))
    objs = [str(tmp / f"{src.stem}.o") for src in sources]
    start = time.monotonic()
    jobs, results = [], {}

    def wait(name, cmd, proc):
        try:
            results[name] = (_wait(cmd, proc), time.monotonic() - start)
        except RuntimeError as e:
            results[name] = (e, 0.0)

    for src, obj in zip(sources, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", obj, str(src)]
        proc = _run(cmd)
        thread = threading.Thread(target=wait, args=(src.name, cmd, proc))
        thread.start()
        jobs.append((proc, thread))
    try:
        for _proc, thread in jobs:
            thread.join()
    finally:
        for proc, _thread in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = ""
    for name in sorted(results):
        text, secs = results[name]
        if isinstance(text, RuntimeError):
            raise text
        out += text + f"nvcc {name}: {secs:.1f} s\n"
    cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp / so.name), *objs]
    out += _wait(cmd, _run(cmd))
    os.replace(tmp / so.name, so)
    return out


def build_log() -> str:
    """nvcc's output for the loaded library, including the `-Xptxas -v`
    register and shared-memory lines of every kernel."""
    library()
    return _loaded["log"]


def check(code: int, what: str) -> None:
    if code >= 2000:
        raise ValueError(f"{what}: depth K = {code - 2000} is not built into this radius")
    if code >= 1000:
        raise ValueError(f"{what}: radius {code - 1000} is not built into this mode of the kernel")
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def coeff_array(values) -> ctypes.Array:
    """The 16 f32 scalars of csrc/fdtd_common.cuh:Coeffs, in its order."""
    arr = (ctypes.c_float * 16)()
    for i, v in enumerate(values):
        arr[i] = float(v)
    return arr

"""Kernel A: one leapfrog step from (cur, prev) into a separate target.

Replaces the kernels of the exact three-level ring:
tpufdtd/ops/stencil_pallas_z.py:leapfrog_step_zsplit (radius <= 4) and
tpufdtd/ops/stencil_pallas.py:leapfrog_step_pallas (any order 2-12; the
ring at orders 10-12). The CUDA source is csrc/stencil_step.cu (one thread
per interior point, radius 1-6, scalar or per-point m; bound by device
memory at 12 B per point in f32 and 6 B in bf16, plus 4 B for a per-point
m). It writes only the target's interior, so each ring level keeps its own
rim, as leapfrog_step_pallas stores the target's rim back.

Storage: cur, prev and target are all f32 or all bf16, as the TPU kernels
store in the dtype of their inputs; bf16 is widened on load, computed in
f32 and rounded once on the store. m stays f32.

`leapfrog_step` launches the kernel for CUDA tensors and runs the plain
version `leapfrog_step_ref` for CPU tensors; `counts` records which ran,
per (radius, storage dtype, "scalar" or "per-point" m).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..config import Grid3D
from . import _build, stencil_torch

# launches per (radius, storage dtype name, "scalar" or "per-point" m):
# counts["kernel"] of the CUDA kernel, counts["plain"] of the plain version
counts = {"kernel": Counter(), "plain": Counter()}
STORAGE = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def mode_key(grid: Grid3D, target, m) -> tuple:
    """The counts key of a call: (radius, storage dtype, m's kind)."""
    return grid.radius, STORAGE[target.dtype], "per-point" if torch.is_tensor(m) else "scalar"


def reset_counts() -> None:
    for c in counts.values():
        c.clear()


def launches(route: str = "kernel") -> int:
    """Launches of `route` since the last reset, over every mode."""
    return sum(counts[route].values())


def coeff_values(grid: Grid3D, dt: float, m_val) -> list:
    """The Coeffs block of csrc/fdtd_common.cuh for this grid and dt."""
    c = stencil_torch.coefficients(grid, dt)
    w = list(c["W"]) + [np.float32(0.0)] * (7 - len(c["W"]))
    m = np.float32(1.0 if m_val is None else m_val)
    r2 = c["rax"][0]
    return w + [
        c["dt2"], c["r1"], c["neg2r1"], *c["rax"], m,
        np.float32(3.0) * c["W"][0],
        c["dt2"] * r2 / m,
    ]


def leapfrog_step_ref(cur, prev, m, target, *, grid: Grid3D, dt: float):
    """Plain PyTorch version of the kernel: the eager step into target, in
    f32, rounded once to target's dtype on the store."""
    counts["plain"][mode_key(grid, target, m)] += 1
    return stencil_torch.leapfrog_step(cur, prev, m, target, grid=grid, dt=dt)


def _check(cur, prev, m, target, grid: Grid3D):
    shape = tuple(grid.padded_shape)
    tensors = {"cur": cur, "prev": prev, "target": target}
    if torch.is_tensor(m):
        tensors["m"] = m
    elif not isinstance(m, (float, int, np.floating)):
        raise TypeError(f"m must be a tensor or a scalar; got {type(m).__name__}")
    for name, t in tensors.items():
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor; got {type(t).__name__}")
        want = torch.float32 if name == "m" else cur.dtype
        if t.dtype != want or t.dtype not in STORAGE:
            raise ValueError(f"{name} must be {want} (levels float32 or bfloat16, all alike;"
                             f" m float32); got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have the padded shape {shape}; got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != cur.device:
            raise ValueError(f"{name} is on {t.device}, cur on {cur.device}")
    if target.data_ptr() in (cur.data_ptr(), prev.data_ptr()):
        raise ValueError("target must be a separate buffer from cur and prev")
    if grid.radius > 6:
        raise ValueError(f"radius {grid.radius} is beyond the kernel's 1..6")


@torch.no_grad()
def leapfrog_step(cur, prev, m, target, *, grid: Grid3D, dt: float):
    """u_next into target's interior (in place); returns target.

    cur, prev and target are f32 or bf16, all alike; m is a full padded f32
    tensor or a scalar. CPU tensors take the plain version; CUDA tensors
    launch the kernel, and a failed launch raises.
    """
    _check(cur, prev, m, target, grid)
    if cur.device.type == "cpu":
        return leapfrog_step_ref(cur, prev, m, target, grid=grid, dt=dt)
    if cur.device.type != "cuda":
        raise ValueError(f"no kernel for device {cur.device}")
    m_val = None if torch.is_tensor(m) else float(m)
    coeffs = _build.coeff_array(coeff_values(grid, dt, m_val))
    lib = _build.library()
    with torch.cuda.device(cur.device):
        code = lib.tpufdtd_leapfrog_step(
            cur.data_ptr(), prev.data_ptr(),
            m.data_ptr() if m_val is None else None,
            target.data_ptr(), grid.nx, grid.ny, grid.nz, grid.halo,
            grid.radius, int(cur.dtype == torch.bfloat16), coeffs,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "leapfrog_step")
    counts["kernel"][mode_key(grid, target, m)] += 1
    return target

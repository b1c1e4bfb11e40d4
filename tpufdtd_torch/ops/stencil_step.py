"""Kernel A: one leapfrog step from (cur, prev) into a separate target.

Replaces tpufdtd/ops/stencil_pallas_z.py:leapfrog_step_zsplit, the kernel
of the exact three-level ring. The CUDA source is csrc/stencil_step.cu
(one thread per interior point, radius 1-6, scalar or per-point m; bound
by device memory at 12 B per point, 16 B with a per-point m). It writes
only the target's interior, so each ring level keeps its own rim.

`leapfrog_step` launches the kernel for CUDA tensors and runs the plain
version `leapfrog_step_ref` for CPU tensors; `counts` records which ran.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Grid3D
from . import _build, stencil_torch

counts = {"kernel": 0, "plain": 0}


def reset_counts() -> None:
    counts.update(kernel=0, plain=0)


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
    """Plain PyTorch version of the kernel: the eager step into target."""
    counts["plain"] += 1
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
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {t.dtype}")
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

    m is a full padded f32 tensor or a scalar. CPU tensors take the plain
    version; CUDA tensors launch the kernel, and a failed launch raises.
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
            grid.radius, coeffs, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "leapfrog_step")
    counts["kernel"] += 1
    return target

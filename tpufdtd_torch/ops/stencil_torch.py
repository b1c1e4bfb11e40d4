"""Plain eager leapfrog step in PyTorch.

The arithmetic of the oracle (openacc.cpp:102-107) written as shifted
interior slices, any order 2-12, f32 compute. It runs the "torch" backend on
any device and is the base of the kernels' plain versions.
Counterpart of the JAX package's ops/stencil_jnp.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Grid3D, stencil_weights
from ..layout import Layout


def coefficients(grid: Grid3D, dt: float) -> dict:
    """The step's f32 scalars, each rounded exactly as the oracle rounds it."""
    dt32 = np.float32(dt)
    r1 = np.float32(1.0) / (dt32 * dt32)
    r2 = np.float32(1.0) / (np.float32(grid.hx) * np.float32(grid.hx))
    r3 = np.float32(1.0) / (np.float32(grid.hy) * np.float32(grid.hy))
    r4 = np.float32(1.0) / (np.float32(grid.hz) * np.float32(grid.hz))
    return {
        "W": stencil_weights(grid.order),
        "dt2": dt32 * dt32,
        "r1": r1,
        "neg2r1": np.float32(-2.0) * r1,
        "rax": (r2, r3, r4),
    }


def scalar_f32(x) -> torch.Tensor:
    """A 0-d f32 CPU tensor: an f32 scalar on any device, so that products
    with f32 tensors round in f32."""
    return torch.tensor(float(x), dtype=torch.float32)


def leapfrog_step(
    u_cur: torch.Tensor,
    u_prev: torch.Tensor,
    m,
    target: torch.Tensor | None = None,
    *,
    grid: Grid3D,
    dt: float,
) -> torch.Tensor:
    """One leapfrog step on full reference-layout arrays.

    m is a full padded f32 tensor or a scalar. Only the interior of `target`
    is written, in place, so its own rim survives: the per-ring-level frozen
    boundary. With target=None a copy of u_cur is the target. Returns the
    target.
    """
    lay = Layout.reference(grid)
    c = coefficients(grid, dt)
    # 0-d CPU tensors act as f32 scalars on any device, with no copy
    W = [scalar_f32(w) for w in c["W"]]
    dt2, r1, neg2r1 = (scalar_f32(c[k]) for k in ("dt2", "r1", "neg2r1"))
    rax = [scalar_f32(r) for r in c["rax"]]

    interior = lay.interior_slices()
    u0 = u_cur.float()
    u0c = u0[interior]
    u1c = u_prev[interior].float()
    mc = m[interior].float() if torch.is_tensor(m) else scalar_f32(m)

    r5 = W[0] * u0c
    lap = None
    for axis in range(3):
        acc = r5
        for d in range(grid.radius, 0, -1):
            acc = acc + W[d] * (u0[lay.shifted_slices(axis, -d)] + u0[lay.shifted_slices(axis, d)])
        term = rax[axis] * acc
        lap = term if lap is None else lap + term
    upd = dt2 * (lap - (neg2r1 * u0c + r1 * u1c) * mc) / mc
    if target is None:
        target = u_cur.clone()
    target[interior] = upd.to(target.dtype)
    return target

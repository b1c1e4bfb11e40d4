"""Kernel B: K fused leapfrog steps per pass over device memory.

Replaces the kernels of the fast two-level ring: tpufdtd/ops/stencil_sweep.py
:sweep_fused (radius 1-3), and tpufdtd/ops/stencil_pallas_z.py:packed_step
(K = 1) and packed_fused2 (radius 4, K = 2). The CUDA source is
csrc/stencil_sweep.cu: a 2.5-D x-sweep with temporal blocking in shared
memory, f32, scalar m, radius 1-4 (orders 2-8). It is bound by device
memory: one step alone moves 12 B per point, K fused steps 16 B per point
per K steps plus each block's halo.

U = [u_{n-1}, u_n] in the reference layout, shape [2, nx+2H, ny+2H, nz+2H];
the result [u_{n+K-1}, u_{n+K}] goes to a second buffer `out` (not in
place: CUDA blocks run in parallel, and one block's halo is another's
output). Both buffers must carry the same frozen rims, which the kernel
never writes. For every K, level 0 of the result is u_{n+K-1} and level 1
is u_{n+K}; there is no role flip at K = 1.

`sweep_fused` launches the kernel for CUDA tensors and runs the plain
version `sweep_fused_ref` for CPU tensors; `counts` records which ran, per
(radius, K).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..config import Grid3D
from . import _build, stencil_torch
from .stencil_step import coeff_values

RADII = (1, 2, 3, 4)
# Block shape per (radius R, fusion depth K): (XC, TY, TZ, YT) = the
# x-planes one block sweeps, its (y, z) column (z is the contiguous axis),
# and its 32 x YT threads along (z, y). The fastest shapes at 512^3 on an
# H100 (harness/tile_probe.py; PERF.md).
TILES = {
    (1, 1): (128, 32, 128, 16), (1, 2): (256, 32, 128, 16),
    (1, 3): (128, 32, 32, 8), (1, 4): (512, 32, 64, 16),
    (2, 1): (256, 32, 128, 16), (2, 2): (512, 32, 64, 16),
    (2, 3): (512, 32, 32, 8), (2, 4): (512, 32, 32, 8),
    (3, 1): (512, 32, 64, 16), (3, 2): (512, 32, 32, 8),
    (3, 3): (512, 16, 32, 8), (3, 4): (512, 16, 16, 8),
    (4, 1): (512, 32, 64, 16), (4, 2): (512, 32, 32, 16),
    (4, 3): (512, 16, 16, 8),
}
# Dynamic shared memory one block may use on sm_90 (227 KB).
SMEM_LIMIT = 232448

# launches per (radius, K): counts["kernel"] of the CUDA kernel,
# counts["plain"] of the plain version
counts = {"kernel": Counter(), "plain": Counter()}


def reset_counts() -> None:
    for c in counts.values():
        c.clear()


def launches(route: str = "kernel") -> int:
    """Launches of `route` since the last reset, over every (radius, K)."""
    return sum(counts[route].values())


def smem_bytes(radius: int, k: int, tile=None) -> int:
    """Shared memory of one block: the plane rings of levels u_{n-1} ..
    u_{n+K-1} (csrc/stencil_sweep.cu), each plane its (y, z) column plus a
    K*R halo. The rings hold R+2 planes of u_{n-1} and 2R+2 of u_n (each
    with one plane in flight) and 2R+1 of each of u_{n+1} .. u_{n+K-1}."""
    _xc, ty, tz, _yt = TILES[radius, k] if tile is None else tile
    prev, cur, ring = radius + 2, 2 * radius + 2, 2 * radius + 1
    g2 = 2 * k * radius
    return 4 * (prev + cur + ring * (k - 1)) * (ty + g2) * (tz + g2)


def k_max(radius: int) -> int:
    """Deepest fusion at this radius with a tile whose block fits shared
    memory."""
    return max(k for r, k in TILES if r == radius and smem_bytes(r, k) <= SMEM_LIMIT)


def supported(grid: Grid3D) -> bool:
    return grid.radius in RADII


def _isotropic(grid: Grid3D) -> bool:
    return grid.hx == grid.hy == grid.hz


def sweep_fused_ref(U, *, grid: Grid3D, dt: float, m_val: float, k_fuse: int):
    """Plain PyTorch version of the kernel: k_fuse eager steps, each writing
    only the interior (the rims stay frozen). Returns a new
    [u_{n+K-1}, u_{n+K}] tensor."""
    counts["plain"][grid.radius, k_fuse] += 1
    prev, cur = U[0].clone(), U[1].clone()
    for _ in range(k_fuse):
        stencil_torch.leapfrog_step(cur, prev, m_val, prev, grid=grid, dt=dt)
        prev, cur = cur, prev
    return torch.stack([prev, cur])


def _check(U, out, grid: Grid3D, m_val, k_fuse: int):
    shape = (2,) + tuple(grid.padded_shape)
    for name, t in (("U", U), ("out", out)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor; got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}; got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.device != U.device:
        raise ValueError(f"out is on {out.device}, U on {U.device}")
    if out.data_ptr() == U.data_ptr():
        raise ValueError("out must be a separate buffer from U")
    if not supported(grid):
        raise ValueError(f"the sweep kernel takes radius {RADII} (orders 2-8); got order {grid.order}")
    if not isinstance(m_val, (float, int, np.floating)):
        raise TypeError("the sweep kernel takes a scalar m only")
    kmax = k_max(grid.radius)
    if not 1 <= k_fuse <= kmax:
        raise ValueError(f"k_fuse={k_fuse} out of range 1..{kmax} at radius {grid.radius}")


@torch.no_grad()
def sweep_fused(U, out, *, grid: Grid3D, dt: float, m_val: float, k_fuse: int, tile=None):
    """[u_{n-1}, u_n] in U -> [u_{n+K-1}, u_{n+K}] in out's interior;
    returns out. CPU tensors take the plain version; CUDA tensors launch the
    kernel, and a failed launch raises. `tile` = (XC, TY, TZ, YT) overrides
    the block shape of TILES, for tuning."""
    _check(U, out, grid, m_val, k_fuse)
    R = grid.radius
    tile = TILES[R, k_fuse] if tile is None else tuple(tile)
    need = smem_bytes(R, k_fuse, tile)
    if need > SMEM_LIMIT:
        raise ValueError(f"tile {tile} at R={R}, K={k_fuse} needs {need} B of shared memory")
    if U.device.type == "cpu":
        res = sweep_fused_ref(U, grid=grid, dt=dt, m_val=m_val, k_fuse=k_fuse)
        interior = (slice(None),) + grid.interior_slices()
        out[interior] = res[interior]
        return out
    if U.device.type != "cuda":
        raise ValueError(f"no kernel for device {U.device}")
    coeffs = _build.coeff_array(coeff_values(grid, dt, m_val))
    lib = _build.library()
    with torch.cuda.device(U.device):
        code = lib.tpufdtd_sweep(
            U.data_ptr(), out.data_ptr(), grid.nx, grid.ny, grid.nz, grid.halo,
            R, k_fuse, int(_isotropic(grid)), *tile, coeffs,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "sweep_fused")
    counts["kernel"][R, k_fuse] += 1
    return out

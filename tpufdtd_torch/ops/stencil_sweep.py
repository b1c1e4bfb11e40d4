"""Kernel B: K fused leapfrog steps per pass over device memory.

Replaces tpufdtd/ops/stencil_sweep.py:sweep_fused, the kernel of the fast
two-level ring. The CUDA source is csrc/stencil_sweep.cu: a 2.5-D x-sweep
with temporal blocking in shared memory, f32, scalar m, radius 2 (order
4). It is bound by device memory: one step alone moves 12 B per point, K
fused steps 16 B per point per K steps plus each block's halo.

U = [u_{n-1}, u_n] in the reference layout, shape [2, nx+2H, ny+2H, nz+2H];
the result [u_{n+K-1}, u_{n+K}] goes to a second buffer `out` (not in
place: CUDA blocks run in parallel, and one block's halo is another's
output). Both buffers must carry the same frozen rims, which the kernel
never writes. For every K, level 0 of the result is u_{n+K-1} and level 1
is u_{n+K}; there is no role flip at K = 1.

`sweep_fused` launches the kernel for CUDA tensors and runs the plain
version `sweep_fused_ref` for CPU tensors; `counts` records which ran.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Grid3D
from . import _build, stencil_torch
from .stencil_step import coeff_values

RADIUS = 2
# Block shape per fusion depth K: (XC, TY, TZ, YT) = the x-planes one
# block sweeps, its (y, z) column (z is the contiguous axis), and its
# 32 x YT threads along (z, y). The fastest shapes at 512^3 on an H100
# (harness/tile_probe.py; PERF.md).
TILES = {1: (256, 32, 128, 16), 2: (512, 32, 64, 16), 3: (512, 32, 32, 8),
         4: (512, 32, 32, 8)}
# Shared-memory planes per level (csrc/stencil_sweep.cu): u_{n-1}, u_n
# (each with one plane in flight), and each of u_{n+1} .. u_{n+K-1}.
PREV_RING, CUR_RING, RING = RADIUS + 2, 2 * RADIUS + 2, 2 * RADIUS + 1
# Dynamic shared memory one block may use on sm_90 (227 KB).
SMEM_LIMIT = 232448

counts = {"kernel": 0, "plain": 0}


def reset_counts() -> None:
    counts.update(kernel=0, plain=0)


def smem_bytes(k: int, tile=None) -> int:
    """Shared memory of one block: the plane rings of levels u_{n-1} ..
    u_{n+K-1} (csrc/stencil_sweep.cu), each plane its (y, z) column plus a
    K*R halo."""
    _xc, ty, tz, _yt = TILES[k] if tile is None else tile
    g2 = 2 * k * RADIUS
    return 4 * (PREV_RING + CUR_RING + RING * (k - 1)) * (ty + g2) * (tz + g2)


def k_max() -> int:
    """Deepest fusion with a tile whose block fits shared memory."""
    return max(k for k in TILES if smem_bytes(k) <= SMEM_LIMIT)


def supported(grid: Grid3D) -> bool:
    return grid.radius == RADIUS


def _isotropic(grid: Grid3D) -> bool:
    return grid.hx == grid.hy == grid.hz


def sweep_fused_ref(U, *, grid: Grid3D, dt: float, m_val: float, k_fuse: int):
    """Plain PyTorch version of the kernel: k_fuse eager steps, each writing
    only the interior (the rims stay frozen). Returns a new
    [u_{n+K-1}, u_{n+K}] tensor."""
    counts["plain"] += 1
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
        raise ValueError(f"the sweep kernel takes radius {RADIUS} (order 4); got order {grid.order}")
    if not isinstance(m_val, (float, int, np.floating)):
        raise TypeError("the sweep kernel takes a scalar m only")
    if not 1 <= k_fuse <= k_max():
        raise ValueError(f"k_fuse={k_fuse} out of range 1..{k_max()}")


@torch.no_grad()
def sweep_fused(U, out, *, grid: Grid3D, dt: float, m_val: float, k_fuse: int, tile=None):
    """[u_{n-1}, u_n] in U -> [u_{n+K-1}, u_{n+K}] in out's interior;
    returns out. CPU tensors take the plain version; CUDA tensors launch the
    kernel, and a failed launch raises. `tile` = (XC, TY, TZ, YT) overrides
    the block shape of TILES, for tuning."""
    _check(U, out, grid, m_val, k_fuse)
    tile = TILES[k_fuse] if tile is None else tuple(tile)
    if smem_bytes(k_fuse, tile) > SMEM_LIMIT:
        raise ValueError(f"tile {tile} at K={k_fuse} needs {smem_bytes(k_fuse, tile)} B of shared memory")
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
            grid.radius, k_fuse, int(_isotropic(grid)), *tile, coeffs,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "sweep_fused")
    counts["kernel"] += 1
    return out

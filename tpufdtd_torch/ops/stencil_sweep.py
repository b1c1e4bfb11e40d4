"""Kernel B: K fused leapfrog steps per pass over device memory.

Replaces the kernels of the fast two-level ring: tpufdtd/ops/stencil_sweep.py
:sweep_fused (radius 1-3, its w and bf16 modes included), and
tpufdtd/ops/stencil_pallas_z.py:packed_step (K = 1) and packed_fused2
(radius 4, K = 2). The CUDA source is csrc/stencil_sweep.cuh (built by
stencil_sweep.cu for f32 and stencil_sweep_bf16.cu for bf16): a 2.5-D
x-sweep with temporal blocking in shared memory, radius 1-4 (orders 2-8).
It is bound by device memory: one step alone moves 12 B per point in f32,
K fused steps 16 B per point per K steps plus each block's halo.

Modes, at radius 1-3 as in the TPU sweep (radius 4 takes f32 and a scalar
m only):
  * medium: a scalar m, or `w`, an f32 tensor of the padded shape holding
    the per-point update scale of a heterogeneous medium (`w_stream`); each
    stage reads it from device memory, 4 B per point per call more;
  * storage: U and out f32, or both bf16 (half the bytes); compute is f32
    throughout, and only the two output levels are rounded to bf16, once
    per K-block, so a bf16 K-block is not K bf16 steps.
The shared-memory rings are f32 in every mode, so `smem_bytes`, `k_max`
and the block shapes of `TILES` hold for all of them.

U = [u_{n-1}, u_n] in the reference layout, shape [2, nx+2H, ny+2H, nz+2H];
the result [u_{n+K-1}, u_{n+K}] goes to a second buffer `out` (not in
place: CUDA blocks run in parallel, and one block's halo is another's
output). Both buffers must carry the same frozen rims, which the kernel
never writes. For every K, level 0 of the result is u_{n+K-1} and level 1
is u_{n+K}; there is no role flip at K = 1.

`sweep_fused` launches the kernel for CUDA tensors and runs the plain
version `sweep_fused_ref` for CPU tensors; `counts` records which ran, per
(radius, K, storage dtype, "m" or "w").
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..config import Grid3D, stencil_weights
from ..layout import Layout
from . import _build, stencil_torch
from .stencil_step import STORAGE, coeff_values

RADII = (1, 2, 3, 4)
# radii of the w stream and of bf16 storage (the TPU sweep's, orders 2-6)
MODE_RADII = (1, 2, 3)
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
# Block shapes of the other modes where the probe found a shape at least
# 3 % faster than TILES' at 512^3 on an H100 (harness/tile_probe.py;
# PERF.md), per (storage dtype, medium): {(R, K): (XC, TY, TZ, YT)}.
MODE_TILES = {
    ("float32", "w"): {
        (1, 1): (128, 16, 128, 16), (1, 2): (128, 16, 64, 8), (2, 1): (128, 16, 128, 8),
        (2, 3): (512, 16, 32, 8), (2, 4): (512, 32, 32, 16), (3, 2): (512, 32, 32, 16),
    },
    ("bfloat16", "m"): {
        (1, 1): (128, 32, 32, 8), (1, 2): (128, 32, 64, 16), (2, 1): (128, 32, 32, 8),
        (2, 2): (128, 32, 32, 16), (2, 3): (512, 32, 32, 16), (2, 4): (512, 32, 32, 16),
        (3, 1): (128, 32, 32, 8), (3, 2): (512, 32, 32, 16), (3, 3): (512, 16, 32, 16),
        (3, 4): (512, 16, 16, 16),
    },
    ("bfloat16", "w"): {
        (1, 1): (128, 8, 64, 4), (1, 2): (128, 32, 32, 8), (2, 1): (128, 16, 32, 4),
        (2, 3): (512, 32, 32, 16), (2, 4): (512, 32, 32, 16), (3, 1): (128, 32, 32, 8),
        (3, 2): (512, 32, 32, 16), (3, 3): (512, 16, 32, 16), (3, 4): (512, 16, 16, 16),
    },
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
    """Launches of `route` since the last reset, over every mode."""
    return sum(counts[route].values())


def smem_bytes(radius: int, k: int, tile=None) -> int:
    """Shared memory of one block: the f32 plane rings of levels u_{n-1} ..
    u_{n+K-1} (csrc/stencil_sweep.cuh), each plane its (y, z) column plus a
    K*R halo. The rings hold R+2 planes of u_{n-1} and 2R+2 of u_n (each
    with one plane in flight) and 2R+1 of each of u_{n+1} .. u_{n+K-1}. The
    same in every mode: w is read from device memory, and bf16 planes are
    widened into the f32 rings."""
    _xc, ty, tz, _yt = TILES[radius, k] if tile is None else tile
    prev, cur, ring = radius + 2, 2 * radius + 2, 2 * radius + 1
    g2 = 2 * k * radius
    return 4 * (prev + cur + ring * (k - 1)) * (ty + g2) * (tz + g2)


def k_max(radius: int) -> int:
    """Deepest fusion at this radius with a tile whose block fits shared
    memory."""
    return max(k for r, k in TILES if r == radius and smem_bytes(r, k) <= SMEM_LIMIT)


def tile_for(radius: int, k: int, storage: str = "float32", medium: str = "m") -> tuple:
    """The block shape kernel B takes in a mode."""
    return MODE_TILES.get((storage, medium), {}).get((radius, k), TILES[radius, k])


def supported(grid: Grid3D) -> bool:
    return grid.radius in RADII


def _isotropic(grid: Grid3D) -> bool:
    return grid.hx == grid.hy == grid.hz


def mode_key(grid: Grid3D, k_fuse: int, U, w) -> tuple:
    """The counts key of a call: (radius, K, storage dtype name, "m" or "w")."""
    return (grid.radius, k_fuse, STORAGE[U.dtype], "m" if w is None else "w")


def w_stream(grid: Grid3D, dt: float, m) -> np.ndarray:
    """The w mode's per-point update scale for a medium m (padded shape):
    dt^2/(h^2 m) for isotropic h, else dt^2/m, computed in f64 and rounded
    to f32 (tpufdtd/stepper.py:278-293). Cells with m <= 0 get 0."""
    md = np.asarray(m, np.float64)
    num = float(dt) ** 2
    if _isotropic(grid):
        num /= float(grid.hx) ** 2
    return np.where(md > 0, num / np.where(md > 0, md, 1.0), 0.0).astype(np.float32)


def _leap_w(cur, prev, w, target, *, grid: Grid3D):
    """One step of the w mode into target's interior, in the TPU sweep's
    form term for term (tpufdtd/ops/stencil_sweep.py:505-508, 539-540):
    w * acc + (2 c - prev) with one accumulator for isotropic h, else
    w * (r2 tx + r3 ty + r4 tz) + (2 c - prev)."""
    f32 = stencil_torch.scalar_f32
    lay = Layout.reference(grid)
    W = stencil_weights(grid.order)
    Wt = [f32(x) for x in W]
    interior = lay.interior_slices()
    c = cur[interior]

    def pair(axis, d):  # (minus, plus) neighbours at distance d
        return cur[lay.shifted_slices(axis, -d)], cur[lay.shifted_slices(axis, d)]

    if _isotropic(grid):
        acc = f32(np.float32(3.0) * W[0]) * c
        for d in range(grid.radius, 0, -1):
            (xm, xp), (ym, yp), (zm, zp) = pair(0, d), pair(1, d), pair(2, d)
            nb = xm + xp
            nb = nb + ym
            nb = nb + yp
            nb = nb + zp
            nb = nb + zm
            acc = acc + Wt[d] * nb
        spatial = acc
    else:
        r2, r3, r4 = (f32(r) for r in stencil_torch.coefficients(grid, 1.0)["rax"])
        tx = ty = tz = Wt[0] * c
        for d in range(grid.radius, 0, -1):
            (xm, xp), (ym, yp), (zm, zp) = pair(0, d), pair(1, d), pair(2, d)
            tx = tx + Wt[d] * (xm + xp)
            ty = ty + Wt[d] * (ym + yp)
            tz = tz + Wt[d] * (zp + zm)
        spatial = r2 * tx + r3 * ty + r4 * tz
    target[interior] = w[interior] * spatial + (f32(2.0) * c - prev[interior])
    return target


def sweep_fused_ref(U, *, grid: Grid3D, dt: float, m_val, k_fuse: int, w=None):
    """Plain PyTorch version of the kernel: U widened to f32, k_fuse eager
    f32 steps, each writing only the interior (the rims stay frozen), the
    two outputs rounded to U's dtype once at the end. A scalar m takes the
    oracle's form (stencil_torch), w the TPU sweep's w form. Returns a new
    [u_{n+K-1}, u_{n+K}] tensor."""
    counts["plain"][mode_key(grid, k_fuse, U, w)] += 1
    prev = U[0].to(torch.float32, copy=True)
    cur = U[1].to(torch.float32, copy=True)
    for _ in range(k_fuse):
        if w is None:
            stencil_torch.leapfrog_step(cur, prev, m_val, prev, grid=grid, dt=dt)
        else:
            _leap_w(cur, prev, w, prev, grid=grid)
        prev, cur = cur, prev
    return torch.stack([prev, cur]).to(U.dtype)


def _check(U, out, grid: Grid3D, m_val, k_fuse: int, w):
    shape = (2,) + tuple(grid.padded_shape)
    for name, t in (("U", U), ("out", out)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor; got {type(t).__name__}")
        if t.dtype not in STORAGE or t.dtype != U.dtype:
            raise ValueError(f"U and out must both be float32 or both bfloat16; got {U.dtype},"
                             f" {t.dtype}")
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
    if (w is not None or U.dtype != torch.float32) and grid.radius not in MODE_RADII:
        raise ValueError("the w stream and bf16 storage take radius 1-3 (orders 2-6), as the"
                         f" TPU sweep does; got order {grid.order}")
    if w is None:
        if not isinstance(m_val, (float, int, np.floating)):
            raise TypeError("the sweep kernel takes a scalar m_val, or a per-point w")
    elif not torch.is_tensor(w) or w.dtype != torch.float32 or tuple(w.shape) != shape[1:]:
        raise ValueError(f"w must be a float32 tensor of the padded shape {shape[1:]}")
    elif not w.is_contiguous() or w.device != U.device:
        raise ValueError(f"w must be contiguous and on {U.device}")
    kmax = k_max(grid.radius)
    if not 1 <= k_fuse <= kmax:
        raise ValueError(f"k_fuse={k_fuse} out of range 1..{kmax} at radius {grid.radius}")


@torch.no_grad()
def sweep_fused(U, out, *, grid: Grid3D, dt: float, m_val, k_fuse: int, w=None, tile=None):
    """[u_{n-1}, u_n] in U -> [u_{n+K-1}, u_{n+K}] in out's interior;
    returns out. U and out are f32 or bf16; `w` (f32, padded shape) selects
    the heterogeneous-medium mode, and m_val is then ignored. CPU tensors
    take the plain version; CUDA tensors launch the kernel, and a failed
    launch raises. `tile` = (XC, TY, TZ, YT) overrides the block shape of
    TILES, for tuning."""
    _check(U, out, grid, m_val, k_fuse, w)
    R = grid.radius
    key = mode_key(grid, k_fuse, U, w)
    tile = tile_for(*key) if tile is None else tuple(tile)
    need = smem_bytes(R, k_fuse, tile)
    if need > SMEM_LIMIT:
        raise ValueError(f"tile {tile} at R={R}, K={k_fuse} needs {need} B of shared memory")
    if U.device.type == "cpu":
        res = sweep_fused_ref(U, grid=grid, dt=dt, m_val=m_val, k_fuse=k_fuse, w=w)
        interior = (slice(None),) + grid.interior_slices()
        out[interior] = res[interior]
        return out
    if U.device.type != "cuda":
        raise ValueError(f"no kernel for device {U.device}")
    coeffs = _build.coeff_array(coeff_values(grid, dt, None if w is not None else m_val))
    lib = _build.library()
    with torch.cuda.device(U.device):
        code = lib.tpufdtd_sweep(
            U.data_ptr(), out.data_ptr(), None if w is None else w.data_ptr(),
            grid.nx, grid.ny, grid.nz, grid.halo, R, k_fuse, int(_isotropic(grid)),
            int(U.dtype == torch.bfloat16), *tile, coeffs,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "sweep_fused")
    counts["kernel"][key] += 1
    return out

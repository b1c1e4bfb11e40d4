"""Kernel B: K fused leapfrog steps per pass over device memory.

Replaces the kernels of the fast two-level ring: tpufdtd/ops/stencil_sweep.py
:sweep_fused (radius 1-3, its w and bf16 modes included), and
tpufdtd/ops/stencil_pallas_z.py:packed_step (K = 1) and packed_fused2
(radius 4, K = 2). The CUDA source is csrc/stencil_sweep.cuh (its C entry
in stencil_sweep.cu, one translation unit per mode and radius range in
stencil_sweep_<storage>_<medium>_r<radii>.cu): a 2.5-D x-sweep with
temporal blocking, each thread holding its cells' x-neighbours in register
rings, the input planes staged through 16-byte cp.async several planes
ahead, radius 1-4 (orders 2-8) at the depths of TILES (R * K <= 8). The
deep form (csrc/stencil_sweep_deep.cuh, one translation unit per mode in
stencil_sweep_deep_<storage>_<medium>.cu) takes the TPU sweep's deeper
depths, those of DEEP_TILES (K = 5-6 at R = 1-2, K = 3-4 at R = 3), with
every intermediate level in shared-memory rings instead of registers; the C
entry picks the form by (R, K). Together they run K = 1..k_max(R). Both are
bound by device memory: K fused steps move 16 B per point in f32 plus each
block's halo.

Modes, at radius 1-3 as in the TPU sweep (radius 4 takes f32 and a scalar
m only):
  * medium: a scalar m, or `w`, an f32 tensor of the padded shape holding
    the per-point update scale of a heterogeneous medium (`w_stream`); each
    stage reads it from device memory, 4 B per point per call more;
  * storage: U and out f32, or both bf16 (half the bytes); compute is f32
    throughout, and only the two output levels are rounded to bf16, once
    per K-block, so a bf16 K-block is not K bf16 steps.
`smem_bytes` and `deep_smem_bytes` depend on the storage dtype (the staging
rings hold it); `cells_per_thread` and `k_max` hold for every mode.

U = [u_{n-1}, u_n] in the reference layout, shape [2, nx+2H, ny+2H, nz+2H];
the result [u_{n+K-1}, u_{n+K}] goes to a second buffer `out` (not in
place: CUDA blocks run in parallel, and one block's halo is another's
output). Both buffers must carry the same frozen rims, which the kernel
never writes. For every K, level 0 of the result is u_{n+K-1} and level 1
is u_{n+K}; there is no role flip at K = 1. U and out may also be x-slabs
`A[:, a:b]` of larger two-level arrays, whose levels lie the larger array's
planes apart: the C entry takes that level stride (the sharded sweep's
overlap runs its three slabs so).

Frozen margins (`frozen_lo`, `frozen_hi`, `frozen_ylo`, `frozen_yhi`,
default 0), the TPU sweep's: interior planes [0, frozen_lo) and
[nx - frozen_hi, nx), and rows [0, frozen_ylo) and [ny - frozen_yhi, ny) of
every plane, are never leap-updated; every stage carries u_n through, and
both output levels get u_n there. The sharded sweep
(parallel/sharded_sweep.py) freezes an edge shard's margin, which overlays
the global rim. They are run-time arguments of the C entry, which runs the
same kernels on the view of the arrays without the margins (the margins are
its rim) and copies u_n into the margins of both output levels.

`sweep_fused` launches the kernel for CUDA tensors and runs the plain
version `sweep_fused_ref` for CPU tensors; `counts` records which ran, per
(radius, K, storage dtype, "m" or "w"), and `frozen_counts` the kernel's
launches with a margin.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..config import Grid3D, stencil_weights
from ..layout import Layout
from . import _build, stencil_torch
from .stencil_step import SMEM_LIMIT, STORAGE, coeff_values

RADII = (1, 2, 3, 4)
# radii of the w stream and of bf16 storage (the TPU sweep's, orders 2-6)
MODE_RADII = (1, 2, 3)
# Block shape per (radius R, fusion depth K): (XC, TY, TZ) = the x-planes
# one block sweeps and its (y, z) column (z is the contiguous axis); each of
# its THREADS threads owns up to cells_per_thread(R, K) cells of the
# column's (TY + 2KR) x (TZ + 2KR) region.
TILES = {
    (1, 1): (256, 8, 128), (1, 2): (512, 8, 64),
    (1, 3): (512, 32, 64), (1, 4): (256, 24, 64),
    (2, 1): (256, 8, 128), (2, 2): (256, 16, 32),
    (2, 3): (512, 32, 32), (2, 4): (512, 16, 32),
    (3, 1): (256, 8, 64), (3, 2): (256, 8, 24),
    (4, 1): (512, 16, 32), (4, 2): (256, 16, 40),
}
# Block shapes of the other modes where the probe found a shape at least
# 3 % faster than TILES' at 512^3 on an H100, or where TILES' needs more
# shared memory than the mode has (the w stream's ring) (harness/
# tile_probe.py; PERF.md), per (storage dtype, medium): {(R, K): (XC, TY,
# TZ)}.
MODE_TILES = {
    ("float32", "w"): {(1, 2): (256, 8, 64), (1, 3): (256, 16, 32), (1, 4): (256, 24, 16)},
    ("bfloat16", "m"): {(1, 1): (512, 32, 32), (1, 2): (256, 24, 32), (3, 1): (256, 24, 32)},
    ("bfloat16", "w"): {(1, 2): (256, 24, 32), (1, 3): (512, 16, 32), (1, 4): (256, 24, 16),
                        (3, 1): (256, 16, 48)},
}
# csrc/stencil_sweep.cuh: planes of u_n's staging ring (STAGES - 1 in
# flight), the threads of a block, and the registers per thread besides the
# cells' rings.
STAGES = 4
THREADS = 256
REG_OVERHEAD = 64
# The deep form's tiles: every (TY, TZ) built per (R, K), the depths of the
# TPU sweep (K <= 6 at R <= 2, K <= 4 at R = 3) beyond TILES
# (csrc/stencil_sweep_deep.cuh:TPUFDTD_DEEP_SHAPES lists the same; the tile
# is a template parameter there, and the kernel refuses any other), and the
# block shape (XC, TY, TZ) each (R, K) takes in every mode, the fastest
# built one in the f32 scalar-m mode at 512^3 on an H100 (harness/
# tile_probe.py; PERF.md), one block an SM.
DEEP_SHAPES = {
    (1, 5): ((40, 64), (48, 48)), (1, 6): ((32, 64), (40, 48)),
    (2, 5): ((32, 32), (24, 40)), (2, 6): ((16, 40), (16, 32)),
    (3, 3): ((16, 64), (32, 40)), (3, 4): ((16, 40), (16, 32)),
}
DEEP_TILES = {
    (1, 5): (512, 40, 64), (1, 6): (512, 32, 64),
    (2, 5): (512, 32, 32), (2, 6): (512, 16, 40),
    (3, 3): (512, 16, 64), (3, 4): (512, 16, 40),
}
# threads of a deep block (csrc/stencil_sweep_deep.cuh:threads; 384 at R = 1
# and for the exact form with a scalar m at R = 2)
DEEP_THREADS = 512

# launches per mode_key: counts["kernel"] of the CUDA kernel, counts["plain"]
# of the plain version; frozen_counts the kernel's launches with a frozen
# margin (also in counts["kernel"])
counts = {"kernel": Counter(), "plain": Counter()}
frozen_counts = Counter()


def reset_counts() -> None:
    for c in counts.values():
        c.clear()
    frozen_counts.clear()


def launches(route: str = "kernel") -> int:
    """Launches of `route` since the last reset, over every mode; route
    "frozen": the kernel's launches with a frozen margin."""
    return sum((frozen_counts if route == "frozen" else counts[route]).values())


def min_blocks(radius: int, k: int) -> int:
    """Blocks per SM the kernel's registers allow at (R, K): 2 (128
    registers a thread) at K <= 2 where a cell's rings are short, else 1
    (up to 255) (csrc/stencil_sweep.cuh:min_blocks)."""
    return 2 if k <= 2 and k * (2 * radius + 1) <= 14 else 1


def cells_per_thread(radius: int, k: int) -> int:
    """The most cells of its region one thread owns: each keeps K rings of
    2R+1 planes in registers (u_n .. u_{n+K-1}), three offsets and K
    temporaries (csrc/stencil_sweep.cuh:cells)."""
    regs = 128 if min_blocks(radius, k) == 2 else 240
    return (regs - REG_OVERHEAD) // (k * (2 * radius + 1) + 3 + k)


def smem_bytes(radius: int, k: int, tile=None, storage: str = "float32",
               medium: str = "m") -> int:
    """Dynamic shared memory of one block (csrc/stencil_sweep.cuh:smem, the
    bytes the launch requests): staging rings of STAGES planes of u_n and
    STAGES + R of u_{n-1} in the storage dtype, each row padded to a
    16-byte multiple plus 16 bytes for its aligned superset, and two
    buffers of one f32 centre plane per level u_n .. u_{n+K-1}; with the w
    stream, a ring of STAGES + K*R f32 planes of w at the same row pitch.
    Every plane is the column plus a K*R halo."""
    _xc, ty, tz = TILES[radius, k] if tile is None else tile
    esz = 2 if storage == "bfloat16" else 4
    g2 = 2 * k * radius
    py, pz, v = ty + g2, tz + g2, 16 // esz
    sp = -(-pz // v) * v + v
    w_ring = (STAGES + k * radius) * py * sp * 4 if medium == "w" else 0
    return (2 * STAGES + radius) * py * sp * esz + w_ring + 2 * k * py * pz * 4


def deep_smem_bytes(radius: int, k: int, tile=None, storage: str = "float32",
                    medium: str = "m") -> int:
    """Dynamic shared memory of one block of the deep form
    (csrc/stencil_sweep_deep.cuh:Shape::smem, the bytes the launch
    requests): one staged plane of u_n over level 0's region (TY + 2KR) x
    (TZ + 2KR) and one of u_{n-1} over the same rows, in the storage dtype,
    rows padded as in smem_bytes, each after 32 bytes of guard; then a ring
    of 2R+1 f32 planes of each level u_{n+j}, j = 0..K-1, over its region
    (TY + 2(K-j)R) x (TZ + 2(K-j)R), its rows two cells wider where jR is
    odd. The w stream is read from device memory, so `medium` changes
    nothing."""
    del medium
    _xc, ty, tz = DEEP_TILES[radius, k] if tile is None else tile
    esz = 2 if storage == "bfloat16" else 4
    v = 16 // esz
    sp = -(-(tz + 2 * k * radius) // v) * v + v
    levels = sum((ty + 2 * (k - j) * radius) * (tz + 2 * (k - j) * radius + 2 * (j * radius % 2))
                 for j in range(k))
    return 2 * (32 + (ty + 2 * k * radius) * sp * esz) + (2 * radius + 1) * levels * 4


def deep_built(radius: int, k: int, tile) -> bool:
    """The deep form is instantiated at this tile's (TY, TZ) (DEEP_SHAPES)."""
    return tuple(tile[1:]) in DEEP_SHAPES.get((radius, k), ())


def tile_fits(radius: int, k: int, tile, storage: str = "float32", medium: str = "m") -> bool:
    """The block's planes fit shared memory, and on the register form its
    region its threads' cells."""
    if (radius, k) in DEEP_TILES:
        return (deep_built(radius, k, tile)
                and deep_smem_bytes(radius, k, tile, storage, medium) <= SMEM_LIMIT)
    _xc, ty, tz = tile
    g2 = 2 * k * radius
    return ((ty + g2) * (tz + g2) <= cells_per_thread(radius, k) * THREADS
            and smem_bytes(radius, k, tile, storage, medium) <= SMEM_LIMIT)


def k_max(radius: int) -> int:
    """Deepest fusion built at this radius, the TPU sweep's (tpufdtd/ops/
    stencil_sweep.py:max_k_fuse): 6 at R <= 2 and 4 at R = 3 (the deep
    form), 2 at R = 4 (packed_fused2's)."""
    return max(k for (r, k), t in {**TILES, **DEEP_TILES}.items()
               if r == radius and tile_fits(r, k, t))


def tile_for(radius: int, k: int, storage: str = "float32", medium: str = "m") -> tuple:
    """The block shape kernel B takes in a mode."""
    if (radius, k) in DEEP_TILES:
        return DEEP_TILES[radius, k]
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


def frozen_slices(grid: Grid3D, frozen=(0, 0, 0, 0)) -> list:
    """Index tuples of the frozen margins (frozen_lo, frozen_hi, frozen_ylo,
    frozen_yhi) in the padded layout: the interior planes at each x end and
    the interior rows at each y end."""
    flo, fhi, fylo, fyhi = frozen
    h = grid.halo
    xi, yi, zi = grid.interior_slices()
    out = []
    for lo, hi in ((h, h + flo), (h + grid.nx - fhi, h + grid.nx)):
        if hi > lo:
            out.append((slice(lo, hi), yi, zi))
    for lo, hi in ((h, h + fylo), (h + grid.ny - fyhi, h + grid.ny)):
        if hi > lo:
            out.append((xi, slice(lo, hi), zi))
    return out


def sweep_fused_ref(U, *, grid: Grid3D, dt: float, m_val, k_fuse: int, w=None,
                    frozen_lo: int = 0, frozen_hi: int = 0, frozen_ylo: int = 0,
                    frozen_yhi: int = 0):
    """Plain PyTorch version of the kernel: U widened to f32, k_fuse eager
    f32 steps, each writing only the interior (the rims stay frozen) and
    putting the frozen margins' u_n back, the two outputs rounded to U's
    dtype once at the end. A scalar m takes the oracle's form
    (stencil_torch), w the TPU sweep's w form. Returns a new
    [u_{n+K-1}, u_{n+K}] tensor."""
    counts["plain"][mode_key(grid, k_fuse, U, w)] += 1
    margins = frozen_slices(grid, (frozen_lo, frozen_hi, frozen_ylo, frozen_yhi))
    prev = U[0].to(torch.float32, copy=True)
    cur = U[1].to(torch.float32, copy=True)
    for _ in range(k_fuse):
        if w is None:
            stencil_torch.leapfrog_step(cur, prev, m_val, prev, grid=grid, dt=dt)
        else:
            _leap_w(cur, prev, w, prev, grid=grid)
        for sl in margins:
            prev[sl] = cur[sl]
        prev, cur = cur, prev
    return torch.stack([prev, cur]).to(U.dtype)


def _is_slab(t) -> bool:
    """t[2, a, nyp, nzp] is x-planes of a contiguous [2, A, nyp, nzp] with
    A >= a: each level contiguous, the levels A planes apart."""
    plane = t.shape[2] * t.shape[3]
    return (t.stride()[1:] == (plane, t.shape[3], 1) and t.stride(0) % plane == 0
            and t.stride(0) >= t.shape[1] * plane)


def _check(U, out, grid: Grid3D, m_val, k_fuse: int, w, frozen):
    shape = (2,) + tuple(grid.padded_shape)
    for name, t in (("U", U), ("out", out)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor; got {type(t).__name__}")
        if t.dtype not in STORAGE or t.dtype != U.dtype:
            raise ValueError(f"U and out must both be float32 or both bfloat16; got {U.dtype},"
                             f" {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}; got {tuple(t.shape)}")
        if not t.is_contiguous() and not _is_slab(t):
            raise ValueError(f"{name} must be contiguous, or an x-slab of a contiguous"
                             " two-level array")
    if out.device != U.device:
        raise ValueError(f"out is on {out.device}, U on {U.device}")
    if out.stride(0) != U.stride(0):
        raise ValueError(f"U and out must have one level stride; got {U.stride(0)},"
                         f" {out.stride(0)}")
    if out.untyped_storage().data_ptr() == U.untyped_storage().data_ptr():
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
    flo, fhi, fylo, fyhi = frozen
    if min(frozen) < 0 or flo + fhi > grid.nx or fylo + fyhi > grid.ny:
        raise ValueError(f"frozen margins out of range: x {flo}+{fhi} of {grid.nx} planes,"
                         f" y {fylo}+{fyhi} of {grid.ny} rows")


@torch.no_grad()
def sweep_fused(U, out, *, grid: Grid3D, dt: float, m_val, k_fuse: int, w=None, tile=None,
                frozen_lo: int = 0, frozen_hi: int = 0, frozen_ylo: int = 0,
                frozen_yhi: int = 0):
    """[u_{n-1}, u_n] in U -> [u_{n+K-1}, u_{n+K}] in out's interior;
    returns out. U and out are f32 or bf16, whole two-level arrays or
    x-slabs of them (`A[:, a:b]`, the levels of one stride); `w` (f32,
    padded shape, contiguous) selects
    the heterogeneous-medium mode, and m_val is then ignored. The frozen
    margins (module docstring) get u_n in both levels. CPU tensors take the
    plain version; CUDA tensors launch the kernel, and a failed launch
    raises. `tile` = (XC, TY, TZ) overrides the block shape of TILES (of
    DEEP_TILES at their depths, where (TY, TZ) must be one of DEEP_SHAPES
    on every device), for tuning."""
    frozen = (frozen_lo, frozen_hi, frozen_ylo, frozen_yhi)
    _check(U, out, grid, m_val, k_fuse, w, frozen)
    R = grid.radius
    key = mode_key(grid, k_fuse, U, w)
    if tile is None:
        # x-chunks of equal length: a short last chunk pays a whole block's
        # 2KR planes of pipeline fill for a few output planes
        xc, ty, tz = tile_for(*key)
        nx = grid.nx - frozen_lo - frozen_hi
        tile = (-(-nx // -(-nx // xc)) if nx > 0 else xc, ty, tz)
    else:
        tile = tuple(tile)
    deep = (R, k_fuse) in DEEP_TILES
    if deep and not deep_built(R, k_fuse, tile):
        raise ValueError(f"tile {tile} at R={R}, K={k_fuse}: the deep form is built for (TY, TZ)"
                         f" in {DEEP_SHAPES[R, k_fuse]} only")
    need = (deep_smem_bytes if deep else smem_bytes)(R, k_fuse, tile, key[2], key[3])
    if need > SMEM_LIMIT:
        raise ValueError(f"tile {tile} at R={R}, K={k_fuse} needs {need} B of shared memory")
    _xc, ty, tz = tile
    if not deep:
        cells = cells_per_thread(R, k_fuse)
        if (ty + 2 * k_fuse * R) * (tz + 2 * k_fuse * R) > cells * THREADS:
            raise ValueError(f"tile {tile} at R={R}, K={k_fuse}: the region exceeds {cells}"
                             " cells per thread")
    if U.device.type == "cpu":
        res = sweep_fused_ref(U, grid=grid, dt=dt, m_val=m_val, k_fuse=k_fuse, w=w,
                              frozen_lo=frozen_lo, frozen_hi=frozen_hi,
                              frozen_ylo=frozen_ylo, frozen_yhi=frozen_yhi)
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
            int(U.dtype == torch.bfloat16), *tile, *frozen,
            U.stride(0) // (U.shape[2] * U.shape[3]), coeffs,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "sweep_fused")
    counts["kernel"][key] += 1
    if any(frozen):
        frozen_counts[key] += 1
    return out

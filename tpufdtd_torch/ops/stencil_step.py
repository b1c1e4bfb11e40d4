"""Kernel A: one leapfrog step from (cur, prev) into a separate target.

Replaces the kernels of the exact three-level ring:
tpufdtd/ops/stencil_pallas_z.py:leapfrog_step_zsplit (radius <= 4) and
tpufdtd/ops/stencil_pallas.py:leapfrog_step_pallas (any order 2-12; the
ring at orders 10-12). The CUDA source is csrc/stencil_step.cuh (its C
entries in stencil_step.cu, one translation unit per storage type and
radius range in stencil_step_<f32|bf16>_r<13|46>.cu): kernel B's x-sweep at
one step, each thread holding its cells' x-neighbours in register rings and
reading the y/z neighbours, prev and m, staged in shared memory through
16-byte cp.async several planes ahead, by pairs of z neighbours; radius
1-6, scalar or per-point m. It is bound by device memory at 12 B per point
in f32 and 6 B in bf16, plus 4 B for a per-point m. It writes only the
target's interior, so each ring level keeps its own rim, as
leapfrog_step_pallas stores the target's rim back.

Storage: cur, prev and target are all f32 or all bf16, as the TPU kernels
store in the dtype of their inputs; bf16 is widened on load, computed in
f32 and rounded once on the store. m stays f32.

Block shapes: a block of THREADS threads sweeps a (TY, TZ) column of (y, z),
TZ even, over XC x-planes; `tile_for` gives the shape per (radius, storage,
m's kind) (TILES, and MODE_TILES where another mode's probe found a faster
one or TILES' does not fit; harness/tile_probe.py). A column up to
cells_per_thread(R, 2) x THREADS cells runs two blocks per SM, a larger one
one block (`blocks_per_sm`). `launch_tile` cuts x into equal chunks of at
most XC planes, as many as take the fewest waves of blocks times planes.

`leapfrog_step` launches the kernel for CUDA tensors and runs the plain
version `leapfrog_step_ref` for CPU tensors; `counts` records which ran,
per (radius, storage dtype, "scalar" or "per-point" m).
"""

from __future__ import annotations

import functools
from collections import Counter

import numpy as np
import torch

from ..config import Grid3D
from . import _build, stencil_torch

RADII = (1, 2, 3, 4, 5, 6)
# Block shape per radius, f32 with a scalar m: (XC, TY, TZ) = the most
# x-planes one block sweeps and its (y, z) column (z is the contiguous axis)
# (harness/tile_probe.py at its places on an H100, PERF.md: R = 2 the 128^3
# gate, R = 4 the sharded per-step path's 128 x 512 x 512 shard and the
# order-8 layered path, R = 6 the order-12 paths; R = 1, 3 and 5 unprobed)
TILES = {1: (256, 40, 64), 2: (256, 24, 64), 3: (256, 24, 64), 4: (256, 16, 64),
         5: (256, 32, 64), 6: (256, 40, 64)}
# Block shapes of the other modes where the probe found a shape at least
# 3 % faster than TILES', or where TILES' needs more shared memory than the
# mode has (a per-point m's ring), per (storage dtype, m's kind): {radius:
# (XC, TY, TZ)}
MODE_TILES = {("float32", "per-point"): {6: (256, 32, 64)}}
# Dynamic shared memory one block may use on sm_90 (227 KB).
SMEM_LIMIT = 232448
# csrc/stencil_step.cuh: planes of cur in flight + 1, the threads of a
# block, and the registers per thread besides the cells'
STAGES = 4
THREADS = 256
REG_OVERHEAD = 72

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


def cells_per_thread(radius: int, blocks: int) -> int:
    """The most cells of its column one thread owns at `blocks` blocks per
    SM (128 registers a thread at 2, up to 255 at 1), in pairs of z
    neighbours: a pair keeps two rings of 2R+1 planes of cur in registers
    and two offsets, with room for four loads in flight
    (csrc/stencil_step.cuh:pairs)."""
    return 2 * (((128 if blocks == 2 else 240) - REG_OVERHEAD) // (4 * radius + 6))


def blocks_per_sm(radius: int, tile) -> int:
    """Blocks per SM of the instantiation a tile's column takes: 2 where it
    fits cells_per_thread(R, 2) per thread, else 1
    (csrc/stencil_step.cuh:blocks_for)."""
    _xc, ty, tz = tile
    return 2 if ty * tz <= cells_per_thread(radius, 2) * THREADS else 1


def smem_bytes(radius: int, tile, storage: str = "float32", mkind: str = "scalar") -> int:
    """Dynamic shared memory of one block (csrc/stencil_step.cuh:smem, the
    bytes the launch requests): rings of STAGES + R planes of cur over the
    column and its R-cell halo and of STAGES planes of prev over the column,
    in the storage dtype, and with a per-point m of STAGES f32 planes of m
    over the column; each row padded to a 16-byte multiple plus 16 bytes
    for its aligned superset."""
    _xc, ty, tz = tile
    esz = 2 if storage == "bfloat16" else 4
    v = 16 // esz
    sp = -(-(tz + 2 * radius) // v) * v + v
    planes = ((STAGES + radius) * (ty + 2 * radius) + STAGES * ty) * sp * esz
    return planes + (STAGES * ty * sp * 4 if mkind == "per-point" else 0)


def tile_fits(radius: int, tile, storage: str = "float32", mkind: str = "scalar") -> bool:
    """The tile's column, of an even TZ (pairs of z neighbours), fits its
    threads' cells, and its planes shared memory."""
    _xc, ty, tz = tile
    return (min(tile) >= 1 and tz % 2 == 0 and ty * tz <= cells_per_thread(radius, 1) * THREADS
            and smem_bytes(radius, tile, storage, mkind) <= SMEM_LIMIT)


def tile_for(radius: int, storage: str = "float32", mkind: str = "scalar") -> tuple:
    """The block shape kernel A takes in a mode."""
    return MODE_TILES.get((storage, mkind), {}).get(radius, TILES[radius])


def launch_tile(grid: Grid3D, tile, sms: int) -> tuple:
    """The (XC, TY, TZ) of a launch: x cut into equal chunks of at most the
    tile's XC planes, as many as minimise waves x planes per block on `sms`
    SMs. The columns times the chunks run in waves of the SMs' block slots,
    and a block of a chunk of c planes sweeps c + 2R: fewer blocks than
    slots leave SMs idle, a last wave of few blocks leaves most idle for a
    whole block's time, and every chunk pays its 2R planes of pipeline
    fill; the fewest chunks win a tie."""
    xc, ty, tz = tile
    nx, cols = grid.nx, -(-grid.ny // ty) * -(-grid.nz // tz)
    slots = sms * blocks_per_sm(grid.radius, tile)

    def cost(n):
        return -(-cols * n // slots) * (-(-nx // n) + 2 * grid.radius)

    chunks = min(range(min(-(-nx // xc), nx), nx + 1), key=cost)
    return (-(-nx // chunks), ty, tz)


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



def _tile(key, tile) -> tuple:
    """The block shape of a call in mode `key`, checked."""
    R, storage, mkind = key
    tile = tile_for(R, storage, mkind) if tile is None else tuple(tile)
    if not tile_fits(R, tile, storage, mkind):
        raise ValueError(f"tile {tile} at R={R}: a column beyond {cells_per_thread(R, 1)}"
                         f" cells per thread, or {smem_bytes(R, tile, storage, mkind)} B of"
                         f" shared memory (at most {SMEM_LIMIT})")
    return tile


@functools.lru_cache(maxsize=64)
def _plan(grid: Grid3D, dt: float, m_val, key, tile, device: int) -> tuple:
    """The C entry's coefficients and launch shape of a call, computed once
    per grid, dt, scalar m, mode, tile and card: the step's host work is
    then a few checks and one ctypes call."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return (_build.coeff_array(coeff_values(grid, dt, m_val)),
            launch_tile(grid, _tile(key, tile), sms))


@torch.no_grad()
def leapfrog_step(cur, prev, m, target, *, grid: Grid3D, dt: float, tile=None):
    """u_next into target's interior (in place); returns target.

    cur, prev and target are f32 or bf16, all alike; m is a full padded f32
    tensor or a scalar. CPU tensors take the plain version; CUDA tensors
    launch the kernel, and a failed launch raises. `tile` = (XC, TY, TZ)
    overrides the block shape of tile_for, for tuning.
    """
    _check(cur, prev, m, target, grid)
    key = mode_key(grid, target, m)
    tile = None if tile is None else tuple(tile)
    if cur.device.type == "cpu":
        _tile(key, tile)
        return leapfrog_step_ref(cur, prev, m, target, grid=grid, dt=dt)
    if cur.device.type != "cuda":
        raise ValueError(f"no kernel for device {cur.device}")
    m_val = None if torch.is_tensor(m) else float(m)
    coeffs, launch = _plan(grid, float(dt), m_val, key, tile, cur.device.index)
    lib = _build.library()
    with torch.cuda.device(cur.device):
        code = lib.tpufdtd_leapfrog_step(
            cur.data_ptr(), prev.data_ptr(),
            m.data_ptr() if m_val is None else None,
            target.data_ptr(), grid.nx, grid.ny, grid.nz, grid.halo,
            grid.radius, int(cur.dtype == torch.bfloat16), *launch, coeffs,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "leapfrog_step")
    counts["kernel"][key] += 1
    return target

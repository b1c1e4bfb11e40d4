"""The reference's one-call kernel ABI on the port.

The reference exposes one function signature per backend (main.cpp:53-72):
a complete simulation run over a 3-level ring array with inclusive
interior bounds, geometry scalars, source and time ranges and a
two-section profiler out-param. `kernel_cuda` keeps that call contract
(NumPy arrays in place of the reference's buffers) on the port's exact
ring, kernel A on the card; it is the counterpart of the JAX package's
`kernel_tpu`. `deviceid` and `devicerm` are accepted for signature parity:
`device` places the run.

Ring semantics are the reference's: on entry u[time_m % 3] is the current
level, u[(time_m + 2) % 3] the previous and u[(time_m + 1) % 3] the first
write target (cuda.cu:233-235); on exit the three levels sit in the slots
the reference leaves them in, per-level frozen rims included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .config import Grid3D, SimConfig
from .stepper import Simulator


@dataclasses.dataclass
class Profiler:
    """Two-section timer (main.cpp:47-50): section0 the stencil, section1
    the source injection, split by the optimized reference kernel's
    work-share estimate (cuda_optimized.cu:466-470)."""

    section0: float = 0.0
    section1: float = 0.0


def kernel_cuda(
    m: np.ndarray,
    src: Optional[np.ndarray],
    src_coords: Optional[np.ndarray],
    u: np.ndarray,
    x_M: int,
    x_m: int,
    y_M: int,
    y_m: int,
    z_M: int,
    z_m: int,
    dt: float,
    h_x: float,
    h_y: float,
    h_z: float,
    o_x: float,
    o_y: float,
    o_z: float,
    p_src_M: int,
    p_src_m: int,
    time_M: int,
    time_m: int,
    deviceid: int = 0,
    devicerm: int = 1,
    timers: Optional[Profiler] = None,
    backend: str = "cuda",
    *,
    device="cuda",
) -> int:
    """Run the simulation over u[3, nxp, nyp, nzp] in place; returns 0.

    Bounds are inclusive interior index ranges as in the reference
    (x_m..x_M, starting at 0); p_src_M == -1 means no sources; the time
    range time_m..time_M is inclusive and every step is a physics step
    (the first cfg.warmup_steps = 5 are the untimed warmup, cuda.cu:232).
    """
    del deviceid, devicerm  # signature parity; `device` places the run
    if x_m or y_m or z_m:
        raise ValueError(f"the interior must start at 0; got x_m={x_m}, y_m={y_m}, z_m={z_m}")
    grid = Grid3D(x_M + 1, y_M + 1, z_M + 1, h_x, h_y, h_z, o_x, o_y, o_z)
    if u.shape != (3,) + grid.padded_shape:
        raise ValueError(f"u must have shape {(3,) + grid.padded_shape}; got {u.shape}")

    nsteps = time_M - time_m + 1
    if nsteps <= 0:
        return 0
    nsrc = p_src_M - p_src_m + 1
    have_src = src is not None and src_coords is not None and nsrc > 0
    coords = np.asarray(src_coords, np.float32)[p_src_m: p_src_M + 1] if have_src else None
    src_rows = (np.asarray(src, np.float32)[time_m: time_M + 1, p_src_m: p_src_M + 1]
                if have_src else None)

    cfg = SimConfig(dt=dt, nsteps=nsteps, backend=backend, ring="exact")
    sim = Simulator(grid, cfg, m, coords, device=device)
    # entry ring mapping (cuda.cu:233-235)
    state = sim.prepare_state(u[(time_m + 2) % 3], u[time_m % 3], u[(time_m + 1) % 3])
    state, secs = sim.run_timed(state, src_rows)
    prev, cur, target = sim.extract_state(state)  # (u_{N-1}, u_N, u_{N-2})
    # exit ring mapping: the newest level lands at (time_M + 1) % 3
    u[(time_M + 1) % 3] = cur
    u[time_M % 3] = prev
    u[(time_M + 2) % 3] = target

    if timers is not None:
        s1_share = 8.0 * max(0, nsrc) / (grid.interior_cells + 8.0 * max(0, nsrc))
        timers.section0 += secs * (1.0 - s1_share)
        timers.section1 += secs * s1_share
    return 0

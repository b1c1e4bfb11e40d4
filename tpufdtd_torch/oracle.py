"""Correctness oracles.

`oracle_step`, `oracle_run` and `oracle_run_ring` are the NumPy reference
stepper (the role openacc.cpp:61-216 plays for the reference), copied from
the JAX package so that both packages hold their results against the same
code. All arithmetic follows the reference's expression shapes:

  r1 = 1/dt^2, r2..r4 = 1/h^2 per axis                  (openacc.cpp:84-88)
  r5 = w0 * u0[c] shared across the three axis terms    (openacc.cpp:101)
  u2 = dt^2 * ( r2*Tx + r3*Ty + r4*Tz
                - (-2*r1*u0[c] + r1*u1[c]) * m ) / m    (openacc.cpp:102-107)

`truth_run_ring` is the same scheme in torch float64 on any device: the
ground truth of the correctness gate at sizes the NumPy oracle is too slow
for.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Grid3D, stencil_weights
from .sources import DeviceSourceTerm, SourceTerm, build_source_term


def _axis_term(u0: np.ndarray, grid: Grid3D, axis: int, r5: np.ndarray, W) -> np.ndarray:
    """r5 + sum_{d=R..1} w_d * (u0 shifted -d + u0 shifted +d) on the interior."""
    h = grid.halo
    n = (grid.nx, grid.ny, grid.nz)

    def sl(shift_axis: int, d: int) -> tuple:
        return tuple(
            slice(h + (d if ax == shift_axis else 0), h + (d if ax == shift_axis else 0) + n[ax])
            for ax in range(3)
        )

    acc = r5
    for d in range(grid.radius, 0, -1):
        acc = acc + W[d] * (u0[sl(axis, -d)] + u0[sl(axis, d)])
    return acc


def oracle_step(
    u_cur: np.ndarray,
    u_prev: np.ndarray,
    m: np.ndarray,
    grid: Grid3D,
    dt: float,
    dtype=np.float32,
    target: np.ndarray | None = None,
) -> np.ndarray:
    """One leapfrog step; returns the full padded u_next. Only the interior
    is written, so `target`'s own rim survives (default target: u_cur).
    dtype=np.float64 gives the ground-truth stepper."""
    u0 = np.asarray(u_cur, dtype=dtype)
    u1 = np.asarray(u_prev, dtype=dtype)
    m = np.asarray(m, dtype=dtype)
    dt = dtype(dt)

    hx, hy, hz = dtype(grid.hx), dtype(grid.hy), dtype(grid.hz)
    r1 = dtype(1.0) / (dt * dt)
    r2 = dtype(1.0) / (hx * hx)
    r3 = dtype(1.0) / (hy * hy)
    r4 = dtype(1.0) / (hz * hz)
    W = tuple(dtype(w) for w in stencil_weights(grid.order))

    interior = grid.interior_slices()
    u0c = u0[interior]
    u1c = u1[interior]
    mc = m[interior]

    r5 = W[0] * u0c
    tx = _axis_term(u0, grid, 0, r5, W)
    ty = _axis_term(u0, grid, 1, r5, W)
    tz = _axis_term(u0, grid, 2, r5, W)

    upd = (
        dt
        * dt
        * (r2 * tx + r3 * ty + r4 * tz - (dtype(-2.0) * r1 * u0c + r1 * u1c) * mc)
        / mc
    )
    base = u0 if target is None else np.asarray(target, dtype=dtype)
    u_next = base.copy()
    u_next[interior] = upd
    return u_next


def oracle_inject(u: np.ndarray, term: SourceTerm, src_t: np.ndarray) -> None:
    """In-place scatter-add of one step's source amplitudes (numpy add.at)."""
    if term.empty:
        return
    vals = (np.asarray(src_t, dtype=np.float32)[term.src_idx] * term.scale).astype(
        np.float32
    )
    np.add.at(u, (term.ix, term.iy, term.iz), vals)


def oracle_run(u_prev, u_cur, m, grid: Grid3D, dt: float, nsteps: int, src=None,
               src_coords=None, dtype=np.float32, u_target=None):
    """Run nsteps leapfrog steps; returns (u_{N-1}, u_N)."""
    P, C, _T = oracle_run_ring(
        u_prev, u_cur, m, grid, dt, nsteps, src, src_coords, dtype, u_target
    )
    return P, C


def oracle_run_ring(u_prev, u_cur, m, grid: Grid3D, dt: float, nsteps: int, src=None,
                    src_coords=None, dtype=np.float32, u_target=None):
    """Exact 3-level ring semantics; returns (u_{N-1}, u_N, u_{N-2}).

    u_target is the initial content of the first write buffer; it defaults
    to a copy of u_cur, which reproduces both reference setups."""
    term = build_source_term(grid, src_coords, m)
    P = np.array(u_prev, dtype=dtype)
    C = np.array(u_cur, dtype=dtype)
    T = np.array(u_cur if u_target is None else u_target, dtype=dtype)
    for t in range(nsteps):
        un = oracle_step(C, P, m, grid, dt, dtype=dtype, target=T)
        if src is not None and not term.empty:
            oracle_inject(un, term, src[t])
        P, C, T = C, un, P
    return P, C, T


@torch.no_grad()
def truth_run_ring(u_prev, u_cur, m, grid: Grid3D, dt: float, nsteps: int, src=None,
                   src_coords=None, u_target=None, *, device):
    """f64 ground truth: oracle_run_ring(dtype=np.float64)'s scheme in torch
    float64 on `device`. Same coefficients, frozen-rim target writes, %3
    ring and scatter-add injection; sums are associated differently inside
    the stencil, so the two agree to f64 roundoff, far below the 1e-4 gate.
    Returns host float64 arrays (u_{N-1}, u_N, u_{N-2})."""
    device = torch.device(device)
    f8 = np.float64
    dt64 = f8(dt)
    r1 = f8(1.0) / (dt64 * dt64)
    rax = tuple(f8(1.0) / (f8(hh) * f8(hh)) for hh in (grid.hx, grid.hy, grid.hz))
    W = tuple(float(f8(w)) for w in stencil_weights(grid.order))
    h = grid.halo
    n = (grid.nx, grid.ny, grid.nz)
    interior = grid.interior_slices()

    def sl(shift_axis: int, d: int) -> tuple:
        return tuple(
            slice(h + (d if ax == shift_axis else 0), h + (d if ax == shift_axis else 0) + n[ax])
            for ax in range(3)
        )

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device).to(torch.float64)

    term = build_source_term(grid, src_coords, m)
    have_src = src is not None and not term.empty
    if have_src:
        dterm = DeviceSourceTerm.of(term, device)
        scale64 = dterm.scale.to(torch.float64)
        table = dev(np.asarray(src[:nsteps], np.float32))
    mc = dev(m)[interior]
    P, C = dev(u_prev), dev(u_cur)
    T = dev(u_cur if u_target is None else u_target)
    for t in range(nsteps):
        u0c = C[interior]
        r5 = W[0] * u0c
        terms = []
        for axis in range(3):
            acc = r5
            for d in range(grid.radius, 0, -1):
                acc = acc + W[d] * (C[sl(axis, -d)] + C[sl(axis, d)])
            terms.append(float(rax[axis]) * acc)
        upd = (
            float(dt64 * dt64)
            * (terms[0] + terms[1] + terms[2] - (float(f8(-2.0) * r1) * u0c + float(r1) * P[interior]) * mc)
            / mc
        )
        T[interior] = upd
        if have_src:
            T.index_put_(dterm.index, table[t][dterm.src_idx] * scale64, accumulate=True)
        P, C, T = C, T, P
    return tuple(x.cpu().numpy() for x in (P, C, T))

"""Trilinear point-source injection (cuda.cu:112-170, openacc.cpp:172-204).

Source coordinates are static for a run, so the corner indices and combined
weights are computed once on the host; each step is then one gather of
src[t] and one `index_put_(..., accumulate=True)` on the device, the
deterministic counterpart of the reference's atomicAdd per corner.

Semantics (cuda.cu:145-165):
  pos   = floor((coord - o)/h)            per axis, f32 math
  p     = frac((coord - o)/h)
  corner (rx,ry,rz) in {0,1}^3 hits padded cell (pos + r + halo)
  valid iff pos+r in [-1, n] per axis     (one cell of slack beyond interior)
  added value = 1e-2 * wx*wy*wz * src[t,p] / m[pos + halo]
A valid corner one cell beyond the interior lands in the rim, where it
persists on the exact ring and rules out the fast ring.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SOURCE_SCALE, Grid3D


@dataclasses.dataclass(frozen=True)
class SourceTerm:
    """Precomputed scatter targets in reference-layout indices: flat arrays
    of length nsrc*8."""

    ix: np.ndarray  # int32, padded x index (clamped in range)
    iy: np.ndarray  # int32
    iz: np.ndarray  # int32
    scale: np.ndarray  # f32: 1e-2 * trilinear weight / m[floor cell]; 0 if invalid
    src_idx: np.ndarray  # int32: which source each corner belongs to
    nsrc: int

    @property
    def empty(self) -> bool:
        return self.nsrc == 0

    def touches_rim(self, grid: Grid3D) -> bool:
        """True when a corner with nonzero weight lies outside the interior."""
        h = grid.halo
        live = self.scale != 0
        out = np.zeros_like(live)
        for idx, n in ((self.ix, grid.nx), (self.iy, grid.ny), (self.iz, grid.nz)):
            out |= (idx < h) | (idx >= h + n)
        return bool(np.any(live & out))


@dataclasses.dataclass(frozen=True)
class DeviceSourceTerm:
    """A SourceTerm's arrays as tensors on one device."""

    index: tuple  # (ix, iy, iz) int64 tensors
    scale: torch.Tensor  # f32
    src_idx: torch.Tensor  # int64
    empty: bool

    @staticmethod
    def of(term: SourceTerm, device) -> "DeviceSourceTerm":
        def lt(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        return DeviceSourceTerm(
            index=(lt(term.ix), lt(term.iy), lt(term.iz)),
            scale=torch.as_tensor(term.scale, device=device),
            src_idx=lt(term.src_idx),
            empty=term.empty,
        )


def build_source_term(grid: Grid3D, coords: np.ndarray | None, m: np.ndarray) -> SourceTerm:
    """Corner indices and weights for static source coordinates.

    coords: [nsrc, 3] physical coordinates, or None for no sources.
    m:      reference-layout medium field (host array).
    """
    halo = grid.halo
    tgt_shape = np.array(grid.padded_shape)
    if coords is None or coords.size == 0 or coords.shape[0] == 0:
        z = np.zeros((0,), dtype=np.int32)
        return SourceTerm(z, z, z, np.zeros((0,), np.float32), z, 0)

    coords = np.asarray(coords, dtype=np.float32)
    m = np.asarray(m, dtype=np.float32)
    nsrc = coords.shape[0]

    origins = np.array([grid.ox, grid.oy, grid.oz], dtype=np.float32)
    spacings = np.array([grid.hx, grid.hy, grid.hz], dtype=np.float32)
    sizes = np.array([grid.nx, grid.ny, grid.nz], dtype=np.int64)

    rel = (coords - origins[None, :]) / spacings[None, :]
    pos = np.floor(rel).astype(np.int64)
    frac = (rel - np.floor(rel)).astype(np.float32)

    ix, iy, iz, scale, src_idx = [], [], [], [], []
    for p in range(nsrc):
        # m at the floor cell serves all 8 corners (cuda.cu:145); the lookup
        # is clamped so that far out-of-range sources, whose corners are all
        # invalid, never index out of bounds
        mi = np.clip(pos[p] + halo, 0, np.array(m.shape) - 1)
        m_floor = m[mi[0], mi[1], mi[2]]
        for rx in (0, 1):
            wx = frac[p, 0] if rx else np.float32(1.0) - frac[p, 0]
            for ry in (0, 1):
                wy = frac[p, 1] if ry else np.float32(1.0) - frac[p, 1]
                for rz in (0, 1):
                    wz = frac[p, 2] if rz else np.float32(1.0) - frac[p, 2]
                    cell = pos[p] + np.array([rx, ry, rz])
                    valid = bool(np.all(cell >= -1) and np.all(cell <= sizes))
                    w = SOURCE_SCALE * wx * wy * wz / m_floor if valid else np.float32(0.0)
                    padded = np.clip(cell + halo, 0, tgt_shape - 1)
                    ix.append(padded[0])
                    iy.append(padded[1])
                    iz.append(padded[2])
                    scale.append(np.float32(w))
                    src_idx.append(p)

    return SourceTerm(
        ix=np.asarray(ix, dtype=np.int32),
        iy=np.asarray(iy, dtype=np.int32),
        iz=np.asarray(iz, dtype=np.int32),
        scale=np.asarray(scale, dtype=np.float32),
        src_idx=np.asarray(src_idx, dtype=np.int32),
        nsrc=nsrc,
    )


def inject(u: torch.Tensor, term: DeviceSourceTerm, src_t: torch.Tensor) -> torch.Tensor:
    """Scatter-add one step's source amplitudes into u in place.

    src_t: [nsrc] amplitudes for this step, on u's device. Duplicate corner
    indices accumulate like the reference's atomicAdd.
    """
    if term.empty:
        return u
    vals = (src_t[term.src_idx] * term.scale).to(u.dtype)
    return u.index_put_(term.index, vals, accumulate=True)


def injection_cubes_upto(grid: Grid3D, term: SourceTerm, m_val: float, dt: float,
                         kmax: int, m_core=None):
    """Correction cubes C_j (j = 2..kmax) for K-step temporal fusion.

    m_core: a heterogeneous medium, in the reference layout of term's
    indices (tpufdtd/sources.py:224-233). Each source's scratch grid then
    takes the m of its floor cell, overlaid with the window of the real
    medium around its deposit (clipped at the array's edge): a deposit
    spreads R*(j-1) cells in j-1 steps, so only that window's m reaches C_j.
    m_val is ignored when m_core is given.

    Injection is linear, so a unit deposit made into u_{n+1} propagates
    through the homogeneous leapfrog as e_1 = w, e_j = A e_{j-1} - e_{j-2}
    (e_0 = 0), i.e. e_j = oracle_step(e_{j-1}, e_{j-2}). C_j is e_j for each
    source's 8-corner trilinear pattern w, computed on a small scratch grid.
    A fused K-block over sources s_n..s_{n+K-1} is then corrected exactly
    (by superposition) as

        u_{n+K-1} += sum_{i=1..K-1} C_{K-i}   * s_{n+i-1}
        u_{n+K}   += sum_{i=1..K}   C_{K-i+1} * s_{n+i-1}

    with C_1 applied as the plain scatter. Returns
    {j: [(slices_into_reference_layout, cube, src_index), ...]}; C_j spans
    [floor - R*(j-1), floor + R*(j-1) + 2) per axis.
    """
    from .oracle import oracle_step

    out: dict = {j: [] for j in range(2, kmax + 1)}
    if term.empty or kmax < 2:
        return out
    R = grid.radius
    # C_j spreads R*(j-1) cells each way from the 2-cell corner pattern at
    # ctr, which must stay inside the scratch grid's interior
    n_mini = max(16 + 8 * max(0, kmax - 3), 2 * R * (kmax - 1) + 2)
    mini = Grid3D(n_mini, n_mini, n_mini, hx=grid.hx, hy=grid.hy, hz=grid.hz,
                  order=grid.order)
    h = mini.halo
    ctr = h + n_mini // 2 - 1  # a center cell with room
    mfield = np.full(mini.padded_shape, np.float32(1.0 if m_val is None else m_val), np.float32)
    for p in range(term.nsrc):
        sel = term.src_idx == p
        ix, iy, iz = term.ix[sel], term.iy[sel], term.iz[sel]
        sc = term.scale[sel]
        if sc.size == 0 or not np.any(sc != 0):
            continue
        fx, fy, fz = int(ix.min()), int(iy.min()), int(iz.min())
        if m_core is not None:
            # window radius: the kmax-1-step spread plus the stencil's reach
            wr = R * (kmax - 1) + R
            di = np.arange(-wr, wr + 2)
            cx, cy, cz = (np.clip(f + di, 0, n - 1) for f, n in zip((fx, fy, fz), m_core.shape))
            mfield[:] = np.float32(m_core[fx, fy, fz])
            mfield[np.ix_(ctr + di, ctr + di, ctr + di)] = np.asarray(
                m_core, np.float32
            )[np.ix_(cx, cy, cz)]
        w = np.zeros(mini.padded_shape, np.float32)
        for k in range(ix.shape[0]):
            w[ctr + ix[k] - fx, ctr + iy[k] - fy, ctr + iz[k] - fz] += sc[k]
        e_prev, e_cur = np.zeros_like(w), w
        for j in range(2, kmax + 1):
            e_prev, e_cur = e_cur, np.asarray(
                oracle_step(e_cur, e_prev, mfield, mini, dt), np.float32
            )
            g = R * (j - 1)
            side = 2 * g + 2
            lo = ctr - g
            cube = e_cur[lo : lo + side, lo : lo + side, lo : lo + side]
            sl = tuple(slice(f - g, f - g + side) for f in (fx, fy, fz))
            out[j].append((sl, cube, p))
    return out


def cubes_fit_core(cubes, core_shape, px, py, nz, z0: int = 0) -> bool:
    """All correction cubes sit fully inside the interior (x in
    [px, nxp-px), y in [py, nyp-py), z in [z0, z0+nz)). For the reference
    layout px = py = z0 = halo."""
    nxp, nyp, _ = core_shape
    for sl, _cube, _p in cubes:
        (sx, sy, sz) = sl
        if sx.start < px or sx.stop > nxp - px:
            return False
        if sy.start < py or sy.stop > nyp - py:
            return False
        if sz.start < z0 or sz.stop > z0 + nz:
            return False
    return True

"""Heterogeneous media for tests and card runs.

`layered` is a seeded stand-in for a seismic velocity model, in m = 1/c^2
units like the rest of the package: five layers along x, interfaces that dip
across y, and a small smooth perturbation. A real model file (SEG/EAGE 3-D
overthrust, Marmousi) would take its place once one is in the repository.
"""

from __future__ import annotations

import numpy as np

from ..config import Grid3D

LAYER_M = (1.0, 1.3, 1.6, 2.0, 2.5)  # m of each layer, shallow (low x) to deep
INTERFACES = (0.2, 0.4, 0.6, 0.8)  # interface depths at y = 0, fractions of nx
DIP = 0.1  # each interface deepens by DIP * nx across y
PERTURB = 0.05  # m is scaled by 1 + PERTURB * p, p smooth in [-1, 1]
TERMS = 4  # separable sine products summed into p


def layered(grid: Grid3D, seed: int = 0) -> np.ndarray:
    """The layered medium on the padded shape, f32. p is a sum of TERMS
    products of sines along x, y and z (1-3 periods across the grid, random
    phases and amplitudes from numpy's Generator seeded with `seed`),
    divided by the sum of the amplitudes, so that |p| <= 1."""
    h = grid.halo
    nxp, nyp, nzp = grid.padded_shape
    x = np.arange(nxp, dtype=np.float64) - h + 0.5  # cell centres, interior units
    y = (np.arange(nyp, dtype=np.float64) - h + 0.5) / grid.ny
    z = (np.arange(nzp, dtype=np.float64) - h + 0.5) / grid.nz
    depth = x[:, None] - DIP * grid.nx * y[None, :]  # (nxp, nyp), x less the dip
    layer = sum((depth >= f * grid.nx).astype(np.int64) for f in INTERFACES)
    m2d = np.asarray(LAYER_M, np.float32)[layer]

    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.5, 1.0, TERMS)
    p = np.zeros(grid.padded_shape, np.float32)
    for a in amps:
        fx, fy, fz = rng.integers(1, 4, 3)
        px, py, pz = rng.uniform(0.0, 2.0 * np.pi, 3)
        sx = np.sin(2.0 * np.pi * fx * x / grid.nx + px)
        sy = np.sin(2.0 * np.pi * fy * y + py)
        sz = np.sin(2.0 * np.pi * fz * z + pz)
        p += (a * sx[:, None] * sy[None, :]).astype(np.float32)[:, :, None] * sz.astype(
            np.float32)[None, None, :]
    p *= np.float32(PERTURB / amps.sum())
    p += np.float32(1.0)
    p *= m2d[:, :, None]
    return p

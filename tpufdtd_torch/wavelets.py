"""Source time functions and source placement (main.cpp:290-325).

NumPy on the host, f32 arithmetic like the reference; bitwise equal to the
JAX package's tables.
"""

from __future__ import annotations

import numpy as np


def ricker(nt: int, dt: float, f0: float = 10.0) -> np.ndarray:
    """Ricker wavelet at t = 0..nt-1 with peak shift 1/f0:
    val(t) = (1 - 2a) * exp(-a),  a = pi^2 f0^2 (t*dt - 1/f0)^2."""
    t = np.arange(nt, dtype=np.float32)
    tshift = t * np.float32(dt) - np.float32(1.0) / np.float32(f0)
    a = np.float32(np.pi) ** 2 * np.float32(f0) ** 2 * tshift * tshift
    return ((np.float32(1.0) - np.float32(2.0) * a) * np.exp(-a)).astype(np.float32)


def ricker_table(nt: int, nsrc: int, dt: float, f0: float = 10.0) -> np.ndarray:
    """[nt, nsrc] table with the same wavelet in every column (main.cpp:296)."""
    w = ricker(nt, dt, f0)
    return np.repeat(w[:, None], max(1, nsrc), axis=1)


def default_source_coords(
    nsrc: int, nx: int, ny: int, nz: int, h: float = 0.1
) -> np.ndarray:
    """Physical source coordinates on the lattice {1/4, 1/2, 3/4} of the
    domain extent L = (n-1)*h per axis (x outermost); positions past the 27
    lattice points go to the domain center (main.cpp:303-325)."""
    coords = np.zeros((max(1, nsrc), 3), dtype=np.float32)

    def ticks(n: int) -> list:
        L = np.float32((n - 1) * h)
        return [np.float32(0.25) * L, np.float32(0.50) * L, np.float32(0.75) * L]

    placed = 0
    for X in ticks(nx):
        for Y in ticks(ny):
            for Z in ticks(nz):
                if placed >= nsrc:
                    break
                coords[placed] = (X, Y, Z)
                placed += 1
    for p in range(placed, nsrc):
        coords[p] = (
            np.float32(0.5 * (nx - 1) * h),
            np.float32(0.5 * (ny - 1) * h),
            np.float32(0.5 * (nz - 1) * h),
        )
    return coords

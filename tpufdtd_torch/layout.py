"""The reference layout [nx+2H, ny+2H, nz+2H], H = order (main.cpp:360-363).

The Hopper kernels work on this layout directly, so the port keeps only
`Layout.reference`; the JAX package's TPU-aligned and z-split layouts have
no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from .config import Grid3D


@dataclasses.dataclass(frozen=True)
class Layout:
    grid: Grid3D
    pad_lo: Tuple[int, int, int]
    pad_hi: Tuple[int, int, int]

    @staticmethod
    def reference(grid: Grid3D) -> "Layout":
        h = grid.halo
        return Layout(grid, (h, h, h), (h, h, h))

    @property
    def padded_shape(self) -> Tuple[int, int, int]:
        n = (self.grid.nx, self.grid.ny, self.grid.nz)
        return tuple(n[i] + self.pad_lo[i] + self.pad_hi[i] for i in range(3))

    def interior_slices(self) -> Tuple[slice, slice, slice]:
        n = (self.grid.nx, self.grid.ny, self.grid.nz)
        return tuple(slice(self.pad_lo[i], self.pad_lo[i] + n[i]) for i in range(3))

    def shifted_slices(self, axis: int, d: int) -> Tuple[slice, slice, slice]:
        """Interior-sized slices shifted by d along `axis`."""
        n = (self.grid.nx, self.grid.ny, self.grid.nz)
        return tuple(
            slice(self.pad_lo[ax] + (d if ax == axis else 0),
                  self.pad_lo[ax] + (d if ax == axis else 0) + n[ax])
            for ax in range(3)
        )

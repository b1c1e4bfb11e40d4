"""The reference layout [nx+2H, ny+2H, nz+2H], H = order (main.cpp:360-363).

The Hopper kernels work on this layout directly, so the port keeps only
`Layout.reference`; the JAX package's TPU-aligned and z-split layouts have
no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

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

    @property
    def is_reference(self) -> bool:
        h = self.grid.halo
        return self.pad_lo == (h, h, h) and self.pad_hi == (h, h, h)

    def embed_region(self) -> Tuple[slice, slice, slice]:
        """Where a reference-layout array lands in this layout (the whole
        array for the reference layout)."""
        h = self.grid.halo
        n = (self.grid.nx, self.grid.ny, self.grid.nz)
        return tuple(slice(self.pad_lo[i] - h, self.pad_lo[i] + n[i] + h) for i in range(3))

    def embed(self, arr_ref) -> np.ndarray:
        """A copy of a reference-layout array in this layout, outer pads zero."""
        arr_ref = np.asarray(arr_ref)
        out = np.zeros(self.padded_shape, dtype=arr_ref.dtype)
        out[self.embed_region()] = arr_ref
        return out

    def extract(self, arr) -> np.ndarray:
        """A copy of this layout's array in the reference layout."""
        return np.array(np.asarray(arr)[self.embed_region()])

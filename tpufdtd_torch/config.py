"""Core types and constants of the PyTorch / CUDA port.

Physics contract (SURVEY.md §2.6), identical to the JAX package:
  PDE         m * d2u/dt2 = Lap(u) + source
  Spatial     central differences of order `order` (radius = order // 2),
              scaled by 1/h_axis^2 per axis
  Temporal    u_next = 2*u_cur - u_prev + dt^2 * Lap(u_cur) / m
  Storage     halo-padded float32 arrays [nx+2H, ny+2H, nz+2H], H = order
  Boundary    the halo rim keeps its initial value (frozen Dirichlet rim);
              steps write only the interior.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

DEFAULT_ORDER = 4

# f32 literals exactly as the reference oracle writes them
# (openacc.cpp:102-106). Index = distance from the center.
_ORDER4_WEIGHTS = (np.float32(-2.50), np.float32(1.333333330), np.float32(-8.33333333e-2))

# weights[d] multiplies (u[i-d] + u[i+d]) for d > 0; weights[0] multiplies u[i].
_STENCIL_WEIGHTS = {
    2: (np.float32(-2.0), np.float32(1.0)),
    4: _ORDER4_WEIGHTS,
    6: (
        np.float32(-49.0 / 18.0),
        np.float32(3.0 / 2.0),
        np.float32(-3.0 / 20.0),
        np.float32(1.0 / 90.0),
    ),
    8: (
        np.float32(-205.0 / 72.0),
        np.float32(8.0 / 5.0),
        np.float32(-1.0 / 5.0),
        np.float32(8.0 / 315.0),
        np.float32(-1.0 / 560.0),
    ),
    10: (
        np.float32(-5269.0 / 1800.0),
        np.float32(5.0 / 3.0),
        np.float32(-5.0 / 21.0),
        np.float32(5.0 / 126.0),
        np.float32(-5.0 / 1008.0),
        np.float32(1.0 / 3150.0),
    ),
    12: (
        np.float32(-5369.0 / 1800.0),
        np.float32(12.0 / 7.0),
        np.float32(-15.0 / 56.0),
        np.float32(10.0 / 189.0),
        np.float32(-1.0 / 112.0),
        np.float32(2.0 / 1925.0),
        np.float32(-1.0 / 16632.0),
    ),
}

# Source amplitude prefactor (cuda.cu:165, openacc.cpp:134).
SOURCE_SCALE = np.float32(1.0e-2)

BACKENDS = ("torch", "cuda")


def stencil_weights(order: int) -> Tuple[np.float32, ...]:
    """(w0, w1, ..., wR): w0 is the center weight, wd multiplies the pair at
    distance d. Order 4 uses the reference's exact f32 literals."""
    try:
        return _STENCIL_WEIGHTS[order]
    except KeyError:
        raise ValueError(
            f"unsupported stencil order {order}; supported: {sorted(_STENCIL_WEIGHTS)}"
        ) from None


def halo_for_order(order: int) -> int:
    """Pad cells per side: the reference's HALO == STENCIL_ORDER convention."""
    return order


def _from_fields(cls, obj, overrides):
    vals = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}
    vals.update(overrides)
    return cls(**vals)


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Interior grid extents and geometry (main.cpp:285-287)."""

    nx: int
    ny: int
    nz: int
    hx: float = 0.1
    hy: float = 0.1
    hz: float = 0.1
    ox: float = 0.0
    oy: float = 0.0
    oz: float = 0.0
    order: int = DEFAULT_ORDER

    @classmethod
    def from_fields(cls, obj) -> "Grid3D":
        """Copy any object with Grid3D's attribute names (e.g. the JAX
        package's Grid3D) into this type."""
        return _from_fields(cls, obj, {})

    @property
    def halo(self) -> int:
        return halo_for_order(self.order)

    @property
    def radius(self) -> int:
        return self.order // 2

    @property
    def padded_shape(self) -> Tuple[int, int, int]:
        h2 = 2 * self.halo
        return (self.nx + h2, self.ny + h2, self.nz + h2)

    @property
    def interior_cells(self) -> int:
        return self.nx * self.ny * self.nz

    def interior_slices(self) -> Tuple[slice, slice, slice]:
        h = self.halo
        return (slice(h, h + self.nx), slice(h, h + self.ny), slice(h, h + self.nz))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Time integration and backend configuration.

    backend: "cuda" runs the hand-written Hopper kernels (the default);
    "torch" runs the plain eager step on any device.
    t_fuse: steps per fused sweep call on the fast ring; 0 picks the port's
    own depth (stepper.K_AUTO), 1..ops.stencil_sweep.k_max() asks for
    exactly that depth.
    ring: "exact" 3-level ring, "fast" 2-level ring (raises when illegal),
    "auto" picks the fast ring when it is legal.
    pair and overlap are accepted for compatibility with the JAX package's
    configuration and select no code here.
    """

    dt: float = 0.001
    nsteps: int = 50
    warmup_steps: int = 5
    backend: str = "cuda"
    storage_dtype: str = "float32"
    assume_uniform_m: bool | None = None
    t_fuse: int = 0
    ring: str = "auto"
    pair: str = "auto"
    overlap: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}"
            )
        if self.ring not in ("auto", "exact", "fast"):
            raise ValueError(f"ring must be 'auto', 'exact' or 'fast'; got {self.ring!r}")
        if self.storage_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"storage_dtype must be 'float32' or 'bfloat16'; got {self.storage_dtype!r}"
            )

    @classmethod
    def from_fields(cls, obj, **overrides) -> "SimConfig":
        """Copy a config with SimConfig's attribute names (e.g. the JAX
        package's SimConfig); `overrides` replace fields, typically
        backend, whose JAX values ("jnp", "pallas") are not ours."""
        return _from_fields(cls, obj, overrides)

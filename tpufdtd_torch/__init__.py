"""tpufdtd_torch — the PyTorch / CUDA port of tpufdtd for NVIDIA Hopper.

The same 3D acoustic FDTD engine as the JAX package `tpufdtd` (order 2-12
central differences, leapfrog in time, halo-padded grids, Ricker point
sources by trilinear scatter-add), with the same host-facing contract:
NumPy arrays in the reference layout [n+2H]^3 go in and come out. Two
backends: "cuda" runs hand-written Hopper kernels (csrc/), "torch" the
plain eager step. This package imports torch and NumPy, never JAX.
"""

from .config import Grid3D, SimConfig, halo_for_order, stencil_weights  # noqa: F401
from .oracle import oracle_run, oracle_run_ring, oracle_step, truth_run_ring  # noqa: F401
from .sources import SourceTerm, build_source_term, inject  # noqa: F401
from .stepper import (  # noqa: F401
    Simulator,
    get_step_fn,
    make_engine,
    run_scan,
    simulate,
    simulate_ring,
)
from .wavelets import default_source_coords, ricker, ricker_table  # noqa: F401
from . import checkpoint, compat  # noqa: F401

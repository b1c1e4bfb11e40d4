"""The reference ABI on the port: tpufdtd_torch.compat.kernel_cuda against the
JAX package's tpufdtd.compat.kernel_tpu (jnp backend) on the same numpy
inputs, on the CPU (kernel A's plain version).

Tolerances: rel-L2 <= 1e-6 between the packages in every ring slot (two
f32 implementations of the same exact-ring steps differ by association
only, DEVIATIONS.md:10-19, ~1e-7 over these few steps); rel-L2 < 1e-4
against the f64 oracle ring, the repo's gate.
"""

import numpy as np
import pytest

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd.compat import kernel_tpu
from tpufdtd_torch.compat import Profiler, kernel_cuda
from conftest import make_correctness_ic, rel_l2

JAX_TOL = 1e-6
GATE = 1e-4


def _run_both(g, u, m, src, coords, p_src_M, time_M, time_m):
    """kernel_cuda and kernel_tpu on copies of u; returns both arrays and
    the port's profiler."""
    args = (g.nx - 1, 0, g.ny - 1, 0, g.nz - 1, 0, 0.001, g.hx, g.hy, g.hz, 0.0, 0.0, 0.0,
            p_src_M, 0, time_M, time_m)
    u_t, u_j = u.copy(), u.copy()
    timers = Profiler()
    assert kernel_cuda(m, src, coords, u_t, *args, timers=timers, device="cpu") == 0
    assert kernel_tpu(m, src, coords, u_j, *args, backend="jnp") == 0
    return u_t, u_j, timers


@pytest.mark.parametrize("nsrc,time_m", [(0, 0), (2, 0), (0, 4), (2, 4)])
def test_kernel_cuda_matches_kernel_tpu_and_oracle(nsrc, time_m):
    """All three ring slots, entry slots time_m % 3, (time_m + 2) % 3 and
    (time_m + 1) % 3 (cuda.cu:233-235), exit slots (time_M + 1) % 3,
    time_M % 3, (time_M + 2) % 3; with no sources, two sources, and a time
    range that starts past 0 (source rows time_m..time_M)."""
    g = tf.Grid3D(16, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    gt = tt.Grid3D.from_fields(g)
    up0, uc0, m = make_correctness_ic(g)
    nsteps = 11
    time_M = time_m + nsteps - 1
    u = np.zeros((3,) + g.padded_shape, np.float32)
    u[time_m % 3], u[(time_m + 2) % 3] = uc0, up0
    u[(time_m + 1) % 3] = uc0
    src = coords = None
    if nsrc:
        src = tf.ricker_table(time_M + 1, nsrc, 0.001)
        coords = tf.default_source_coords(nsrc, g.nx, g.ny, g.nz, h=1.0)
    u_t, u_j, timers = _run_both(gt, u, m, src, coords, nsrc - 1, time_M, time_m)
    ring = tf.oracle_run_ring(up0, uc0, m, g, 0.001, nsteps,
                              src=None if src is None else src[time_m:], src_coords=coords,
                              u_target=uc0, dtype=np.float64)
    exit_slots = ((time_M + 1) % 3, time_M % 3, (time_M + 2) % 3)  # u_N, u_{N-1}, u_{N-2}
    for slot, want in zip(exit_slots, (ring[1], ring[0], ring[2])):
        assert rel_l2(u_t[slot], u_j[slot]) <= JAX_TOL, slot
        assert rel_l2(u_t[slot], want) < GATE, slot
    assert timers.section0 > 0
    assert (timers.section1 > 0) == (nsrc > 0)


def test_kernel_cuda_refuses_what_the_abi_does_not_take():
    g = tt.Grid3D(8, 8, 8)
    m = np.full(g.padded_shape, 1.5, np.float32)
    u = np.zeros((3,) + g.padded_shape, np.float32)
    geom = (0.001, 0.1, 0.1, 0.1, 0.0, 0.0, 0.0, -1, 0, 4, 0)
    with pytest.raises(ValueError, match="start at 0"):
        kernel_cuda(m, None, None, u, 7, 1, 7, 0, 7, 0, *geom, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        kernel_cuda(m, None, None, u[:, :-1], 7, 0, 7, 0, 7, 0, *geom, device="cpu")
    # an empty time range leaves u as it was
    before = u.copy()
    assert kernel_cuda(m, None, None, u, 7, 0, 7, 0, 7, 0, *geom[:-2], 2, 3, device="cpu") == 0
    assert np.array_equal(u, before)

"""The port's oracles against the JAX package's: the NumPy oracle is a copy
and must be bitwise equal; the torch-f64 truth must agree with the JAX-f64
truth to f64 roundoff (1e-12 relative)."""

import numpy as np
import pytest

import tpufdtd as tf
import tpufdtd.oracle as joracle
import tpufdtd_torch as tt
from conftest import make_correctness_ic, rel_l2


def _grids(n=12, **kw):
    return tt.Grid3D(n, n, n, **kw), tf.Grid3D(n, n, n, **kw)


@pytest.mark.parametrize("order", [2, 4, 8])
def test_oracle_step_bitwise(order):
    g, gj = _grids(10, hx=1.0, hy=0.5, hz=2.0, order=order)
    rng = np.random.default_rng(order)
    uc, up, tgt = (rng.standard_normal(g.padded_shape).astype(np.float32) for _ in range(3))
    m = (1.0 + rng.random(g.padded_shape)).astype(np.float32)
    for dtype in (np.float32, np.float64):
        a = tt.oracle_step(uc, up, m, g, 0.001, dtype=dtype, target=tgt)
        b = tf.oracle_step(uc, up, m, gj, 0.001, dtype=dtype, target=tgt)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_oracle_ring_bitwise_with_sources():
    g, gj = _grids(12, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m = make_correctness_ic(gj)
    coords = np.array([[5.5, 6.25, 4.0], [3.0, 3.0, -0.5]], np.float32)
    src = tt.ricker_table(7, 2, 0.001)
    a = tt.oracle_run_ring(up, uc, m, g, 0.001, 7, src=src, src_coords=coords)
    b = tf.oracle_run_ring(up, uc, m, gj, 0.001, 7, src=src, src_coords=coords)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()
    p, c = tt.oracle_run(up, uc, m, g, 0.001, 7, src=src, src_coords=coords)
    assert p.tobytes() == a[0].tobytes() and c.tobytes() == a[1].tobytes()


@pytest.mark.parametrize("with_src", [False, True])
def test_truth_matches_jax_truth(with_src):
    g, gj = _grids(12, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m = make_correctness_ic(gj)
    coords = np.array([[5.5, 6.25, 4.0], [3.0, 3.0, -0.5]], np.float32) if with_src else None
    src = tt.ricker_table(9, 2, 0.001) if with_src else None
    a = tt.truth_run_ring(up, uc, m, g, 0.001, 9, src, coords, device="cpu")
    b = joracle.truth_run_ring(up, uc, m, gj, 0.001, 9, src, coords)
    for x, y in zip(a, b):
        assert x.dtype == np.float64
        assert rel_l2(x, y) < 1e-12


def test_truth_matches_numpy_f64_oracle_anisotropic():
    g, _ = _grids(10, hx=1.0, hy=0.5, hz=2.0, order=6)
    rng = np.random.default_rng(4)
    up, uc = (rng.standard_normal(g.padded_shape).astype(np.float32) for _ in range(2))
    m = (1.0 + rng.random(g.padded_shape)).astype(np.float32)
    a = tt.truth_run_ring(up, uc, m, g, 0.0005, 6, device="cpu")
    b = tt.oracle_run_ring(up, uc, m, g, 0.0005, 6, dtype=np.float64)
    for x, y in zip(a, b):
        assert rel_l2(x, y) < 1e-12

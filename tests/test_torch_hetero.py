"""The heterogeneous-medium path on the CPU: Simulator(backend="cuda") with a
per-point m at orders 2-6 runs the fast ring on kernel B's w mode (its
plain version here), with correction cubes built from the local medium.
The port's versions of tests/test_sweep.py:481-524, against the f64 oracle
at 2e-6 and against the JAX package's Simulator(backend="pallas") on the
same inputs, which runs its sweep with the w stream.
"""

import numpy as np
import pytest

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd_torch.harness import media
from conftest import rel_l2

TOL = 2e-6


def _fast_ic(grid, seed):
    rng = np.random.default_rng(seed)
    h = grid.halo
    rim = rng.standard_normal(grid.padded_shape).astype(np.float32)
    out = []
    for _ in range(2):
        a = rim.copy()
        a[h:-h, h:-h, h:-h] = rng.standard_normal((grid.nx, grid.ny, grid.nz))
        out.append(a)
    return out


def _smooth_m(shape, seed=0):
    """The smooth medium in [1.2, 2.0] of tests/test_sweep.py:471-478."""
    x = np.linspace(0, 1, shape[0])[:, None, None]
    y = np.linspace(0, 1, shape[1])[None, :, None]
    z = np.linspace(0, 1, shape[2])[None, None, :]
    return (1.6 + 0.4 * np.sin(3 * x + seed) * np.cos(2 * y) * np.sin(4 * z)).astype(np.float32)


def _run(sim, up, uc, src, nsteps):
    return sim.extract_state(sim.run(sim.prepare_state(up, uc), src, nsteps))


@pytest.mark.parametrize("nz,order", [(32, 4), (128, 4), (32, 2), (32, 6)])
def test_w_path_vs_oracle(nz, order):
    """test_sweep_variable_m_vs_oracle: the fast ring engages for a
    heterogeneous m, streams w, and matches the f64 oracle."""
    g = tt.Grid3D(32, 16, nz, order=order)
    up, uc = _fast_ic(g, 3)
    m = _smooth_m(g.padded_shape)
    sim = tt.Simulator(g, tt.SimConfig(dt=0.001, nsteps=7), m, device="cpu")
    eng = sim.engine
    assert eng.m_val is None and eng.sweep_k >= 2 and eng.w is not None
    p, c = _run(sim, up, uc, None, 7)
    tp, tc = tt.oracle_run(up, uc, m, g, 0.001, 7, dtype=np.float64)
    assert rel_l2(c, tc) < TOL and rel_l2(p, tp) < TOL


def test_w_path_with_source_matches_jax_sweep_and_oracle():
    """test_sweep_variable_m_with_source, with the source inside the grid
    (cell (18, 10, 18) of the strong local contrast) and, so that the JAX
    sweep compiles one depth in interpret mode, t_fuse = 3 over 6 steps on
    both sides: the correction cubes through the local medium keep the
    source exact; the same levels as the JAX package's sweep ring."""
    gj = tf.Grid3D(32, 16, 32)
    g = tt.Grid3D.from_fields(gj)
    up, uc = _fast_ic(g, 5)
    m = _smooth_m(g.padded_shape, seed=2)
    m[16:22, 8:14, 16:22] *= 1.3
    coords = np.array([[1.8, 1.0, 1.8]], np.float32)
    src = tt.ricker_table(6, 1, 0.001)
    sim = tt.Simulator(g, tt.SimConfig(dt=0.001, nsteps=6, t_fuse=3), m, coords, device="cpu")
    assert sim.engine.sweep_k == 3 and sim.engine.mode == ("float32", "w")
    assert sim.engine.cubes[3]  # the source deposits inside the grid
    got = _run(sim, up, uc, src, 6)
    sim_j = tf.Simulator(gj, tf.SimConfig(dt=0.001, nsteps=6, t_fuse=3, backend="pallas"), m,
                         coords)
    assert sim_j.engine.sweep_k == 3 and sim_j.engine.sweep_w is not None
    want = _run(sim_j, up, uc, src, 6)
    truth = tt.oracle_run(up, uc, m, g, 0.001, 6, src=src, src_coords=coords, dtype=np.float64)
    assert len(got) == len(want) == 2
    for mine, theirs, true in zip(got, want, truth):
        assert rel_l2(mine, theirs) < TOL and rel_l2(mine, true) < TOL


def test_layered_medium():
    """harness/media.layered: five layers, dipping interfaces, a 5 %
    perturbation, seeded."""
    g = tt.Grid3D(40, 20, 24)
    m = media.layered(g)
    assert m.shape == g.padded_shape and m.dtype == np.float32
    np.testing.assert_array_equal(m, media.layered(g, seed=0))
    assert not np.array_equal(m, media.layered(g, seed=1))
    lo, hi = min(media.LAYER_M), max(media.LAYER_M)
    assert m.min() >= lo * (1 - media.PERTURB) and m.max() <= hi * (1 + media.PERTURB)
    h = g.halo
    column = m[h:-h, h, h]  # along x at y = 0: interfaces at 20/40/60/80 % of nx
    layer = np.searchsorted(np.array(media.LAYER_M) * (1 + media.PERTURB), column)
    assert list(np.flatnonzero(np.diff(layer)) + 1) == [8, 16, 24, 32]
    deep = m[h:-h, -h - 1, h]  # at the far y edge each interface is ~10 % of nx deeper
    layer_deep = np.searchsorted(np.array(media.LAYER_M) * (1 + media.PERTURB), deep)
    assert list(np.flatnonzero(np.diff(layer_deep)) + 1) == [12, 20, 28, 36]

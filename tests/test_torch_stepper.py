"""The whole slice on device="cpu": tpufdtd_torch's stepper against the JAX
package's jnp backend and the f64 oracle. On the CPU the "cuda" backend's
wrappers run their plain versions, so this exercises the stepper, the ring
logic, the source correction and the K gating the card runs.
Tolerance 2e-6 rel-L2 as in tests/test_sweep.py:60 (fusion reassociates
and the source correction is exact only up to f32 rounding).
"""

import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd_torch import stepper
from conftest import make_correctness_ic, rel_l2

TOL = 2e-6


def _grids(nx, ny, nz, **kw):
    return tt.Grid3D(nx, ny, nz, **kw), tf.Grid3D(nx, ny, nz, **kw)


def _fast_ic(grid, seed=0):
    """Random interior, one random rim shared by both levels."""
    rng = np.random.default_rng(seed)
    h = grid.halo
    rim = rng.standard_normal(grid.padded_shape).astype(np.float32)
    out = []
    for _ in range(2):
        a = rim.copy()
        a[h:-h, h:-h, h:-h] = rng.standard_normal((grid.nx, grid.ny, grid.nz))
        out.append(a)
    return out


def _run_fast(g, nsteps, coords=None, seed=0, cfg_kw=None, expect_k=None):
    up, uc = _fast_ic(g, seed)
    m = np.full(g.padded_shape, 1.5, np.float32)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, backend="cuda", **(cfg_kw or {}))
    src = tt.ricker_table(nsteps, coords.shape[0], cfg.dt) if coords is not None else None
    sim = tt.Simulator(g, cfg, m, coords, device="cpu")
    if expect_k is not None:
        assert sim.engine.sweep_k == expect_k
    state = sim.prepare_state(up, uc)
    state = sim.run(state, src, nsteps)
    got = sim.extract_state(state)
    truth = tt.oracle_run(up, uc, m, g, cfg.dt, nsteps, src=src, src_coords=coords,
                          dtype=np.float64)
    return sim, state, got, truth


@pytest.mark.parametrize("nsteps", [3, 6, 7, 8, 10])
def test_fast_ring_step_counts(nsteps):
    g, _ = _grids(12, 16, 20, hx=1.0, hy=1.0, hz=1.0)
    coords = np.array([[6.0, 8.0, 10.0]], np.float32)
    sim, state, (p, c), (tp, tc) = _run_fast(g, nsteps, coords, expect_k=stepper.K_AUTO)
    assert isinstance(state, dict)
    assert rel_l2(c, tc) < TOL and rel_l2(p, tp) < TOL


@pytest.mark.parametrize("t_fuse", [1, 2, 3, 4])
def test_fast_ring_explicit_depths_with_two_offgrid_sources(t_fuse):
    g, _ = _grids(20, 16, 24, hx=1.0, hy=1.0, hz=1.0)
    coords = np.array([[9.3, 8.6, 11.2], [10.9, 7.1, 12.8]], np.float32)
    _, _, (p, c), (tp, tc) = _run_fast(g, 9, coords, cfg_kw={"t_fuse": t_fuse},
                                       expect_k=t_fuse)
    assert rel_l2(c, tc) < TOL and rel_l2(p, tp) < TOL


def test_fast_ring_anisotropic_spacing():
    g, _ = _grids(12, 16, 20, hx=1.0, hy=0.5, hz=2.0)
    _, _, (p, c), (tp, tc) = _run_fast(g, 7, seed=3)
    assert rel_l2(c, tc) < TOL and rel_l2(p, tp) < TOL


@pytest.mark.parametrize("x,k_auto,want_k", [(3.0, 4, 2), (5.0, 4, 3), (1.0, 2, 0), (-0.5, 2, 0)])
def test_near_boundary_source_degrades_k(monkeypatch, x, k_auto, want_k):
    """Correction cubes that do not fit the interior degrade K; no K >= 2
    (or a rim deposit) leaves the exact ring. Results stay exact."""
    monkeypatch.setattr(stepper, "K_AUTO", k_auto)
    g, _ = _grids(16, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    coords = np.array([[x, 8.0, 8.0]], np.float32)
    sim, state, got, truth = _run_fast(g, 7, coords, expect_k=want_k)
    assert isinstance(state, dict) == (want_k > 0)
    assert rel_l2(got[1], truth[1]) < TOL


def test_fast_ring_matches_jnp_exact_ring():
    """Fast ring (kernel B path) against the JAX jnp backend on the same
    identical-rim ICs and source."""
    g, gj = _grids(16, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    coords = tf.default_source_coords(1, 16, 16, 16, h=1.0)
    _, _, (p, c), _ = _run_fast(g, 9, coords, seed=5)
    up, uc = _fast_ic(g, 5)
    m = np.full(g.padded_shape, 1.5, np.float32)
    src = tf.ricker_table(9, 1, 0.001)
    pj, cj = tf.simulate(up, uc, m, gj, tf.SimConfig(dt=0.001, nsteps=9, backend="jnp"),
                         src=src, src_coords=coords)
    assert rel_l2(c, cj) < TOL and rel_l2(p, pj) < TOL


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_exact_ring_matches_jnp_and_rims_cycle(backend):
    """Mixed-rim ICs run the exact ring: all three levels match the JAX jnp
    ring, and every rim reproduces the oracle's bit for bit."""
    g, gj = _grids(12, 12, 12, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m = make_correctness_ic(gj)
    coords = np.array([[5.5, 6.25, 4.0], [3.0, 3.0, -0.5]], np.float32)
    src = tt.ricker_table(7, 2, 0.001)
    cfg = tt.SimConfig(dt=0.001, nsteps=7, backend=backend)
    ring = tt.simulate_ring(up, uc, m, g, cfg, src, coords, device="cpu")
    ring_j = tf.simulate_ring(up, uc, m, gj, tf.SimConfig(dt=0.001, nsteps=7, backend="jnp"),
                              src, coords)
    ring_o = tf.oracle_run_ring(up, uc, m, gj, 0.001, 7, src=src, src_coords=coords)
    h = g.halo
    mask = np.ones(g.padded_shape, bool)
    mask[h:-h, h:-h, h:-h] = False
    for mine, jax_lvl, orc in zip(ring, ring_j, ring_o):
        assert rel_l2(mine, jax_lvl) < TOL
        np.testing.assert_array_equal(mine[mask], orc[mask])
    assert np.abs(ring[1][3 + h, 3 + h, h - 1]) > 0  # the rim deposit persists


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_correctness_gate_16(backend):
    g, _ = _grids(16, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m = make_correctness_ic(g)
    _, c = tt.simulate(up, uc, m, g, tt.SimConfig(nsteps=50, backend=backend), device="cpu")
    _, ct, _ = tt.truth_run_ring(up, uc, m, g, 0.001, 50, device="cpu")
    assert rel_l2(c, ct) < 1e-4


def test_nonuniform_m_exact_ring():
    g, _ = _grids(8, 16, 12, hx=1.0, hy=1.0, hz=1.0)
    up, uc, _ = make_correctness_ic(g)
    m = (1.0 + np.random.default_rng(1).random(g.padded_shape)).astype(np.float32)
    cfg = tt.SimConfig(dt=0.0005, nsteps=10, backend="cuda")
    _, c = tt.simulate(up, uc, m, g, cfg, device="cpu")
    _, ct = tt.oracle_run(up, uc, m, g, 0.0005, 10, dtype=np.float64)
    assert rel_l2(c, ct) < 1e-4


def test_determinism_and_split_spans():
    """Two identical runs are bitwise equal, and a run split into an odd
    warmup span plus the rest matches the single span to f32 rounding."""
    g, _ = _grids(16, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    coords = tt.default_source_coords(1, 16, 16, 16, h=1.0)
    a = _run_fast(g, 10, coords, seed=7)[2]
    b = _run_fast(g, 10, coords, seed=7)[2]
    np.testing.assert_array_equal(a[1], b[1])
    up, uc = _fast_ic(g, 7)
    m = np.full(g.padded_shape, 1.5, np.float32)
    src = tt.ricker_table(10, 1, 0.001)
    sim = tt.Simulator(g, tt.SimConfig(nsteps=10), m, coords, device="cpu")
    st = sim.run(sim.prepare_state(up, uc), src[:3], 3)
    st = sim.run(st, src[3:], 7)
    assert rel_l2(sim.extract_state(st)[1], a[1]) < TOL


def test_run_timed_and_random_state_on_cpu():
    g, _ = _grids(12, 12, 12)
    coords = tt.default_source_coords(1, 12, 12, 12)
    sim = tt.Simulator(g, tt.SimConfig(nsteps=8, warmup_steps=3), np.full(g.padded_shape, 1.5, np.float32),
                       coords, device="cpu")
    st = sim.prepare_state_random(0)
    assert isinstance(st, dict) and torch.equal(st["sweep"][0], sim.prepare_state_random(0)["sweep"][0])
    st, secs, clock = sim.run_timed(st, tt.ricker_table(8, 1, 0.001))
    assert clock == "host" and secs > 0
    mx, nan = sim.state_field_stats(st)
    assert mx > 0 and not nan
    zero = sim.prepare_state_random(0, scale=0.0)
    assert sim.state_field_stats(zero) == (0.0, False)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    g = tt.Grid3D(8, 8, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tt.Simulator(g, tt.SimConfig(), np.ones(g.padded_shape, np.float32), device="cuda")


@pytest.mark.parametrize("case", ["bf16", "hetero_fast", "order6_fast", "mixed_rims_fast"])
def test_unported_paths_raise(case):
    g = tt.Grid3D(8, 8, 8, order=6 if case == "order6_fast" else 4)
    m = np.full(g.padded_shape, 1.5, np.float32)
    kw = {}
    if case == "bf16":
        kw = {"storage_dtype": "bfloat16"}
    elif case == "hetero_fast":
        m[4, 4, 4] = 2.0
    else:
        kw = {"ring": "fast"}
    cfg = tt.SimConfig(**kw)
    if case == "mixed_rims_fast":
        sim = tt.Simulator(g, cfg, m, device="cpu")
        up, uc, _ = make_correctness_ic(g)
        with pytest.raises(ValueError, match="identical rims"):
            sim.prepare_state(up, uc)
        return
    with pytest.raises(NotImplementedError):
        tt.Simulator(g, cfg, m, device="cpu")

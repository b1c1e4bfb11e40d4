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
from tpufdtd_torch.ops import stencil_sweep
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
    sim, state, (p, c), (tp, tc) = _run_fast(g, nsteps, coords, expect_k=stepper.K_AUTO[2])
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


def _jax_state(gj, cfg, m, coords, up, uc):
    sim = tf.Simulator(gj, cfg, m, coords)
    return sim, sim.prepare_state(up, uc)


@pytest.mark.parametrize("x,k_auto,want_k", [(3.0, 4, 2), (5.0, 4, 3), (1.0, 2, 1), (-0.5, 2, 0)])
def test_near_boundary_source_degrades_k(monkeypatch, x, k_auto, want_k):
    """Correction cubes that do not fit the interior degrade K, down to
    K = 1 on the fast ring, as the JAX package falls back to packed_step
    (key packed2); a rim deposit leaves the exact ring. Results stay exact.
    At x = -0.5 the deposit lands in the x rim: the JAX package checks only
    the z rim, stays on the fast ring and misses the oracle there."""
    monkeypatch.setitem(stepper.K_AUTO, 2, k_auto)
    g, gj = _grids(16, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    coords = np.array([[x, 8.0, 8.0]], np.float32)
    sim, state, got, truth = _run_fast(g, 7, coords, expect_k=want_k)
    assert isinstance(state, dict) == (want_k > 0)
    assert rel_l2(got[1], truth[1]) < TOL
    if want_k > 1:
        return
    m = np.full(g.padded_shape, 1.5, np.float32)
    if want_k == 1:
        _, st = _jax_state(gj, tf.SimConfig(dt=0.001, backend="pallas"), m, coords,
                           *_fast_ic(g))
        assert next(iter(st)).startswith("packed2")
        return
    u0 = np.zeros(g.padded_shape, np.float32)
    src = tf.ricker_table(7, 1, 0.001)
    cfg = tf.SimConfig(dt=0.001, nsteps=7, backend="pallas")
    sim_j, st = _jax_state(gj, cfg, m, coords, u0, u0)
    assert isinstance(st, dict)
    _, c_jax = sim_j.extract_state(sim_j.run(st, src, 7))
    _, c_port = tt.simulate(u0, u0, m, g, tt.SimConfig(dt=0.001, nsteps=7), src, coords,
                            device="cpu")
    _, c_true = tt.oracle_run(u0, u0, m, g, 0.001, 7, src=src, src_coords=coords,
                              dtype=np.float64)
    assert rel_l2(c_port, c_true) < TOL
    assert rel_l2(c_jax, c_true) > 1e-2


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
    st, secs = sim.run_timed(st, tt.ricker_table(8, 1, 0.001))
    assert sim.last_clock == "host" and secs > 0
    mx, nan = sim.state_field_stats(st)
    assert mx > 0 and not nan
    zero = sim.prepare_state_random(0, scale=0.0)
    assert sim.state_field_stats(zero) == (0.0, False)


@pytest.mark.parametrize("ring", ["auto", "exact"])
def test_run_timed_takes_the_jax_call_and_timing_repeat(ring):
    """F4 (ROADMAP Queue 3): run_timed(state, src, timing_repeat=q) returns
    (state, seconds) as the JAX package's does; q > 1 times a stretched
    span on a copy, and the physics state is bitwise that of q = 1."""
    g, _ = _grids(12, 12, 12)
    coords = tt.default_source_coords(1, 12, 12, 12)
    m = np.full(g.padded_shape, 1.5, np.float32)
    src = tt.ricker_table(9, 1, 0.001)
    up, uc = _fast_ic(g)
    outs = []
    for q in (1, 3):
        sim = tt.Simulator(g, tt.SimConfig(nsteps=9, warmup_steps=2, ring=ring), m, coords,
                           device="cpu")
        state, secs = sim.run_timed(sim.prepare_state(up, uc), src, timing_repeat=q)
        assert secs > 0 and sim.last_clock == "host"
        assert isinstance(state, dict) == (ring == "auto")
        outs.append(sim.extract_state(state))
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    # and the same physics as an untimed run of all the steps
    sim = tt.Simulator(g, tt.SimConfig(nsteps=9, ring=ring), m, coords, device="cpu")
    st = sim.run(sim.prepare_state(up, uc), src[:2], 2)
    plain = sim.extract_state(sim.run(st, src[2:], 7))
    assert all(np.array_equal(a, b) for a, b in zip(outs[0], plain))


@pytest.mark.parametrize("backend,jax_backend", [("torch", "jnp"), ("cuda", "jnp")])
def test_get_step_fn_matches_the_jax_package(backend, jax_backend):
    """get_step_fn(grid, dt, backend) is step(u_cur, u_prev, m, target), as
    the JAX package's; one step of each against the JAX jnp step on the same
    inputs, rel-L2 <= TOL (independent f32 implementations)."""
    import jax.numpy as jnp

    g, gj = _grids(10, 12, 14)
    rng = np.random.default_rng(4)
    cur, prev, tgt = (rng.standard_normal(g.padded_shape).astype(np.float32) for _ in range(3))
    m = (1.5 + 0.5 * rng.random(g.padded_shape)).astype(np.float32)
    step = tt.get_step_fn(g, 0.01, backend)
    got = step(torch.tensor(cur), torch.tensor(prev), torch.tensor(m), torch.tensor(tgt))
    want = np.asarray(tf.get_step_fn(gj, 0.01, jax_backend)(
        jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(m), jnp.asarray(tgt)))
    assert rel_l2(got.numpy(), want) < TOL
    rim = np.ones(g.padded_shape, bool)
    rim[g.interior_slices()] = False
    assert np.array_equal(got.numpy()[rim], tgt[rim])
    with pytest.raises(ValueError):
        tt.get_step_fn(g, 0.01, "pallas")


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    g = tt.Grid3D(8, 8, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tt.Simulator(g, tt.SimConfig(), np.ones(g.padded_shape, np.float32), device="cuda")


def test_simulator_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    g = tt.Grid3D(8, 8, 8)
    m = np.ones(g.padded_shape, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        tt.Simulator(g, tt.SimConfig(), m)
    with pytest.raises(RuntimeError, match="cuda"):
        tt.simulate(m, m, m, g, tt.SimConfig(nsteps=1))


@pytest.mark.parametrize("case", ["order12_fast", "mixed_rims_fast", "hetero_order8_auto"])
def test_unported_paths_raise(case):
    order = {"order12_fast": 12, "hetero_order8_auto": 8}.get(case, 4)
    g = tt.Grid3D(8, 8, 8, order=order)
    m = np.full(g.padded_shape, 1.5, np.float32)
    kw = {}
    if case == "hetero_order8_auto":
        m[4, 4, 4] = 2.0
    else:
        kw = {"ring": "fast"}
    cfg = tt.SimConfig(**kw)
    if case == "hetero_order8_auto":
        # as in the JAX package, radius 4 with a heterogeneous m takes the
        # exact ring; asking for the fast ring raises
        sim = tt.Simulator(g, cfg, m, device="cpu")
        up, uc, _ = make_correctness_ic(g)
        assert sim.engine.sweep_k == 0 and len(sim.prepare_state(uc, uc)) == 3
        cfg = tt.SimConfig(ring="fast")
    elif case == "mixed_rims_fast":
        sim = tt.Simulator(g, cfg, m, device="cpu")
        up, uc, _ = make_correctness_ic(g)
        with pytest.raises(ValueError, match="identical rims"):
            sim.prepare_state(up, uc)
        return
    with pytest.raises(NotImplementedError):
        tt.Simulator(g, cfg, m, device="cpu")


# The routing of the heterogeneous-medium and bf16 paths: case -> (order,
# heterogeneous m, storage, SimConfig fields, source x or None, identical
# rims, the fast ring expected (None: both packages raise ValueError)).
ROUTES = {
    "hetero_fast": (4, True, "float32", {}, None, True, True),
    "hetero_order2": (2, True, "float32", {}, None, True, True),
    "hetero_order6": (6, True, "float32", {}, None, True, True),
    "hetero_order8": (8, True, "float32", {}, None, True, False),
    "hetero_t_fuse_2": (4, True, "float32", {"t_fuse": 2}, None, True, False),
    "hetero_t_fuse_3": (4, True, "float32", {"t_fuse": 3}, None, True, True),
    "hetero_source_near_boundary": (4, True, "float32", {}, 1.0, True, False),
    "hetero_mixed_rims": (4, True, "float32", {}, None, False, False),
    "bf16": (4, False, "bfloat16", {}, None, True, True),
    "bf16_hetero": (4, True, "bfloat16", {}, 8.0, True, True),
    "bf16_order6": (6, False, "bfloat16", {}, None, True, True),
    "bf16_order8": (8, False, "bfloat16", {}, None, True, False),
    "bf16_order12": (12, False, "bfloat16", {}, None, True, False),
    "bf16_ring_exact": (4, False, "bfloat16", {"ring": "exact"}, None, True, False),
    "bf16_t_fuse_2": (4, False, "bfloat16", {"t_fuse": 2}, None, True, False),
    "bf16_source_near_boundary": (4, False, "bfloat16", {}, 1.0, True, False),
    "bf16_mixed_rims": (4, False, "bfloat16", {}, None, False, None),
    "bf16_t_fuse_3_order8": (8, False, "bfloat16", {"t_fuse": 3}, None, True, None),
    # t_fuse 3 at order 6 runs at k_max(3) = 2 in the port (the depth cap)
    "order6_t_fuse_3": (6, False, "float32", {"t_fuse": 3}, None, True, True),
    "hetero_order6_t_fuse_3": (6, True, "float32", {"t_fuse": 3}, None, True, True),
    "bf16_order6_t_fuse_3": (6, False, "bfloat16", {"t_fuse": 3}, None, True, True),
    "order8_t_fuse_3": (8, False, "float32", {"t_fuse": 3}, None, True, None),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_routing_matches_the_jax_package(case):
    """Simulator(backend="cuda") picks the ring the JAX package's "pallas"
    backend picks, and so holds as many levels: the fast ring (kernel B in
    w, bf16 or bf16 + w mode) or the exact ring (kernel A); both refuse
    the same configurations."""
    order, hetero, storage, kw, src_x, same_rims, fast = ROUTES[case]
    g, gj = _grids(16, 16, 16, hx=1.0, hy=1.0, hz=1.0, order=order)
    m = np.full(g.padded_shape, 1.5, np.float32)
    if hetero:
        m[8, 8, 8] = 2.0
    coords = None if src_x is None else np.array([[src_x, 8.0, 8.0]], np.float32)
    if same_rims:
        up, uc = _fast_ic(g, 1)
    else:
        up, uc, _ = make_correctness_ic(g)
    cfg = dict(dt=0.001, storage_dtype=storage, **kw)
    if fast is None:
        with pytest.raises(ValueError):
            sim = tt.Simulator(g, tt.SimConfig(**cfg), m, coords, device="cpu")
            sim.prepare_state(up, uc)
        with pytest.raises(ValueError):
            sim_j = tf.Simulator(gj, tf.SimConfig(backend="pallas", **cfg), m, coords)
            sim_j.prepare_state(up, uc)
        return
    sim = tt.Simulator(g, tt.SimConfig(**cfg), m, coords, device="cpu")
    sim_j = tf.Simulator(gj, tf.SimConfig(backend="pallas", **cfg), m, coords)
    levels = sim.extract_state(sim.prepare_state(up, uc))
    levels_j = sim_j.extract_state(sim_j.prepare_state(up, uc))
    assert (sim.engine.sweep_k > 0) == (getattr(sim_j.engine, "sweep_k", 0) > 0)
    assert len(levels) == len(levels_j) == (2 if fast else 3)
    assert sim.engine.mode == (storage, "w" if hetero else "m")
    if fast:
        assert sim.engine.sweep_k >= 2


@pytest.mark.parametrize("order", [2, 4, 6, 8, 10, 12])
def test_slice_levels_and_oracle_every_order(order):
    """Simulator(backend="cuda") with uniform m, identical rims, one source
    and ring="auto" holds as many levels as the JAX package's "pallas"
    backend (2 on the fast ring at orders 2-8, 3 on the exact ring at
    10-12) and its u_N is within 1e-5 rel-L2 of the f64 oracle. The JAX
    package's levels come from its prepared state, whose kind the run keeps."""
    g, gj = _grids(16, 16, 16, hx=1.0, hy=1.0, hz=1.0, order=order)
    coords = tf.default_source_coords(1, 16, 16, 16, h=1.0)
    sim, state, got, truth = _run_fast(g, 6, coords, seed=order)
    m = np.full(g.padded_shape, 1.5, np.float32)
    up, uc = _fast_ic(g, order)
    sim_j, st_j = _jax_state(gj, tf.SimConfig(dt=0.001, nsteps=6, backend="pallas"), m,
                             coords, up, uc)
    assert len(got) == len(sim_j.extract_state(st_j)) == (2 if order <= 8 else 3)
    assert rel_l2(got[1], truth[1]) < 1e-5


@pytest.mark.parametrize("t_fuse", [1, 2])
def test_order8_fast_ring_matches_jax_packed(t_fuse):
    """Order 8 on the fast ring at K = t_fuse against the JAX package's
    packed_step (t_fuse 1) and packed_fused2 (t_fuse 2) ring, with a source
    and an odd first span (3 + 6 steps), and against the f64 oracle."""
    g, gj = _grids(24, 16, 32, hx=1.0, hy=1.0, hz=1.0, order=8)
    coords = np.array([[11.5, 7.5, 15.5]], np.float32)
    up, uc = _fast_ic(g, 8)
    m = np.full(g.padded_shape, 1.5, np.float32)
    src = tt.ricker_table(9, 1, 0.001)

    def spans(sim):
        st = sim.run(sim.prepare_state(up, uc), src[:3], 3)
        return sim.extract_state(sim.run(st, src[3:], 6))

    sim = tt.Simulator(g, tt.SimConfig(dt=0.001, ring="fast", t_fuse=t_fuse), m, coords,
                       device="cpu")
    assert sim.engine.sweep_k == t_fuse
    p, c = spans(sim)
    sim_j = tf.Simulator(gj, tf.SimConfig(dt=0.001, backend="pallas", ring="fast",
                                          t_fuse=t_fuse), m, coords)
    assert sim_j.engine.t_fuse == t_fuse and not sim_j.engine.sweep_k
    pj, cj = spans(sim_j)
    tp, tc = tt.oracle_run(up, uc, m, g, 0.001, 9, src=src, src_coords=coords,
                           dtype=np.float64)
    assert rel_l2(c, cj) < TOL and rel_l2(p, pj) < TOL
    assert rel_l2(c, tc) < TOL and rel_l2(p, tp) < TOL


def test_order8_deepest_k_correction_cubes():
    """Order 8 at its deepest K, k_max(4) = 2, with a source: the correction
    cubes spread R*(K-1) = 4 cells around the deposit."""
    k = stencil_sweep.k_max(4)
    assert k == 2
    g, _ = _grids(24, 24, 24, hx=1.0, hy=1.0, hz=1.0, order=8)
    coords = np.array([[11.3, 11.6, 12.2]], np.float32)
    _, _, (p, c), (tp, tc) = _run_fast(g, 7, coords, cfg_kw={"t_fuse": k}, expect_k=k)
    assert rel_l2(c, tc) < TOL and rel_l2(p, tp) < TOL


@pytest.mark.parametrize("order,t_fuse,kmax,shape,src_x", [
    (6, 3, 2, (24, 24, 32), 11.6), (6, 4, 2, (24, 24, 32), 11.6),
    (4, 6, 4, (16, 16, 128), None), (4, 5, 4, (24, 24, 32), 11.6)])
def test_explicit_depth_beyond_k_max_runs_at_k_max(order, t_fuse, kmax, shape, src_x):
    """F3: an explicit t_fuse deeper than kernel B's k_max runs its blocks at
    k_max, where the JAX package runs it (tests/test_sweep.py:458-465, and
    923-940: order 4 at t_fuse = 6 on 16 x 16 x 128, no source), within
    2e-6 of the f64 oracle; the correction cubes must fit at the depth
    asked for, R (t_fuse - 1) cells around the source."""
    g, gj = _grids(*shape, hx=1.0, hy=1.0, hz=1.0, order=order)
    m = np.full(g.padded_shape, 1.5, np.float32)
    coords = None if src_x is None else np.array([[src_x, 12.3, 15.1]], np.float32)
    sim_j = tf.Simulator(gj, tf.SimConfig(dt=0.001, backend="pallas", t_fuse=t_fuse), m, coords)
    assert sim_j.engine.sweep_k == t_fuse
    _, _, (p, c), (tp, tc) = _run_fast(g, 7, coords, cfg_kw={"t_fuse": t_fuse}, expect_k=kmax)
    assert rel_l2(c, tc) < TOL and rel_l2(p, tp) < TOL
    if coords is not None:
        # fits at K = k_max, not at the depth asked for
        near = np.array([[g.radius * (t_fuse - 1) - 0.5, 12.3, 15.1]], np.float32)
        tt.Simulator(g, tt.SimConfig(dt=0.001, t_fuse=kmax), m, near, device="cpu")
        with pytest.raises(ValueError, match="further inside"):
            tt.Simulator(g, tt.SimConfig(dt=0.001, t_fuse=t_fuse), m, near, device="cpu")


def test_explicit_depth_beyond_six_raises():
    g = tt.Grid3D(16, 16, 32, hx=1.0, hy=1.0, hz=1.0)
    m = np.full(g.padded_shape, 1.5, np.float32)
    with pytest.raises(ValueError, match="beyond the fused sweep"):
        tt.Simulator(g, tt.SimConfig(t_fuse=7), m, device="cpu")

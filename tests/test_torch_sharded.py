"""The sharded engines (tpufdtd_torch/parallel) on the CPU, shards on the
"cpu" device.

The per-step engine is held against the JAX package's simulate_sharded
with the jnp backend (its tests/test_sharded.py and tests/test_smoke.py
cases) at rel-L2 2e-6, the distance between independent f32
implementations of the same steps (DEVIATIONS.md:10-19), and against the
f64 oracle at the repo's gate, rel-L2 1e-4. The sharded sweep runs the
kernels' plain versions here: without sources it must be bitwise the
port's single-device Simulator at the same depth (the JAX package pins the
same, tests/test_sharded.py:164-201, 340-407); with a source that straddles
a shard cut and a remainder block, within 2e-6 of it and 1e-4 of the
oracle.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd_torch.harness import perf_sharded
from tpufdtd_torch.ops import stencil_sweep
from tpufdtd_torch.parallel import (
    ShardedSimulator,
    global_from_shards,
    make_mesh,
    shards_from_global,
    simulate_sharded,
)
from tpufdtd_torch.parallel import sharded_sweep
from conftest import make_correctness_ic, rel_l2

JAX_TOL = 2e-6
GATE = 1e-4
FUSED_TOL = 2e-6


def _mesh(n=4, shape=None):
    return make_mesh(shape=shape, devices=["cpu"] * n)


def _zero_rim_ic(g, seed=3):
    rng = np.random.default_rng(seed)
    h = g.halo
    out = []
    for _ in range(2):
        a = np.zeros(g.padded_shape, np.float32)
        a[h:-h, h:-h, h:-h] = rng.standard_normal((g.nx, g.ny, g.nz))
        out.append(a)
    return out


# ---- mesh -------------------------------------------------------------------


def test_make_mesh_raises_for_too_few_cards():
    """No silent collapse: shards without cards raise; an explicit device
    list may repeat a device."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA cards"):
        make_mesh(have + 1)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        make_mesh(shape=(have + 1, 2))
    mesh = make_mesh(devices=["cpu"] * 3)
    assert (mesh.ndx, mesh.ndy, mesh.size, mesh.cards, mesh.two_d) == (3, 1, 3, 1, False)
    mesh = make_mesh(shape=(2, 2), devices=["cpu"] * 4)
    assert (mesh.ndx, mesh.ndy, mesh.two_d, mesh.device(1, 1)) == (2, 2, True, torch.device("cpu"))
    with pytest.raises(ValueError):
        make_mesh(4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(devices=["cuda:0"] * 2)


def test_shards_roundtrip():
    g = tt.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    a = np.random.default_rng(0).random(g.padded_shape).astype(np.float32)
    assert np.array_equal(global_from_shards(g, 4, shards_from_global(g, 4, a)), a)


# ---- the per-step engine against the JAX package ------------------------------


def _jax_sharded(g, u_prev, u_cur, m, nsteps, ndev, src=None, coords=None):
    from tpufdtd.parallel import make_mesh as jax_mesh
    from tpufdtd.parallel import simulate_sharded as jax_simulate_sharded

    gj = tf.Grid3D(g.nx, g.ny, g.nz, hx=g.hx, hy=g.hy, hz=g.hz, order=g.order)
    cfg = tf.SimConfig(dt=0.001, nsteps=nsteps, backend="jnp")
    return jax_simulate_sharded(u_prev, u_cur, m, gj, cfg, jax_mesh(ndev), src=src,
                                src_coords=coords)


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_per_step_matches_jax_sharded_and_oracle(ndev, backend):
    g = tt.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m = make_correctness_ic(g)
    cfg = tt.SimConfig(dt=0.001, nsteps=12, backend=backend)
    sim = ShardedSimulator(g, cfg, m, _mesh(ndev))
    assert sim.sweep is None or backend == "cuda"
    state, m_sh, terms = sim.prepare(up, uc, m)
    assert not isinstance(state, dict)  # differing rims: the exact ring
    ring = sim.extract_state(sim.run(state, m_sh, terms, None, 12))
    ring_j = _jax_sharded(g, up, uc, m, 12, ndev)
    ring_t = tt.oracle_run_ring(up, uc, m, g, 0.001, 12, dtype=np.float64)
    assert len(ring) == len(ring_j) == 3
    for mine, jax_level, truth in zip(ring, ring_j, ring_t):
        assert rel_l2(mine, np.asarray(jax_level)) < JAX_TOL
        assert rel_l2(mine, truth) < GATE
    # the frozen global rim stays
    h = g.halo
    assert np.array_equal(ring[1][:h], ring_t[1][:h].astype(np.float32))


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("x,h", [(3.5, 1.0), (6.3, 1.0), (0.775, 0.1)])
def test_per_step_sources_match_jax_sharded_and_oracle(ndev, x, h):
    """x = 3.5 cells straddles the cut between shards 0 and 1 at 4 shards
    (and lies in shard 0 at 2), x = 7.75 cells the cut between shards 1 and
    2 at 4 shards and 0 and 1 at 2: its corners go to their owners with the
    global term's weights, so the run is bitwise the single-device one."""
    g = tt.Grid3D(16, 8, 8, hx=h, hy=h, hz=h)
    u0 = np.zeros(g.padded_shape, np.float32)
    m = np.full(g.padded_shape, 1.5, np.float32)
    src = np.ones((8, 1), np.float32)
    coords = np.array([[x, 4.0 * h, 4.0 * h]], np.float32)
    cfg = tt.SimConfig(dt=0.001, nsteps=8, ring="exact")
    ring = simulate_sharded(u0, u0, m, g, cfg, _mesh(ndev), src=src, src_coords=coords)
    ring_j = _jax_sharded(g, u0, u0, m, 8, ndev, src, coords)
    ring_t = tt.oracle_run_ring(u0, u0, m, g, 0.001, 8, src=src, src_coords=coords,
                                dtype=np.float64)
    ring_1 = tt.simulate_ring(u0, u0, m, g, cfg, src, coords, device="cpu")
    for mine, jax_level, truth, single in zip(ring, ring_j, ring_t, ring_1):
        assert rel_l2(mine, np.asarray(jax_level)) < JAX_TOL
        assert rel_l2(mine, truth) < GATE
        assert np.array_equal(mine, single)
    assert np.abs(ring[1]).max() > 0


def test_per_step_bf16_and_heterogeneous_medium():
    """bf16 storage (kernel A's bf16 mode) and a per-point m on the per-step
    engine: bitwise the single-device exact ring."""
    g = tt.Grid3D(16, 8, 12, hx=1.0, hy=1.0, hz=1.0)
    up, uc, _ = make_correctness_ic(g)
    rng = np.random.default_rng(2)
    m = (1.3 + 0.5 * rng.random(g.padded_shape)).astype(np.float32)
    for storage in ("float32", "bfloat16"):
        cfg = tt.SimConfig(dt=0.001, nsteps=6, storage_dtype=storage, ring="exact")
        ring = simulate_sharded(up, uc, m, g, cfg, _mesh(4))
        ring_1 = tt.simulate_ring(up, uc, m, g, cfg, device="cpu")
        for a, b in zip(ring, ring_1):
            assert np.array_equal(a, b)


# ---- the sharded sweep ---------------------------------------------------------


@pytest.mark.parametrize("shape", [None, (2, 2)])
@pytest.mark.parametrize("storage,hetero", [("float32", False), ("float32", True),
                                            ("bfloat16", False)])
def test_sweep_without_sources_is_bitwise_single_device(shape, storage, hetero):
    g = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    up, uc = _zero_rim_ic(g)
    m = np.full(g.padded_shape, 1.5, np.float32)
    if hetero:
        m = (1.3 + 0.5 * np.random.default_rng(3).random(g.padded_shape)).astype(np.float32)
    cfg = tt.SimConfig(dt=0.001, nsteps=9, storage_dtype=storage)
    sim = ShardedSimulator(g, cfg, m, _mesh(4, shape))
    assert sim.sweep is not None and sim.sweep.ndy == (2 if shape else 1)
    state, m_sh, terms = sim.prepare(up, uc, m)
    assert isinstance(state, dict)
    p, c = sim.extract_state(sim.run(state, m_sh, terms, None, 9))
    s1 = tt.Simulator(g, cfg, m, device="cpu")
    assert s1.engine.sweep_k == sim.sweep.K == 2
    p1, c1 = s1.extract_state(s1.run(s1.prepare_state(up, uc), None, 9))
    assert np.array_equal(c, c1) and np.array_equal(p, p1)
    _, oc = tt.oracle_run(up, uc, m, g, 0.001, 9, dtype=np.float64)
    assert rel_l2(c, oc) < (4e-2 if storage == "bfloat16" else GATE)
    h = g.halo
    assert np.array_equal(c[:h], uc[:h]) and np.array_equal(c[:, -h:], uc[:, -h:])


def test_sweep_at_depth_3_and_order_2():
    """An explicit t_fuse = 3 runs K = 3 (M = H at order 4); order 2 takes
    K_AUTO[1] = 3; both bitwise the single-device sweep."""
    for order, t_fuse in ((4, 3), (2, 0)):
        g = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0, order=order)
        up, uc = _zero_rim_ic(g, 4)
        m = np.full(g.padded_shape, 1.5, np.float32)
        cfg = tt.SimConfig(dt=0.001, nsteps=10, t_fuse=t_fuse)
        sim = ShardedSimulator(g, cfg, m, _mesh(4, (2, 2)))
        assert sim.sweep.K == 3 and sim.sweep.M == (3 - 1) * g.radius
        state, m_sh, terms = sim.prepare(up, uc, m)
        p, c = sim.extract_state(sim.run(state, m_sh, terms, None, 10))
        s1 = tt.Simulator(g, dataclasses.replace(cfg, t_fuse=3), m, device="cpu")
        p1, c1 = s1.extract_state(s1.run(s1.prepare_state(up, uc), None, 10))
        assert np.array_equal(c, c1) and np.array_equal(p, p1)


@pytest.mark.parametrize("shape", [None, (2, 2)])
@pytest.mark.parametrize("storage,hetero", [("float32", False), ("float32", True),
                                            ("bfloat16", False)])
def test_sweep_straddling_sources_and_remainders(shape, storage, hetero):
    """Sources whose corners and correction cubes straddle the x cut at 8
    (and the y cut at 8 on the 2x2 mesh); 11 and 10 steps end on a K = 1
    remainder block or none."""
    g = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    u0 = np.zeros(g.padded_shape, np.float32)
    m = np.full(g.padded_shape, 1.5, np.float32)
    if hetero:
        m = (1.3 + 0.5 * np.random.default_rng(5).random(g.padded_shape)).astype(np.float32)
    coords = np.array([[7.5, 7.6, 8.0], [16.2, 7.7, 9.1]], np.float32)
    for nsteps in (11, 10):
        src = tt.ricker_table(nsteps, 2, 0.001)
        cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, storage_dtype=storage)
        sim = ShardedSimulator(g, cfg, m, _mesh(4, shape), src_coords=coords)
        assert sim.sweep is not None
        owners = {(e[0], e[1]) for e in _entry_shards(sim.sweep)}
        assert len(owners) >= (4 if shape else 2)
        state, m_sh, terms = sim.prepare(u0, u0, m)
        p, c = sim.extract_state(sim.run(state, m_sh, terms, src, nsteps))
        s1 = tt.Simulator(g, cfg, m, coords, device="cpu")
        p1, c1 = s1.extract_state(s1.run(s1.prepare_state(u0, u0), src, nsteps))
        assert rel_l2(c, c1) < FUSED_TOL and rel_l2(p, p1) < FUSED_TOL
        if storage == "float32":
            op, oc = tt.oracle_run(u0, u0, m, g, 0.001, nsteps, src=src, src_coords=coords,
                                   dtype=np.float64)
            assert rel_l2(c, oc) < GATE and rel_l2(p, op) < GATE
        assert np.abs(c).max() > 0


@pytest.mark.parametrize("shape,nx,nsteps", [(None, 32, 5), ((2, 2), 16, 4)])
def test_sweep_matches_jax_sharded_sweep(shape, nx, nsteps):
    """The sharded sweep against the JAX package's (backend 'pallas', its
    sweep in interpret mode on the virtual CPU devices) at K = 3: exchanges,
    freeze cases, the correction's entry split over shards and the last
    block (K = 2 after 5 steps, K = 1 after 4) on a 4-shard and a 2x2 mesh,
    with sources whose corners and cubes straddle the cuts."""
    from tpufdtd.parallel import ShardedSimulator as JaxShardedSimulator
    from tpufdtd.parallel import make_mesh as jax_mesh

    g = tt.Grid3D(nx, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    u0 = np.zeros(g.padded_shape, np.float32)
    m = np.full(g.padded_shape, 1.5, np.float32)
    coords = np.array([[7.5, 7.6, 8.0], [9.3, 9.4, 7.2]], np.float32)
    src = tt.ricker_table(nsteps, 2, 0.001)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, t_fuse=3)
    sim = ShardedSimulator(g, cfg, m, _mesh(4, shape), src_coords=coords)
    assert sim.sweep is not None and sim.sweep.K == 3
    assert len(_entry_shards(sim.sweep)) >= (4 if shape else 2)
    state, m_sh, terms = sim.prepare(u0, u0, m)
    p, c = sim.extract_state(sim.run(state, m_sh, terms, src, nsteps))
    gj = tf.Grid3D(nx, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    cfg_j = tf.SimConfig(dt=0.001, nsteps=nsteps, backend="pallas", t_fuse=3)
    sim_j = JaxShardedSimulator(gj, cfg_j, m, jax_mesh(shape=shape) if shape else jax_mesh(4),
                                src_coords=coords)
    assert sim_j.sweep is not None and sim_j.sweep.K == 3
    st_j, ms_j, pk_j = sim_j.prepare(u0, u0, m)
    p_j, c_j = (np.asarray(a) for a in sim_j.extract_state(sim_j.run(st_j, ms_j, pk_j, src,
                                                                      nsteps)))
    assert np.abs(c).max() > 0
    assert rel_l2(c, c_j) < FUSED_TOL and rel_l2(p, p_j) < FUSED_TOL


def _entry_shards(sweep):
    return [(dx, dy) for dx in range(sweep.ndx) for dy in range(sweep.ndy)
            if sweep.entries[dx][dy] is not None]


def test_sweep_freeze_cases():
    """Per shard (frozen_lo, frozen_hi, frozen_ylo, frozen_yhi): interior
    shards freeze nothing, edges their margin, a one-shard axis both ends
    (the JAX package's kern cases)."""
    g = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    m = np.full(g.padded_shape, 1.5, np.float32)
    cfg = tt.SimConfig(dt=0.001, t_fuse=3)
    sw = ShardedSimulator(g, cfg, m, _mesh(4)).sweep
    assert [sw.frozen(d, 0) for d in range(4)] == [(4, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0),
                                                   (0, 4, 0, 0)]
    g = tt.Grid3D(32, 24, 16, hx=1.0, hy=1.0, hz=1.0)
    m = np.full(g.padded_shape, 1.5, np.float32)
    sw = ShardedSimulator(g, cfg, m, _mesh(3, (1, 3))).sweep
    assert [sw.frozen(0, d) for d in range(3)] == [(4, 4, 4, 0), (4, 4, 0, 0), (4, 4, 0, 4)]


def test_ineligible_configurations_take_the_per_step_engine():
    """As tests/test_sharded.py:225-251: nxl < K*R falls back to the
    per-step engine, nxl = 4 degrades K, differing rims give the per-step
    state; order 6 exceeds the sweep's radius 2."""
    g = tt.Grid3D(8, 8, 8, hx=1.0, hy=1.0, hz=1.0)  # nxl = 2 < K*R for every K >= 2
    up, uc, m = make_correctness_ic(g)
    cfg = tt.SimConfig(dt=0.001, nsteps=6, t_fuse=3)
    assert ShardedSimulator(g, cfg, m, _mesh(4)).sweep is None
    g1 = tt.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)  # nxl = 4: K = 2
    _, uc1, m1 = make_correctness_ic(g1)
    sim1 = ShardedSimulator(g1, cfg, m1, _mesh(4))
    assert sim1.sweep is not None and sim1.sweep.K == 2
    st, ms, tm = sim1.prepare(uc1, uc1, m1)
    _, c = sim1.extract_state(sim1.run(st, ms, tm, None, 6))
    _, oc = tt.oracle_run(uc1, uc1, m1, g1, 0.001, 6, dtype=np.float64)
    assert rel_l2(c, oc) < 1e-5
    g2 = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    up2, uc2, m2 = make_correctness_ic(g2)  # u_prev's rims (0) differ from u_cur's
    sim2 = ShardedSimulator(g2, cfg, m2, _mesh(4))
    assert sim2.sweep is not None
    assert not isinstance(sim2.prepare(up2, uc2, m2)[0], dict)
    g6 = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0, order=6)
    m6 = np.full(g6.padded_shape, 1.5, np.float32)
    assert ShardedSimulator(g6, tt.SimConfig(), m6, _mesh(4)).sweep is None
    for kw in ({"t_fuse": 1}, {"t_fuse": 2}, {"ring": "exact"}, {"backend": "torch"}):
        assert ShardedSimulator(g2, tt.SimConfig(**kw), m2, _mesh(4)).sweep is None


def test_two_d_mesh_requires_the_sweep():
    """As tests/test_sharded.py:409-420: a 2-D mesh has no per-step
    fallback; an ineligible configuration raises, and so do differing rims."""
    g = tt.Grid3D(32, 32, 16, hx=1.0, hy=1.0, hz=1.0, order=6)
    m = np.full(g.padded_shape, 1.5, np.float32)
    with pytest.raises(ValueError, match="2-D mesh"):
        ShardedSimulator(g, tt.SimConfig(), m, _mesh(8, (4, 2)))
    g4 = tt.Grid3D(32, 32, 16, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m4 = make_correctness_ic(g4)
    sim = ShardedSimulator(g4, tt.SimConfig(), m4, _mesh(8, (4, 2)))
    with pytest.raises(ValueError, match="identical rims"):
        sim.prepare(up, uc, m4)


def test_sharded_depth_follows_the_mode():
    """Auto depth: K_AUTO for f32 with a scalar m, MODE_K for the w and bf16
    modes, capped at 3 and by M <= H; an explicit t_fuse >= 3 asks for
    min(t_fuse, 3)."""
    g = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    m = np.full(g.padded_shape, 1.5, np.float32)
    cases = {(0, "float32"): 2, (0, "bfloat16"): 2, (3, "float32"): 3, (6, "float32"): 3,
             (5, "bfloat16"): 3}
    for (t_fuse, storage), k in cases.items():
        cfg = tt.SimConfig(t_fuse=t_fuse, storage_dtype=storage)
        assert ShardedSimulator(g, cfg, m, _mesh(4)).sweep.K == k
    assert sharded_sweep.K_SHARDED_MAX == 3 <= stencil_sweep.k_max(2)


@pytest.mark.parametrize("order,storage,layered,k", [
    (2, "float32", False, 3), (4, "float32", False, 2), (2, "bfloat16", False, 2),
    (4, "bfloat16", False, 2), (2, "float32", True, 2), (4, "float32", True, 2)])
def test_sharded_auto_depth_is_pinned(order, storage, layered, k):
    """The sharded sweep's auto depth per (radius, mode) stays the register
    form's (K_AUTO_SHARDED, MODE_K) whatever stepper.K_AUTO takes: the
    single-device auto depth at order 2 is the deep form's K = 6."""
    from tpufdtd_torch import stepper

    g = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0, order=order)
    m = np.full(g.padded_shape, 1.5, np.float32)
    if layered:
        m[g.padded_shape[0] // 2:] = 2.0
    cfg = tt.SimConfig(storage_dtype=storage)
    assert ShardedSimulator(g, cfg, m, _mesh(4)).sweep.K == k
    assert sharded_sweep.K_AUTO_SHARDED == {1: 3, 2: 2} and stepper.K_AUTO[1] == 6


# ---- the benchmark rows ---------------------------------------------------------


def test_sharded_csv_rows_and_cpu_refusal(tmp_path):
    """26 columns (the reference's 24, Devices, Scaling_Eff(%)), a blank
    scaling cell; timing a mesh that is not on CUDA cards raises."""
    assert perf_sharded.SHARDED_HEADER.split(",")[-2:] == ["Devices", "Scaling_Eff(%)"]
    path = str(tmp_path / "s.csv")
    row = ["cuda-sharded@1card"] + [1.0] * 17 + [512, 512, 512, 50, 1, 4, 4, None]
    perf_sharded.append_sharded_row(path, row)
    lines = open(path).read().splitlines()
    assert lines[0] == perf_sharded.SHARDED_HEADER and lines[1].endswith(",4,")
    assert len(lines[1].split(",")) == 26
    with pytest.raises(ValueError):
        perf_sharded.append_sharded_row(path, row[:-1])
    g = tt.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    sim = ShardedSimulator(g, tt.SimConfig(), np.full(g.padded_shape, 1.5, np.float32),
                           _mesh(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        perf_sharded.timed_span(sim, lambda: None)
    with pytest.raises(RuntimeError):
        perf_sharded.run_sharded_benchmark(2, grids=(16,), devices=["cpu", "cpu"], csv_path=None)

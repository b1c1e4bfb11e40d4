"""Checkpoint and resume on the port (tpufdtd_torch.checkpoint), single device
and sharded, on the CPU, held against the JAX package's tpufdtd.checkpoint.

The file format is the JAX package's, key for key and dtype for dtype, so a
file written by either package loads and resumes in the other. A run
checkpointed at a block boundary and resumed is bitwise the unbroken run
(the ring carries the whole state; f32 round-trips exactly). Between the
packages the tolerance is rel-L2 <= 1e-6: two f32 implementations of the
same exact-ring steps differ by association only (DEVIATIONS.md:10-19).
Sharded runs with a source resumed on another mesh are within 1e-6 of the
unbroken run: the correction's adds group differently across a block
boundary that moved (the JAX package's test_sharded.py:545-560 bound).
"""

import numpy as np
import pytest

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd import checkpoint as jck
from tpufdtd_torch import checkpoint as ck
from tpufdtd_torch.parallel import ShardedSimulator, make_mesh
from conftest import make_correctness_ic, rel_l2

JAX_TOL = 1e-6
SOURCED_TOL = 1e-6
KEYS = {"step", "u_prev", "u_cur", "u_target", "grid", "geom"}


def _zero_rim_ic(g, seed=3):
    rng = np.random.default_rng(seed)
    h = g.halo
    out = []
    for _ in range(2):
        a = np.zeros(g.padded_shape, np.float32)
        a[h:-h, h:-h, h:-h] = rng.standard_normal((g.nx, g.ny, g.nz))
        out.append(a)
    return out


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_checkpoint_roundtrip(tmp_path):
    g = tt.Grid3D(12, 10, 8, hx=1.0, hy=0.5, hz=0.25, ox=1.0, order=6)
    up, uc, _ = make_correctness_ic(g)
    for target in (up, None):
        p = str(tmp_path / "c.npz")
        ck.save(p, ck.Checkpoint(7, up, uc, target, g, 1e-3))
        got = ck.load(p)
        assert got.step == 7 and got.grid == g and got.dt == 1e-3
        assert np.array_equal(got.u_prev, up) and np.array_equal(got.u_cur, uc)
        assert (got.u_target is None) == (target is None)
        if target is not None:
            assert np.array_equal(got.u_target, target)


@pytest.mark.parametrize("with_target", [True, False])
def test_format_is_the_jax_packages_both_ways(tmp_path, with_target):
    """The same checkpoint written by each package: the same keys, dtypes,
    shapes and values; each package's load reads the other's file."""
    gj = tf.Grid3D(12, 10, 8, hx=1.0, hy=0.5, hz=0.25, oz=2.0)
    g = tt.Grid3D.from_fields(gj)
    up, uc, _ = make_correctness_ic(g)
    ut = up + 1 if with_target else None
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jck.save(pj, jck.Checkpoint(5, up, uc, ut, gj, 2e-3))
    ck.save(pt, ck.Checkpoint(5, up, uc, ut, g, 2e-3))
    zj, zt = _npz(pj), _npz(pt)
    assert set(zj) == set(zt) == KEYS
    for k in KEYS:
        assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape, k
        assert np.array_equal(zj[k], zt[k]), k
    assert zt["grid"].dtype == np.int64 and zt["geom"].dtype == np.float64
    assert zt["u_cur"].dtype == np.float32 and zt["u_target"].dtype == np.float32
    a, b = ck.load(pj), jck.load(pt)
    assert a.grid == g and tt.Grid3D.from_fields(b.grid) == g
    for x, y in ((a, b), (a, ck.load(pt)), (b, jck.load(pj))):
        assert (x.step, x.dt) == (y.step, y.dt)
        assert np.array_equal(x.u_prev, y.u_prev) and np.array_equal(x.u_cur, y.u_cur)
        assert (x.u_target is None) == (y.u_target is None) == (not with_target)


@pytest.mark.parametrize("ring", ["auto", "exact"])
def test_checkpointed_run_equals_unbroken(tmp_path, ring):
    """Checkpoints every 4 of 12 steps (a multiple of the fast ring's K = 2)
    with a source by absolute step: bitwise the unbroken run, on the fast
    ring (two levels) and the exact ring."""
    g = tt.Grid3D(16, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    m = np.full(g.padded_shape, 1.5, np.float32)
    u0 = np.zeros(g.padded_shape, np.float32)
    nsteps = 12
    src = tt.ricker_table(nsteps, 1, 0.001)
    coords = tt.default_source_coords(1, 16, 16, 16, h=1.0)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, ring=ring)
    sim = tt.Simulator(g, cfg, m, coords, device="cpu")
    fmt = str(tmp_path / "ck_{step:06d}.npz")
    P1, C1 = ck.run_with_checkpoints(sim, u0, u0, nsteps, src=src, checkpoint_every=4,
                                     path_fmt=fmt)
    ref = sim.extract_state(sim.run(sim.prepare_state(u0, u0), src, nsteps))
    assert np.array_equal(C1, ref[1]) and np.array_equal(P1, ref[0])
    mid = ck.load(fmt.format(step=8))
    assert (mid.u_target is None) == (ring == "auto")
    P2, C2 = ck.resume(fmt.format(step=4), cfg, m, nsteps, src=src, src_coords=coords,
                       device="cpu")
    assert np.array_equal(C2, ref[1]) and np.array_equal(P2, ref[0])
    assert not (tmp_path / "ck_000012.npz").exists()


def test_resume_a_jax_checkpoint_matches_jax_resume(tmp_path):
    """A checkpoint the JAX package wrote mid-run (exact ring, three levels)
    resumes on the port as in the JAX package, with a source by absolute
    step, and a port checkpoint resumes in the JAX package."""
    gj = tf.Grid3D(16, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    up0, uc0, m = make_correctness_ic(gj)
    coords = tf.default_source_coords(1, 16, 16, 16, h=1.0)
    src = tf.ricker_table(12, 1, 0.001)
    cfg_j = tf.SimConfig(dt=0.001, nsteps=6, backend="jnp", ring="exact")
    sim = tf.Simulator(gj, cfg_j, m, coords)
    lv = sim.extract_state(sim.run(sim.prepare_state(up0, uc0), src[:6], 6))
    p = str(tmp_path / "mid.npz")
    jck.save(p, jck.Checkpoint(6, lv[0], lv[1], lv[2], gj, 0.001))
    Pj, Cj = jck.resume(p, cfg_j, m, 12, src=src, src_coords=coords)
    Pt, Ct = ck.resume(p, tt.SimConfig(dt=0.001, nsteps=6), m, 12, src=src, src_coords=coords,
                       device="cpu")
    assert rel_l2(Ct, Cj) <= JAX_TOL and rel_l2(Pt, Pj) <= JAX_TOL
    truth = tf.oracle_run_ring(up0, uc0, m, gj, 0.001, 12, src=src, src_coords=coords,
                               dtype=np.float64)
    assert rel_l2(Ct, truth[1]) < 1e-4
    # the other way: the port's checkpoint of the same run into JAX's resume
    gt = tt.Grid3D.from_fields(gj)
    simt = tt.Simulator(gt, tt.SimConfig(dt=0.001, nsteps=6, ring="exact"), m, coords,
                        device="cpu")
    lt = simt.extract_state(simt.run(simt.prepare_state(up0, uc0), src[:6], 6))
    pt = str(tmp_path / "mid_torch.npz")
    ck.save(pt, ck.Checkpoint(6, *lt, gt, 0.001))
    Pj2, Cj2 = jck.resume(pt, cfg_j, m, 12, src=src, src_coords=coords)
    assert rel_l2(Cj2, Cj) <= JAX_TOL and rel_l2(Pj2, Pj) <= JAX_TOL


def _cpu_mesh(shape=None):
    return make_mesh(shape=shape, devices=["cpu"] * 4)


@pytest.mark.parametrize("sourced", [False, True])
def test_sharded_checkpoint_resumes_on_any_mesh(tmp_path, sourced):
    """The sharded sweep over 4 x-shards checkpointed at step 4 (a block
    boundary), resumed on a fresh 4-shard mesh, a 2 x 2 mesh and one
    device: bitwise the unbroken 4-shard run without sources (f32 steps of
    the same depth are bitwise across shard cuts), within SOURCED_TOL with
    a source that straddles shards (tests/test_sharded.py:500-560)."""
    g = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    up, uc = _zero_rim_ic(g)
    m = np.full(g.padded_shape, 1.5, np.float32)
    nsteps = 9
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps)
    src = coords = None
    if sourced:
        src = tt.ricker_table(nsteps, 1, cfg.dt)
        coords = np.array([[16.0, 8.0, 8.0]], np.float32)
    sim = ShardedSimulator(g, cfg, m, _cpu_mesh(), src_coords=coords)
    st, ms, pk = sim.prepare(up, uc, m)
    assert isinstance(st, dict)
    P0, C0 = sim.extract_state(sim.run(st, ms, pk, src, nsteps))

    fmt = str(tmp_path / "ck_{step:06d}.npz")
    sim_a = ShardedSimulator(g, cfg, m, _cpu_mesh(), src_coords=coords)
    Pa, Ca = ck.run_sharded_with_checkpoints(sim_a, up, uc, m, nsteps, src=src,
                                             checkpoint_every=4, path_fmt=fmt)
    assert np.array_equal(Ca, C0) and np.array_equal(Pa, P0)
    path = fmt.format(step=4)
    assert ck.load(path).u_target is None
    results = [ck.resume_sharded(path, cfg, m, _cpu_mesh(shape), nsteps, src=src,
                                 src_coords=coords) for shape in (None, (2, 2))]
    results.append(ck.resume(path, cfg, m, nsteps, src=src, src_coords=coords, device="cpu"))
    for P, C in results:
        if sourced:
            assert rel_l2(C, C0) < SOURCED_TOL and rel_l2(P, P0) < SOURCED_TOL
        else:
            assert np.array_equal(C, C0) and np.array_equal(P, P0)
    # the same checkpoint written by the JAX package resumes over the mesh alike
    mid = ck.load(path)
    pj = str(tmp_path / "jax.npz")
    jck.save(pj, jck.Checkpoint(mid.step, mid.u_prev, mid.u_cur, None,
                                tf.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0), mid.dt))
    P, C = ck.resume_sharded(pj, cfg, m, _cpu_mesh(), nsteps, src=src, src_coords=coords)
    assert np.array_equal(C, results[0][1]) and np.array_equal(P, results[0][0])

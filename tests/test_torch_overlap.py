"""The sharded sweep's exchange/compute overlap (parallel/sharded_sweep.py,
the JAX package's kern_overlap) on the CPU, shards on the "cpu" device,
where the three slabs run in their order without streams.

overlap="on" must be bitwise overlap="off", sources included
(tests/test_sharded.py:422), and the interior slab must read nothing the x
exchange writes (tests/test_sharded.py:453). Against the JAX package: the
JAX sharded sweep with and without its overlap is pinned bitwise by that
test, and running it here would take its Pallas kernel in interpret mode
(~45 s a case); so the port's overlap run is held to the JAX package's
sharded per-step run (jnp backend) on the same inputs, at 2e-6 rel-L2, the
distance between fused and step-by-step f32 runs (DEVIATIONS.md:31-35), and
to the f64 oracle at the repo's gate, 1e-4.
"""

import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd_torch.harness.media import layered
from tpufdtd_torch.ops import stencil_sweep
from tpufdtd_torch.parallel import ShardedSimulator, make_mesh
from conftest import make_correctness_ic, rel_l2

FUSED_TOL = 2e-6
GATE = 1e-4
GRID = dict(nx=96, ny=16, nz=16, hx=1.0, hy=1.0, hz=1.0)
COORDS = np.array([[48.3, 8.0, 8.0]], np.float32)  # straddles the cut of shards 1 | 2
NSTEPS = 7  # three K = 2 blocks and a K = 1 block


def _run(overlap, shape=None, storage="float32", hetero=False, nsteps=NSTEPS, coords=COORDS):
    g = tt.Grid3D(**GRID)
    _, uc0, m = make_correctness_ic(g)
    if hetero:
        m = layered(g)
    src = tt.ricker_table(nsteps, 1, 0.001) if coords is not None else None
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, overlap=overlap, storage_dtype=storage)
    sim = ShardedSimulator(g, cfg, m, make_mesh(shape=shape, devices=["cpu"] * 4),
                           src_coords=coords)
    st, ms, pk = sim.prepare(uc0, uc0, m)
    stencil_sweep.reset_counts()
    st = sim.run(st, ms, pk, src, nsteps)
    return sim, sim.extract_state(st), stencil_sweep.launches("plain")


@pytest.mark.parametrize("shape,storage,hetero", [(None, "float32", False),
                                                  ((2, 2), "float32", False),
                                                  (None, "float32", True),
                                                  (None, "bfloat16", False)])
def test_overlap_on_is_bitwise_off(shape, storage, hetero):
    """f32 with a straddling source on 4 x 1 and 2 x 2 meshes, the w mode
    and bf16: u_{N-1} and u_N bit for bit; the overlap ran three slabs a
    shard per full block."""
    sim_on, on, n_on = _run("on", shape, storage, hetero)
    sim_off, off, n_off = _run("off", shape, storage, hetero)
    sw = sim_on.sweep
    assert sw.overlap and not sim_off.sweep.overlap
    assert sw.lgrid.nx - 2 * sw.E >= 8
    full, rem = divmod(NSTEPS, sw.K)
    assert n_off == (full + rem) * sw.ndx * sw.ndy
    assert n_on == (3 * full + rem) * sw.ndx * sw.ndy
    assert all(np.array_equal(a, b) for a, b in zip(on, off))
    assert np.abs(on[1]).max() > 0


def test_overlap_eligibility_and_auto():
    """As in the JAX package: off, one x-shard, or an interior slab under 8
    planes runs the serial order; "auto" keeps it where the shards share a
    device (the "cpu" mesh here) and "on" takes the overlap."""
    g = tt.Grid3D(**GRID)
    m = np.full(g.padded_shape, 1.5, np.float32)

    def sweep(overlap, shape=None, nx=96):
        grid = tt.Grid3D(**{**GRID, "nx": nx})
        mm = np.full(grid.padded_shape, 1.5, np.float32)
        return ShardedSimulator(grid, tt.SimConfig(overlap=overlap), mm,
                                make_mesh(shape=shape, devices=["cpu"] * 4)).sweep

    assert sweep("on").overlap and not sweep("auto").overlap and not sweep("off").overlap
    assert not sweep("on", shape=(1, 4)).overlap  # one x-shard
    # nx = 64: 16 planes a shard, nxk = 20, E = 6: 20 - 12 = 8 planes, eligible;
    # nx = 56: 14 + 4 - 12 = 6 < 8
    assert sweep("on", nx=64).overlap and not sweep("on", nx=56).overlap
    with pytest.raises(ValueError, match="overlap"):
        ShardedSimulator(g, tt.SimConfig(overlap="maybe"), m,
                         make_mesh(devices=["cpu"] * 4))


def test_interior_slab_does_not_read_the_exchange(monkeypatch):
    """The planes the x exchange writes hold NaN before the block, and the
    exchange itself delivers NaN: the interior slabs, which run first,
    still give their true regions [E, nxk - E) bit for bit the clean serial
    run's, while the poison reaches the edge slabs."""
    g = tt.Grid3D(**GRID)
    _, C_clean = _run("off", nsteps=2, coords=None)[1]
    _, uc0, m = make_correctness_ic(g)
    sim = ShardedSimulator(g, tt.SimConfig(dt=0.001, nsteps=2, overlap="on"), m,
                           make_mesh(devices=["cpu"] * 4))
    sw = sim.sweep
    h, R, M, D, nxk = sw.h, sw.R, sw.M, sw.K * sw.R, sw.lgrid.nx

    def poison(Us):  # every plane _exchange_x writes, set to NaN
        for dx in range(sw.ndx - 1):
            Us[dx + 1][0][:, h - R: h - R + D] = float("nan")
            Us[dx][0][:, h + nxk - M: h + nxk - M + D] = float("nan")

    st, ms, pk = sim.prepare(uc0, uc0, m)
    poison([[col[0][0]] for col in st["sweep"]])
    # the interior slab's view holds poisoned planes: the test has teeth
    assert torch.isnan(st["sweep"][1][0][0][:, sw.E - M: sw.E - M + 2 * h]).any()
    monkeypatch.setattr(sw, "_exchange_x", poison)
    _, C = sim.extract_state(sim.run(st, ms, pk, None, 2))
    nxl = g.nx // 4
    for i in range(4):
        lo, hi = h + i * nxl + sw.E - M, h + i * nxl + nxl - (sw.E - M)
        assert np.array_equal(C[lo:hi], C_clean[lo:hi]), i
    assert np.isnan(C).any()


def test_overlap_matches_the_jax_sharded_run_and_oracle():
    from tpufdtd.parallel import make_mesh as jax_mesh
    from tpufdtd.parallel import simulate_sharded as jax_simulate_sharded

    g = tt.Grid3D(**GRID)
    gj = tf.Grid3D(**GRID)
    _, uc0, m = make_correctness_ic(g)
    src = tt.ricker_table(NSTEPS, 1, 0.001)
    _, (_, C), _ = _run("on")
    jring = jax_simulate_sharded(uc0, uc0, m, gj, tf.SimConfig(dt=0.001, nsteps=NSTEPS,
                                                                backend="jnp"),
                                 jax_mesh(4), src=src, src_coords=COORDS)
    _, truth = tf.oracle_run(uc0, uc0, m, gj, 0.001, NSTEPS, src=src, src_coords=COORDS,
                             dtype=np.float64)
    assert rel_l2(C, np.asarray(jring[1])) < FUSED_TOL
    assert rel_l2(C, truth) < GATE

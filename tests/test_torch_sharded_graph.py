"""The sharded engines' captured spans (parallel/sharded.py, graphs.py) on
the CPU, shards on the "cpu" device.

A graph is captured only on a card; here the parts that decide what it
records and how it is found run on the CPU:
  * the route: CPU meshes and the "torch" backend stay eager (`graphs` is
    None), and meshes over several cards take the eager route by rule
    (`sharded.graphed`); the eager runs still agree with the JAX sharded
    run at 2e-6 rel-L2, as tests/test_torch_sharded.py holds them;
  * the loop a graph records (`_enqueue`) reads no host array: the source
    rows are staged before it, and the loop on staged tables is bitwise
    `run`;
  * a span's key changes with everything the graph records, and the roles
    a replay returns are those the eager loop leaves its buffers in.
"""

import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd_torch import graphs
from tpufdtd_torch.parallel import Mesh, ShardedSimulator, make_mesh, sharded, sharded_sweep
from conftest import make_correctness_ic, rel_l2

JAX_TOL = 2e-6


def _mesh(n=4, shape=None):
    return make_mesh(shape=shape, devices=["cpu"] * n)


def _sources(g, nsrc=1):
    """Coordinates whose corners and correction cubes straddle the x cut at
    8 (and the y cut at 8 on a 2 x 2 mesh of a 32 x 16 grid)."""
    return np.array([[7.5, 7.6, 8.0], [16.2, 7.7, 9.1]][:nsrc], np.float32) * g.hx


def _jax_ring(g, up, uc, m, nsteps, src, coords):
    from tpufdtd.parallel import make_mesh as jax_mesh
    from tpufdtd.parallel import simulate_sharded as jax_simulate_sharded

    gj = tf.Grid3D(g.nx, g.ny, g.nz, hx=g.hx, hy=g.hy, hz=g.hz, order=g.order)
    cfg = tf.SimConfig(dt=0.001, nsteps=nsteps, backend="jnp")
    return [np.asarray(a) for a in jax_simulate_sharded(up, uc, m, gj, cfg, jax_mesh(4), src=src,
                                                        src_coords=coords)]


# ---- (a) the eager route --------------------------------------------------------


@pytest.mark.parametrize("backend,engine,shape", [
    ("cuda", "per-step", None), ("torch", "per-step", None), ("cuda", "sweep", None),
    ("cuda", "sweep", (2, 2))])
def test_cpu_meshes_and_the_torch_backend_stay_eager(backend, engine, shape):
    """graphs is None, and the run with a straddling source agrees with the
    JAX package's sharded run (jnp backend, 4 x-shards) at 2e-6."""
    g = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m = make_correctness_ic(g)
    if engine == "sweep":
        up = uc  # identical rims: the sharded sweep
    coords = _sources(g, 2)
    src = tt.ricker_table(7, 2, 0.001)
    sim = ShardedSimulator(g, tt.SimConfig(dt=0.001, nsteps=7, backend=backend), m,
                           _mesh(4, shape), src_coords=coords)
    assert sim.graphs is None
    state, m_sh, terms = sim.prepare(up, uc, m)
    assert isinstance(state, dict) == (engine == "sweep")
    ring = sim.extract_state(sim.run(state, m_sh, terms, src, 7))
    ring_j = _jax_ring(g, up, uc, m, 7, src, coords)
    for mine, theirs in zip(ring, ring_j):
        assert rel_l2(mine, theirs) < JAX_TOL
    assert np.abs(ring[1]).max() > 0


def test_graph_route_rule():
    """Graphs on the "cuda" backend where every shard lives on one card
    (which need not be the current one); eager on "torch", on CPU meshes and
    on meshes over several cards, whatever the mesh's shape."""
    cfg, torch_cfg = tt.SimConfig(), tt.SimConfig(backend="torch")
    one = Mesh(4, 1, (torch.device("cuda", 1),) * 4)
    square = Mesh(2, 2, (torch.device("cuda", 0),) * 4, two_d=True)
    spread = Mesh(4, 1, tuple(torch.device("cuda", i) for i in range(4)))
    pair = Mesh(2, 2, (torch.device("cuda", 0),) * 2 + (torch.device("cuda", 1),) * 2,
                two_d=True)
    assert sharded.graphed(one, cfg) and sharded.graphed(square, cfg)
    assert not sharded.graphed(one, torch_cfg)
    assert not sharded.graphed(spread, cfg) and not sharded.graphed(pair, cfg)
    assert not sharded.graphed(_mesh(4), cfg) and not sharded.graphed(_mesh(4, (2, 2)), cfg)


# ---- (b) the enqueue reads no host array -----------------------------------------


class HostArray(RuntimeError):
    pass


def _no_host_arrays(monkeypatch):
    """torch.as_tensor, torch.from_numpy and np.asarray raise, as the two
    sharded modules see them."""
    def refuse(*args, **kwargs):
        raise HostArray("a host array in the enqueue")

    for mod in (sharded, sharded_sweep):
        monkeypatch.setattr(mod.torch, "as_tensor", refuse)
        monkeypatch.setattr(mod.torch, "from_numpy", refuse)
        monkeypatch.setattr(mod.np, "asarray", refuse)


ENQUEUE_CASES = {  # name -> (engine, mesh shape, overlap, nsteps)
    "sweep x4": ("sweep", None, "off", 8),
    "sweep 2x2": ("sweep", (2, 2), "off", 8),
    "sweep x4 overlap on": ("sweep", None, "on", 8),
    "sweep x4 remainder block": ("sweep", None, "off", 7),
    "per-step with a source": ("per-step", None, "off", 7),
}


@pytest.mark.parametrize("case", list(ENQUEUE_CASES))
def test_enqueue_touches_no_host_array(case, monkeypatch):
    """The span's staging copies the source rows; the loop it returns runs
    with host-array constructors refused and is bitwise `run` on a copy of
    the state. `run` itself stages, so it is refused under the same patch."""
    engine, shape, overlap, nsteps = ENQUEUE_CASES[case]
    g = tt.Grid3D(64 if overlap == "on" else 32, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m = make_correctness_ic(g)
    if engine == "sweep":
        up = uc
    src = tt.ricker_table(nsteps, 2, 0.001)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, overlap=overlap)
    sim = ShardedSimulator(g, cfg, m, _mesh(4, shape), src_coords=_sources(g, 2))
    state, m_sh, terms = sim.prepare(up, uc, m)
    assert isinstance(state, dict) == (engine == "sweep")
    if engine == "sweep":
        assert sim.sweep.overlap == (overlap == "on") and sim.sweep.entries is not None
    else:
        assert terms is not None
    want = sim.extract_state(sim.run(graphs.copy_state(state), m_sh, terms, src, nsteps))
    go = sim._span(state, m_sh, terms, src, nsteps)
    with monkeypatch.context() as patch:
        _no_host_arrays(patch)
        out = go()
        with pytest.raises(HostArray):
            sim.run(graphs.copy_state(state), m_sh, terms, src, nsteps)
    got = sim.extract_state(out)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.abs(got[1]).max() > 0


# ---- (c) the key and the roles ------------------------------------------------------


def _per_step_sim(hetero=False):
    g = tt.Grid3D(16, 8, 8, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m = make_correctness_ic(g)
    if hetero:
        m = (1.3 + 0.5 * np.random.default_rng(1).random(g.padded_shape)).astype(np.float32)
    cfg = tt.SimConfig(dt=0.001, ring="exact")
    sim = ShardedSimulator(g, cfg, m, _mesh(4), src_coords=np.array([[3.5, 4.0, 4.0]],
                                                                    np.float32))
    return sim, sim.prepare(up, uc, m)


def _sweep_sim(shape=None):
    g = tt.Grid3D(32, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    _, uc, m = make_correctness_ic(g)
    sim = ShardedSimulator(g, tt.SimConfig(dt=0.001), m, _mesh(4, shape),
                           src_coords=_sources(g))
    return sim, sim.prepare(uc, uc, m)


@pytest.mark.parametrize("engine", ["sweep", "per-step", "per-step per-point m"])
def test_span_key_changes_with_what_the_graph_records(engine):
    if engine == "sweep":
        sim, (state, m_sh, terms) = _sweep_sim()
    else:
        sim, (state, m_sh, terms) = _per_step_sim(hetero="per-point" in engine)
    rows = np.zeros((6, 1), np.float32)

    def key(st=state, ms=m_sh, tm=terms, r=rows, n=6):
        return sim._key(st, ms, tm, r, n)

    assert key() == key() == key(r=rows.copy())  # the same buffers and table shape
    others = [key(n=7), key(r=np.zeros((6, 2), np.float32)), key(r=None),
              key(st=graphs.copy_state(state))]
    if engine != "sweep":
        m_other = ([m + 1.0 for m in m_sh] if sim.m_val is not None
                   else [m.clone() for m in m_sh])
        terms_other = [None if t is None else type(t)(tuple(i.clone() for i in t.index),
                                                      t.scale.clone(), t.src_idx, t.empty)
                       for t in terms]
        others += [key(ms=m_other), key(tm=terms_other)]
        assert sim.m_val is None if "per-point" in engine else sim.m_val == 1.5
    assert len({key(), *others}) == 1 + len(others)
    assert key()[:3] == ("sweep" if engine == "sweep" else "per-step", 6, (6, 1))


@pytest.mark.parametrize("nsteps", [6, 7, 8])
def test_roles_of_the_per_step_engine(nsteps):
    """(P, C, T) of per-shard levels rotate once a step: after nsteps they
    stand nsteps % 3 places on."""
    sim, (state, m_sh, terms) = _per_step_sim()
    out = sim.run(state, m_sh, terms, np.ones((nsteps, 1), np.float32), nsteps)
    levels = [tuple(range(4 * i, 4 * i + 4)) for i in range(3)]
    turn = nsteps % 3
    assert graphs.roles(state, out) == tuple(levels[turn:] + levels[:turn])
    assert graphs.state_of(graphs.roles(state, out), graphs.buffers(state).__getitem__) == out


@pytest.mark.parametrize("shape", [None, (2, 2)])
@pytest.mark.parametrize("nsteps,blocks", [(4, 2), (6, 3), (5, 3), (3, 2)])
def test_roles_of_the_sweep(shape, nsteps, blocks):
    """Each shard's (U, spare) swaps once a K = 2 block, the short last
    block included: after an odd count of blocks every pair is swapped."""
    sim, (state, m_sh, terms) = _sweep_sim(shape)
    assert sim.sweep.K == 2 and -(-nsteps // 2) == blocks
    out = sim.run(state, m_sh, terms, tt.ricker_table(nsteps, 1, 0.001), nsteps)
    ndx, ndy = sim.sweep.ndx, sim.sweep.ndy
    pair = (lambda i: (2 * i + 1, 2 * i)) if blocks % 2 else (lambda i: (2 * i, 2 * i + 1))
    want = {"sweep": [[pair(dx * ndy + dy) for dy in range(ndy)] for dx in range(ndx)]}
    assert graphs.roles(state, out) == want
    refill = graphs.state_of(graphs.roles(state, out), graphs.buffers(state).__getitem__)
    assert all(a is b for a, b in zip(graphs.buffers(refill), graphs.buffers(out)))


@pytest.mark.parametrize("ring", ["exact", "fast"])
def test_roles_of_the_single_device(ring):
    """The single device's states take the same helpers: the exact ring
    rotates (P, C, T) a step, the fast ring swaps (U, spare) a block."""
    g = tt.Grid3D(16, 16, 16, hx=1.0, hy=1.0, hz=1.0)
    _, uc, m = make_correctness_ic(g)
    sim = tt.Simulator(g, tt.SimConfig(dt=0.001, ring=ring), m, device="cpu")
    state = sim.prepare_state(uc, uc)
    out = sim.run(state, None, 5)
    want = (2, 0, 1) if ring == "exact" else {"sweep": (1, 0)}  # 5 steps; 3 blocks of K = 2
    assert getattr(sim.engine, "sweep_k", 0) == (0 if ring == "exact" else 2)
    assert graphs.roles(state, out) == want


def test_cards_probe_needs_two_cards():
    """The probe behind the rule's reason (harness/cards_probe.py) refuses
    to run without two cards, and names the cases it runs."""
    from tpufdtd_torch.harness import cards_probe

    assert cards_probe.CASES == ("cold", "warm", "reuse")
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="two or more CUDA cards"):
            cards_probe.main([])

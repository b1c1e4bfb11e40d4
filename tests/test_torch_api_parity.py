"""F6: the port's exported calls take the JAX package's arguments in the JAX
package's positions (ROADMAP Queue 3). Each call is made here as the JAX
package's callers make it, on device="cpu" at 32^3 or less; where a call
computes, it is held to the port's own keyword call bitwise, or to the JAX
package within TOL rel-L2 (independent f32 implementations, as in
tests/test_torch_stepper.py).
"""

import inspect

import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd.harness import perf as jperf
from tpufdtd.harness import perf_sharded as jperf_sharded
from tpufdtd.parallel import make_mesh as jmake_mesh
from tpufdtd_torch.harness import perf, perf_sharded
from tpufdtd_torch.layout import Layout
from tpufdtd_torch.parallel import make_mesh
from conftest import rel_l2

TOL = 2e-6
N = 16


def _sim(backend="cuda", storage="float32", ring="auto", layered=False, nsteps=6):
    g = tt.Grid3D(N, N, N)
    m = np.full(g.padded_shape, 1.5, np.float32)
    if layered:
        m[: g.padded_shape[0] // 2] = 2.0
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, backend=backend, storage_dtype=storage,
                       ring=ring)
    return tt.Simulator(g, cfg, m, tt.default_source_coords(1, N, N, N), device="cpu")


def _leaves(state):
    return list(state["sweep"]) if isinstance(state, dict) else list(state)


# (backend, storage, ring, layered) -> the ring prepare_state picks
SPEC_CASES = {"fast": ("cuda", "float32", "auto", False),
              "fast_bf16": ("cuda", "bfloat16", "auto", False),
              "fast_w": ("cuda", "float32", "auto", True),
              "exact_cuda": ("cuda", "float32", "exact", False),
              "exact_torch": ("torch", "float32", "auto", False),
              "exact_bf16": ("torch", "bfloat16", "auto", False)}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_state_spec_matches_prepare_state(case):
    """state_spec() and prepare_state_random have prepare_state's structure,
    shapes and dtypes on both rings, as tests/test_harness.py holds the JAX
    package's; state_spec's tensors are on the meta device."""
    sim = _sim(*SPEC_CASES[case])
    u = np.zeros(sim.grid.padded_shape, np.float32)
    ref, spec, rnd = sim.prepare_state(u, u), sim.state_spec(), sim.prepare_state_random(3)
    assert type(ref) is type(spec) is type(rnd)
    assert isinstance(ref, dict) == case.startswith("fast")
    if isinstance(ref, dict):
        assert ref.keys() == spec.keys() == rnd.keys() == {"sweep"}
    assert len(_leaves(ref)) == len(_leaves(spec)) == len(_leaves(rnd))
    for a, s, r in zip(_leaves(ref), _leaves(spec), _leaves(rnd)):
        assert a.shape == s.shape == r.shape and a.dtype == s.dtype == r.dtype
        assert s.device.type == "meta"
    zero = sim.prepare_state_random(0, scale=0.0)
    assert all(float(x.abs().max()) == 0.0 for x in _leaves(zero))


@pytest.mark.parametrize("ring", ["auto", "exact"])
def test_run_scan_takes_m_args_as_the_jax_package(ring):
    """run_scan(state, m_args, src_table, *, engine, nsteps) and the engines'
    run_scan(state, m_args, src_table, nsteps), called positionally as the
    JAX package's Simulator calls them, are bitwise Simulator.run; the
    exact ring's u_N is the JAX package's run_scan within TOL."""
    sim = _sim(ring=ring)
    g, n = sim.grid, 6
    rng = np.random.default_rng(1)
    u = np.zeros(g.padded_shape, np.float32)
    u[g.interior_slices()] = rng.standard_normal((N, N, N))
    src = tt.ricker_table(n, 1, 0.001)
    table = torch.tensor(src)
    want = sim.extract_state(sim.run(sim.prepare_state(u, u), src, n))
    eng = sim.engine
    got = sim.extract_state(eng.run_scan(sim.prepare_state(u, u), eng.m_args, table, n))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    if ring == "exact":
        got = sim.extract_state(tt.run_scan(sim.prepare_state(u, u), eng.m_args, table,
                                            engine=eng, nsteps=n))
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        gj = tf.Grid3D(N, N, N)
        jsim = tf.Simulator(gj, tf.SimConfig(dt=0.001, nsteps=n, backend="jnp"),
                            np.full(gj.padded_shape, 1.5, np.float32),
                            tf.default_source_coords(1, N, N, N))
        je = jsim.engine
        jout = tf.run_scan(jsim.prepare_state(u, u), je.m_args, jsim._src_slice(src, 0, n),
                           engine=je, nsteps=n)
        assert rel_l2(want[1], np.asarray(jout[1])) < TOL


def test_engines_m_args():
    """m_args is the engine's medium as its step takes it: (m,), m a padded
    f32 tensor or the scalar."""
    assert _sim().engine.m_args == (1.5,)
    for sim in (_sim(layered=True), _sim(backend="torch")):
        (m,) = sim.engine.m_args
        assert torch.is_tensor(m) and tuple(m.shape) == sim.grid.padded_shape


@pytest.mark.parametrize("backend,jax_backend", [("cuda", "jnp"), ("torch", "jnp")])
def test_get_step_fn_takes_the_reference_layout(backend, jax_backend):
    """get_step_fn(grid, dt, backend, layout) with layout None, the port's
    Layout.reference or the JAX package's: one step bitwise the call without
    a layout, and within TOL of the JAX package's step."""
    import jax.numpy as jnp
    from tpufdtd.layout import Layout as JLayout

    g, gj = tt.Grid3D(10, 12, 14), tf.Grid3D(10, 12, 14)
    rng = np.random.default_rng(4)
    cur, prev, tgt = (rng.standard_normal(g.padded_shape).astype(np.float32) for _ in range(3))
    args = [torch.tensor(a) for a in (cur, prev)] + [1.5]
    want = tt.get_step_fn(g, 0.01, backend)(*args, torch.tensor(tgt))
    for layout in (None, Layout.reference(g), JLayout.reference(gj)):
        got = tt.get_step_fn(g, 0.01, backend, layout)(*args, torch.tensor(tgt))
        assert torch.equal(got, want)
    jstep = tf.get_step_fn(gj, 0.01, jax_backend, None)
    jwant = np.asarray(jstep(jnp.asarray(cur), jnp.asarray(prev),
                             jnp.full(gj.padded_shape, 1.5, jnp.float32), jnp.asarray(tgt)))
    assert rel_l2(want.numpy(), jwant) < TOL


def test_get_step_fn_refuses_other_layouts():
    from tpufdtd.layout import Layout as JLayout

    g = tt.Grid3D(16, 16, 16)
    h = g.halo
    for layout in (Layout(g, (h + 1, h, h), (h, h, h)), JLayout.tpu(tf.Grid3D(16, 16, 16)),
                   Layout.reference(tt.Grid3D(16, 16, 20))):
        with pytest.raises(ValueError, match="reference layout"):
            tt.get_step_fn(g, 0.01, "cuda", layout)


def test_layout_members_as_the_jax_package():
    """is_reference, embed_region, embed and extract of the reference layout
    are the JAX package's; embed and extract return copies."""
    from tpufdtd.layout import Layout as JLayout

    g, gj = tt.Grid3D(6, 7, 8, order=4), tf.Grid3D(6, 7, 8, order=4)
    lay, jlay = Layout.reference(g), JLayout.reference(gj)
    assert lay.is_reference and jlay.is_reference
    assert lay.embed_region() == jlay.embed_region()
    a = np.random.default_rng(0).standard_normal(g.padded_shape).astype(np.float32)
    for got, want in ((lay.embed(a), jlay.embed(a)), (lay.extract(a), jlay.extract(a))):
        assert np.array_equal(got, want) and got.dtype == want.dtype
        assert not np.shares_memory(got, a)
    h = g.halo
    wide = Layout(g, (h + 2, h, h + 1), (h, h + 3, h))
    assert not wide.is_reference
    assert wide.padded_shape == (6 + 2 * h + 2, 7 + 2 * h + 3, 8 + 2 * h + 1)
    assert np.array_equal(wide.extract(wide.embed(a)), a)


def test_make_mesh_takes_the_jax_positions():
    """make_mesh(n_devices, axis="x", shape=None, axes=("x", "y")), with the
    port's devices keyword after them."""
    cpu4 = ["cpu"] * 4
    mesh = make_mesh(4, "x", devices=cpu4)
    assert (mesh.ndx, mesh.ndy, mesh.two_d) == (4, 1, False)
    mesh = make_mesh(None, "x", (2, 2), ("x", "y"), devices=cpu4)
    assert (mesh.ndx, mesh.ndy, mesh.two_d) == (2, 2, True)
    for bad in ({"axis": "y"}, {"axes": ("y", "x")}):
        with pytest.raises(ValueError, match="axes"):
            make_mesh(4, devices=cpu4, **bad)
    names = list(inspect.signature(make_mesh).parameters)
    assert names[:4] == list(inspect.signature(jmake_mesh).parameters)


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind == p.POSITIONAL_OR_KEYWORD]


def test_run_benchmark_takes_the_jax_positions():
    """run_benchmark's positional parameters are the JAX package's, in its
    order; a JAX-style positional call reaches the port's CUDA-only guard
    (a RuntimeError on the CPU), not a TypeError."""
    assert _positional(perf.run_benchmark) == _positional(jperf.run_benchmark)
    for split in (True, False):
        with pytest.raises(RuntimeError, match="CUDA"):
            perf.run_benchmark("cuda", [16], 5, 1, 1, None, "bfloat16", None, False, 0.6, 0,
                               "auto", split, 4, 2, device="cpu")


def test_state_bytes_takes_t_fuse_before_storage():
    """state_bytes(grid, method, t_fuse, storage_dtype) as the JAX package
    calls it: "bfloat16" in fourth place is the bf16 estimate, and t_fuse
    changes nothing (every depth runs on kernel B's two-buffer fast ring);
    "pallas" is the fast ring's estimate, the same as "cuda"'s."""
    assert _positional(perf.state_bytes) == _positional(jperf.state_bytes)
    g = tt.Grid3D(32, 32, 32)
    vol = int(np.prod(g.padded_shape))
    for method in ("pallas", "cuda", "torch"):
        bf16 = perf.state_bytes(g, method, 0, "bfloat16")
        assert bf16 == perf.state_bytes(g, method, storage_dtype="bfloat16")
        assert perf.state_bytes(g, method, 0, "float32") - bf16 == (
            6 if method == "torch" else 8) * vol
        assert all(perf.state_bytes(g, method, k, "bfloat16") == bf16 for k in (1, 2, 5))
    assert perf.state_bytes(g, "pallas", 0, "bfloat16") == perf.state_bytes(g, "cuda", 0,
                                                                            "bfloat16")


def test_run_sharded_benchmark_takes_the_jax_positions():
    """run_sharded_benchmark(n_devices, grids, timesteps, nsrc, reps,
    csv_path, verbose, baseline_single) as the JAX package's; the port's
    n_shards keyword still works. On the CPU both reach the CUDA-only
    timing guard."""
    assert _positional(perf_sharded.run_sharded_benchmark) == _positional(
        jperf_sharded.run_sharded_benchmark)
    cpu2 = ["cpu", "cpu"]
    with pytest.raises(RuntimeError, match="CUDA"):
        perf_sharded.run_sharded_benchmark(2, (16,), 5, 1, 1, None, False, True, devices=cpu2)
    with pytest.raises(RuntimeError, match="CUDA"):
        perf_sharded.run_sharded_benchmark(n_shards=2, grids=(16,), timesteps=5, reps=1,
                                           csv_path=None, verbose=False, devices=cpu2)
    with pytest.raises(ValueError, match="disagree"):
        perf_sharded.run_sharded_benchmark(2, n_shards=4, devices=cpu2)

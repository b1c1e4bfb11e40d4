"""bf16 storage with f32 compute on the CPU: kernel B's plain version, the
eager step (kernel A's plain version) and the bf16 paths through Simulator,
held against the JAX package on the same numpy inputs.

JAX's sweep rounds to bf16 at a K-block's two outputs only, so the port is
compared with it at the same K (3, a depth JAX's bf16 sweep takes). The two
compute the same f32 function, associated differently in the scalar-m form,
and may round an element to neighbouring bf16 values: the bound is one bf16
ulp per element (2^-8 to 2^-7 of its value) and rel-L2 4e-3. Rims stay
bitwise at their bf16-rounded values (tests/test_sweep.py:254-268). Paths
are held against the f64 oracle at 4e-2, the JAX package's bf16 bound
(tests/test_sweep.py:234).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd.layout import ZSplitLayout
from tpufdtd.ops import stencil_jnp
from tpufdtd.ops import stencil_sweep as jsw
from tpufdtd_torch.ops import stencil_step, stencil_sweep, stencil_torch
from conftest import rel_l2

DT = 0.3  # with h = 1: the stencil's share of a new level is as large as the field
BF16_TOL = 4e-2


def _bf16_ulp(a):
    """One bf16 ulp of each element of a (8 significant bits)."""
    return np.ldexp(np.float32(1.0), np.frexp(np.abs(a))[1] - 8)


def _bf16(a):
    """a rounded to bf16 (to nearest even), as f32."""
    return torch.tensor(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _assert_within_one_ulp(got, want):
    bound = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= bound)


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


@pytest.mark.parametrize("medium", ["m", "w"])
def test_bf16_ref_matches_tpu_sweep_interpret(medium):
    g = tf.Grid3D(12, 16, 32, hx=1.0, hy=1.0, hz=1.0)
    k = 3
    up, uc = _fast_ic(g, 7)
    gt = tt.Grid3D.from_fields(g)
    w_ref = None
    if medium == "w":
        m = (1.5 + 0.5 * np.random.default_rng(8).random(g.padded_shape)).astype(np.float32)
        w_ref = stencil_sweep.w_stream(gt, DT, m)
    lay = ZSplitLayout(g, py=16, xpad=max(g.halo, k * g.radius), z_embed=jsw.z_embedded(g))
    p_core, p_zrim = lay.split(up)
    c_core, _ = lay.split(uc)
    U0 = jnp.asarray(np.stack([p_core, c_core]), jnp.bfloat16)
    out = jsw.sweep_fused(U0, jnp.asarray(p_zrim, jnp.float32), grid=g, dt=DT, m_val=1.5,
                          k_fuse=k, interpret=True,
                          w=None if w_ref is None else jnp.asarray(lay.split(w_ref)[0]))
    assert out.dtype == jnp.bfloat16
    out = np.asarray(out.astype(jnp.float32))
    want = [lay.join(out[0], _bf16(p_zrim)), lay.join(out[1], _bf16(p_zrim))]
    U = torch.tensor(np.stack([up, uc])).bfloat16()
    res = stencil_sweep.sweep_fused_ref(U, grid=gt, dt=DT, m_val=1.5, k_fuse=k,
                                        w=None if w_ref is None else torch.tensor(w_ref))
    assert res.dtype == torch.bfloat16
    got = res.float().numpy()
    mask = np.zeros(g.padded_shape, bool)
    mask[g.interior_slices()] = True
    for lvl, wnt in zip(got, want):
        np.testing.assert_array_equal(lvl[~mask], _bf16(uc)[~mask])
        np.testing.assert_array_equal(wnt[~mask], _bf16(uc)[~mask])
        _assert_within_one_ulp(lvl, wnt)
        assert rel_l2(lvl[mask], wnt[mask]) <= 4e-3
        assert rel_l2(wnt[mask], up[mask]) > 0.1  # the stencil moved the field


@pytest.mark.parametrize("order", [4, 12])
def test_eager_step_rounds_bf16_once_per_step(order):
    """stencil_torch computes in f32 and rounds the stored level once, as
    stencil_jnp does: the bf16 step is the f32 step on the widened levels,
    rounded; and within one bf16 ulp of the JAX step."""
    g = tt.Grid3D(9, 7, 11, hx=1.0, hy=0.5, hz=2.0, order=order)
    rng = np.random.default_rng(order)
    cur, prev, tgt = (_bf16(rng.standard_normal(g.padded_shape)) for _ in range(3))
    m = (1.5 + rng.random(g.padded_shape)).astype(np.float32)
    b = [torch.tensor(a).bfloat16() for a in (cur, prev, tgt)]
    got = stencil_torch.leapfrog_step(b[0], b[1], torch.tensor(m), b[2].clone(), grid=g, dt=DT)
    f32 = stencil_torch.leapfrog_step(*(torch.tensor(a) for a in (cur, prev)), torch.tensor(m),
                                      torch.tensor(tgt), grid=g, dt=DT)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.bfloat16())
    want = stencil_jnp.leapfrog_step(*(jnp.asarray(a, jnp.bfloat16) for a in (cur, prev)),
                                     jnp.asarray(m), jnp.asarray(tgt, jnp.bfloat16),
                                     grid=tf.Grid3D(9, 7, 11, hx=1.0, hy=0.5, hz=2.0,
                                                    order=order), dt=DT)
    _assert_within_one_ulp(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_wrappers_take_bf16_on_cpu():
    """Both wrappers run their plain versions on bf16 CPU tensors and count
    them by storage dtype and medium; mixed dtypes are refused."""
    g = tt.Grid3D(6, 5, 7)
    up, uc = _fast_ic(g, 2)
    cur, prev = (torch.tensor(a).bfloat16() for a in (uc, up))
    stencil_step.reset_counts()
    stencil_step.leapfrog_step(cur, prev, 1.5, prev.clone(), grid=g, dt=0.001)
    assert stencil_step.counts == {"kernel": {}, "plain": {(2, "bfloat16", "scalar"): 1}}
    with pytest.raises(ValueError):
        stencil_step.leapfrog_step(cur, prev.float(), 1.5, prev.clone(), grid=g, dt=0.001)
    with pytest.raises(ValueError):
        stencil_step.leapfrog_step(cur, prev, torch.ones(g.padded_shape).bfloat16(),
                                   prev.clone(), grid=g, dt=0.001)
    U = torch.stack([prev, cur])
    w = torch.full(g.padded_shape, 1e-6)
    stencil_sweep.reset_counts()
    stencil_sweep.sweep_fused(U, U.clone(), grid=g, dt=0.001, m_val=None, k_fuse=2, w=w)
    assert stencil_sweep.counts["plain"] == {(2, 2, "bfloat16", "w"): 1}
    with pytest.raises(ValueError):
        stencil_sweep.sweep_fused(U, U.float(), grid=g, dt=0.001, m_val=1.5, k_fuse=2)


def _simulate(sim, up, uc, src, nsteps):
    return sim.extract_state(sim.run(sim.prepare_state(up, uc), src, nsteps))


def test_bf16_fast_ring_matches_jax_sweep_and_oracle():
    """Order 4 at t_fuse = 3 (two K = 3 blocks), one source: kernel B's
    bf16 path (its plain version) against the JAX sweep's, and the oracle."""
    gj = tf.Grid3D(16, 16, 32, hx=1.0, hy=1.0, hz=1.0)
    g = tt.Grid3D.from_fields(gj)
    up, uc = _fast_ic(g, 11)
    m = np.full(g.padded_shape, 1.5, np.float32)
    coords = np.array([[8.0, 8.0, 16.0]], np.float32)
    src = tt.ricker_table(6, 1, 0.001)
    sim = tt.Simulator(g, tt.SimConfig(nsteps=6, t_fuse=3, storage_dtype="bfloat16"), m,
                       coords, device="cpu")
    assert sim.engine.sweep_k == 3 and sim.engine.mode == ("bfloat16", "m")
    p, c = _simulate(sim, up, uc, src, 6)
    sim_j = tf.Simulator(gj, tf.SimConfig(nsteps=6, t_fuse=3, backend="pallas",
                                          storage_dtype="bfloat16"), m, coords)
    assert sim_j.engine.sweep_k == 3
    pj, cj = _simulate(sim_j, up, uc, src, 6)
    _, truth = tt.oracle_run(up, uc, m, g, 0.001, 6, src=src, src_coords=coords,
                             dtype=np.float64)
    assert c.dtype == np.float32
    assert rel_l2(c, cj) <= 4e-3 and rel_l2(p, pj) <= 4e-3
    assert rel_l2(c, truth) < BF16_TOL


def test_bf16_exact_ring_at_order_8_matches_jax_jnp_and_oracle():
    """Order 8 in bf16 takes the exact ring on kernel A (its plain version),
    as the JAX package takes JnpEngine: the same rounding points, 3 levels."""
    gj = tf.Grid3D(12, 16, 16, hx=1.0, hy=1.0, hz=1.0, order=8)
    g = tt.Grid3D.from_fields(gj)
    up, uc = _fast_ic(g, 12)
    m = np.full(g.padded_shape, 1.5, np.float32)
    coords = np.array([[6.0, 8.0, 8.0]], np.float32)
    src = tt.ricker_table(5, 1, 0.001)
    sim = tt.Simulator(g, tt.SimConfig(nsteps=5, storage_dtype="bfloat16"), m, coords,
                       device="cpu")
    assert sim.engine.sweep_k == 0
    got = _simulate(sim, up, uc, src, 5)
    sim_j = tf.Simulator(gj, tf.SimConfig(nsteps=5, backend="pallas",
                                          storage_dtype="bfloat16"), m, coords)
    # JnpEngine hands its bf16 levels out as they are stored
    want = [np.asarray(x, np.float32) for x in _simulate(sim_j, up, uc, src, 5)]
    assert len(got) == len(want) == 3 and got[1].dtype == np.float32
    for mine, theirs in zip(got, want):
        # a one-ulp difference of one step feeds the next, so over a path
        # the bound is rel-L2, not one ulp per element
        assert rel_l2(mine, theirs) <= 4e-3
    _, truth = tt.oracle_run(up, uc, m, g, 0.001, 5, src=src, src_coords=coords,
                             dtype=np.float64)
    assert rel_l2(got[1], truth) < BF16_TOL

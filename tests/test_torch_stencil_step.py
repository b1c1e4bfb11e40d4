"""Kernel A's module (ops/stencil_step) and the eager step on the CPU.

On the CPU the wrapper runs the plain version `leapfrog_step_ref`, which is
held here against the TPU kernel it replaces (leapfrog_step_zsplit in
interpret mode, through ZSplitLayout.split/join) and against the JAX eager
step for every order. Tolerance 1e-6 relative: independent f32
implementations of the same expression differ by association and
contraction only; rims must be bitwise untouched. The steps use DT / h =
0.3, which makes the stencil's share of the new level as large as the
field, so a field-relative bound tests the stencil.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd.layout import ZSplitLayout
from tpufdtd.ops import stencil_jnp, stencil_pallas_z
from tpufdtd_torch.ops import stencil_step, stencil_torch

DT = 0.03


def _fields(grid, seed, per_point_m):
    rng = np.random.default_rng(seed)
    cur, prev, tgt = (rng.standard_normal(grid.padded_shape).astype(np.float32) for _ in range(3))
    m = ((1.0 + rng.random(grid.padded_shape)).astype(np.float32) if per_point_m else 1.5)
    return cur, prev, tgt, m


def _rel_max(a, b):
    return float(np.abs(a.astype(np.float64) - b).max() / np.abs(b).max())


def _interior_mask(grid):
    mask = np.zeros(grid.padded_shape, bool)
    mask[grid.interior_slices()] = True
    return mask


def _ref(cur, prev, m, tgt, grid, dt=DT):
    mt = torch.tensor(m) if isinstance(m, np.ndarray) else m
    out = stencil_step.leapfrog_step_ref(torch.tensor(cur), torch.tensor(prev), mt,
                                         torch.tensor(tgt), grid=tt.Grid3D.from_fields(grid), dt=dt)
    return out.numpy()


@pytest.mark.parametrize("per_point_m", [False, True])
def test_ref_matches_tpu_kernel_interpret(per_point_m):
    g = tf.Grid3D(8, 16, 12, hx=0.1, hy=0.1, hz=0.1)
    cur, prev, tgt, m = _fields(g, 1, per_point_m)
    lay = ZSplitLayout(g)
    bx, by = stencil_pallas_z.choose_tiling(g, uniform_m=not per_point_m)
    c_core, c_zrim = lay.split(cur)
    p_core, _ = lay.split(prev)
    t_core, t_zrim = lay.split(tgt)
    m_core = lay.split(m)[0] if per_point_m else None
    core = stencil_pallas_z.leapfrog_step_zsplit(
        c_core, c_zrim, p_core, t_core, m_core, grid=g, dt=DT, bx=bx, by=by,
        m_val=None if per_point_m else m, interpret=True,
    )
    want = lay.join(np.asarray(core), t_zrim)
    got = _ref(cur, prev, m, tgt, g)
    inner = _interior_mask(g)
    np.testing.assert_array_equal(got[~inner], tgt[~inner])
    assert _rel_max(got, want) <= 1e-6


@pytest.mark.parametrize("order", [2, 4, 6, 8, 10, 12])
def test_ref_matches_jnp_every_order(order):
    g = tf.Grid3D(9, 7, 11, hx=0.1, hy=0.05, hz=0.2, order=order)
    cur, prev, tgt, m = _fields(g, order, True)
    want = np.asarray(stencil_jnp.leapfrog_step(
        jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(m), jnp.asarray(tgt), grid=g, dt=DT))
    got = _ref(cur, prev, m, tgt, g)
    inner = _interior_mask(g)
    np.testing.assert_array_equal(got[~inner], tgt[~inner])
    assert _rel_max(got, want) <= 1e-6


def test_eager_step_default_target_and_scalar_m():
    """target=None writes a copy of u_cur (u_cur itself is untouched); a
    scalar m equals a uniform m field."""
    g = tt.Grid3D(6, 5, 7)
    cur, prev, _, _ = _fields(g, 3, False)
    c = torch.tensor(cur)
    a = stencil_torch.leapfrog_step(c, torch.tensor(prev), 1.5, grid=g, dt=0.001)
    b = stencil_torch.leapfrog_step(c, torch.tensor(prev), torch.full(g.padded_shape, 1.5),
                                    grid=g, dt=0.001)
    np.testing.assert_array_equal(c.numpy(), cur)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_runs_plain_version_on_cpu():
    g = tt.Grid3D(6, 5, 7)
    cur, prev, tgt, m = _fields(g, 5, True)
    stencil_step.reset_counts()
    out = torch.tensor(tgt)
    res = stencil_step.leapfrog_step(torch.tensor(cur), torch.tensor(prev), torch.tensor(m), out,
                                     grid=g, dt=DT)
    assert res is out
    assert stencil_step.counts == {"kernel": 0, "plain": 1}
    np.testing.assert_array_equal(out.numpy(), _ref(cur, prev, m, tgt, g))


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "alias", "m_type"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    g = tt.Grid3D(6, 5, 7)
    cur, prev, tgt = (torch.zeros(g.padded_shape) for _ in range(3))
    m = 1.5
    if bad == "dtype":
        cur = cur.double()
    elif bad == "shape":
        tgt = torch.zeros((1,) + g.padded_shape[1:])
    elif bad == "strided":
        prev = torch.zeros(g.padded_shape[::-1]).permute(2, 1, 0)
    elif bad == "alias":
        tgt = cur
    elif bad == "m_type":
        m = "1.5"
    with pytest.raises((ValueError, TypeError)):
        stencil_step.leapfrog_step(cur, prev, m, tgt, grid=g, dt=0.001)


def test_coeff_values_match_the_oracle_scalars():
    g = tt.Grid3D(4, 4, 4, hx=0.1, hy=0.2, hz=0.3)
    cv = stencil_step.coeff_values(g, 0.001, 1.5)
    assert len(cv) == 16 and all(np.asarray(v).dtype == np.float32 for v in cv)
    dt = np.float32(0.001)
    assert cv[7] == dt * dt and cv[8] == np.float32(1.0) / (dt * dt)
    assert cv[10] == np.float32(1.0) / (np.float32(0.1) * np.float32(0.1))
    assert cv[13] == np.float32(1.5) and cv[14] == np.float32(3.0) * np.float32(-2.5)

"""Kernel B's deep depths (K = 5-6 at radius 1-2, K = 3-4 at radius 3) on
the CPU, bf16 storage with f32 compute, with a scalar m and with the w
stream.

The plain version `sweep_fused_ref` is held against the TPU kernel it
replaces, tpufdtd/ops/stencil_sweep.py:sweep_fused at the same depth, in
interpret mode, with the recipe of tests/test_torch_sweep_bf16.py (a
16-row y pad for the bf16 tile). Both round the two output levels to bf16
once, at the end of the K-block, from the same f32 function associated
otherwise in the scalar-m form. The bound is that file's, one bf16 ulp per
element (2^-8 to 2^-7 of its value) and rel-L2 4e-3, plus the f32
association bound of tests/test_torch_sweep_deep.py (2e-6) times the
largest |value|: over K = 5-6 steps an element can cancel to ~1e-5 of the
field, below the f32 difference of the two associations (one element of
R = 2, K = 6 here: -7.99e-06 against -8.46e-06, 4.8e-07 apart, where one
bf16 ulp of the element is 6e-08). Rims stay bitwise at their bf16-rounded
values. dt / h = 0.3, where the stencil moves the field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd.layout import ZSplitLayout
from tpufdtd.ops import stencil_sweep as jsw
from tpufdtd_torch.ops import stencil_sweep as sw
from conftest import rel_l2

DT = 0.3  # with h = 1
F32_TOL = 2e-6


def _bf16_ulp(a):
    """One bf16 ulp of each element of a (8 significant bits)."""
    return np.ldexp(np.float32(1.0), np.frexp(np.abs(a))[1] - 8)


def _bf16(a):
    """a rounded to bf16 (to nearest even), as f32."""
    return torch.tensor(np.asarray(a, np.float32)).bfloat16().float().numpy()


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
@pytest.mark.parametrize("radius,k", sorted(sw.DEEP_TILES))
def test_deep_bf16_ref_matches_tpu_sweep_interpret(radius, k, medium):
    g = tf.Grid3D(8, 16, 16, hx=1.0, hy=1.0, hz=1.0, order=2 * radius)
    up, uc = _fast_ic(g, 10 * radius + k)
    gt = tt.Grid3D.from_fields(g)
    w_ref = None
    if medium == "w":
        m = (1.5 + 0.5 * np.random.default_rng(k).random(g.padded_shape)).astype(np.float32)
        w_ref = sw.w_stream(gt, DT, m)
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
    res = sw.sweep_fused_ref(U, grid=gt, dt=DT, m_val=1.5, k_fuse=k,
                             w=None if w_ref is None else torch.tensor(w_ref))
    assert res.dtype == torch.bfloat16
    got = res.float().numpy()
    mask = np.zeros(g.padded_shape, bool)
    mask[g.interior_slices()] = True
    for lvl, wnt in zip(got, want):
        np.testing.assert_array_equal(lvl[~mask], _bf16(uc)[~mask])
        np.testing.assert_array_equal(wnt[~mask], _bf16(uc)[~mask])
        allow = (_bf16_ulp(np.maximum(np.abs(lvl), np.abs(wnt)))
                 + F32_TOL * float(np.abs(wnt[mask]).max()))
        assert np.all(np.abs(lvl - wnt) <= allow)
        assert rel_l2(lvl[mask], wnt[mask]) <= 4e-3
        assert rel_l2(wnt[mask], up[mask]) > 0.1  # the stencil moved the field

"""Kernel B's deep depths on the CPU, f32 storage: the rim-ring grid and
frozen margins.

The plain version `sweep_fused_ref` is held against the TPU kernel it
replaces, tpufdtd/ops/stencil_sweep.py:sweep_fused at the same depth, in
interpret mode, with the recipe of tests/test_sweep.py: at radius 1-2 and
K = 5-6 on a rim-ring grid (8 x 8 x 128; nz a multiple of 128, where the
TPU sweep runs these depths on its paired kernel, as in
test_sweep_deep_k_bitwise), and at radius 2, K = 6 with frozen margins on
x and y. Tolerance: rel-L2 2e-6 on the interior (the bound of
tests/test_torch_sweep_w.py; association order only), rims bitwise, the
frozen cells bitwise u_n. dt / h = 0.3, where the stencil moves the field.
"""

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
TOL = 2e-6


def _fast_ic(grid, seed):
    """Two levels with one shared random rim (the fast ring's contract)."""
    rng = np.random.default_rng(seed)
    h = grid.halo
    rim = rng.standard_normal(grid.padded_shape).astype(np.float32)
    out = []
    for _ in range(2):
        a = rim.copy()
        a[h:-h, h:-h, h:-h] = rng.standard_normal((grid.nx, grid.ny, grid.nz))
        out.append(a)
    return out


def _tpu_sweep(g, up, uc, k, frozen=(0, 0, 0, 0)):
    """[u_{n+K-1}, u_{n+K}] of the TPU sweep kernel in interpret mode."""
    import jax.numpy as jnp

    lay = ZSplitLayout(g, py=8, xpad=max(g.halo, k * g.radius), z_embed=jsw.z_embedded(g))
    p_core, p_zrim = lay.split(up)
    c_core, _ = lay.split(uc)
    U0 = jnp.asarray(np.stack([p_core, c_core]))
    zr = jnp.asarray(p_zrim if jsw.z_embedded(g) else jsw.pad_zrim(p_zrim), jnp.float32)
    flo, fhi, fylo, fyhi = frozen
    kw = dict(frozen_lo=flo, frozen_hi=fhi, frozen_ylo=fylo, frozen_yhi=fyhi) if any(frozen) else {}
    out = np.asarray(jsw.sweep_fused(U0, zr, grid=g, dt=DT, m_val=1.5, k_fuse=k, interpret=True,
                                     **kw))
    return lay.join(out[0], p_zrim), lay.join(out[1], p_zrim)


def _check(g, k, seed, frozen=(0, 0, 0, 0)):
    up, uc = _fast_ic(g, seed)
    flo, fhi, fylo, fyhi = frozen
    gt = tt.Grid3D.from_fields(g)
    got = sw.sweep_fused_ref(torch.tensor(np.stack([up, uc])), grid=gt, dt=DT, m_val=1.5,
                             k_fuse=k, frozen_lo=flo,
                             frozen_hi=fhi, frozen_ylo=fylo, frozen_yhi=fyhi).numpy()
    want = _tpu_sweep(g, up, uc, k, frozen)
    mask = np.zeros(g.padded_shape, bool)
    mask[g.interior_slices()] = True
    for lvl, wnt in zip(got, want):
        np.testing.assert_array_equal(lvl[~mask], wnt[~mask])
        assert rel_l2(lvl[mask], wnt[mask]) <= TOL
        assert rel_l2(wnt[mask], up[mask]) > 0.1  # the stencil moved the field
    for sl in sw.frozen_slices(gt, frozen):
        for lvl in got:
            np.testing.assert_array_equal(lvl[sl], uc[sl])


@pytest.mark.parametrize("radius,k", [rk for rk in sorted(sw.DEEP_TILES) if rk[0] <= 2])
def test_deep_ref_matches_tpu_sweep_interpret_rim_ring(radius, k):
    """Radius 1-2 at K = 5-6 on the rim-ring grid, where the TPU sweep runs
    its paired kernel (tests/test_sweep.py:test_sweep_deep_k_bitwise)."""
    g = tf.Grid3D(8, 8, 128, hx=1.0, hy=1.0, hz=1.0, order=2 * radius)
    assert not jsw.z_embedded(g)
    _check(g, k, 30 + 10 * radius + k)


def test_deep_ref_with_margins_matches_tpu_sweep_interpret():
    """R = 2, K = 6 with x margins and rows: frozen cells bitwise u_n."""
    g = tf.Grid3D(10, 8, 16, hx=1.0, hy=1.0, hz=1.0)
    _check(g, 6, 70, frozen=(2, 3, 2, 2))

"""Kernel B's module (ops/stencil_sweep) on the CPU.

The plain version `sweep_fused_ref` (K eager steps, rims frozen) is held
against the TPU kernel it replaces, sweep_fused in interpret mode, with
the recipe of tests/test_sweep.py (ZSplitLayout split, pad_zrim). The TPU
kernel flips level roles at K = 1 (the new level lands in level 1-cur);
the port always returns [u_{n+K-1}, u_{n+K}]. Tolerance: rel-L2 1e-6,
association order only. The steps use dt / h = 0.3 (stable at order 4),
which makes the stencil's share of each new level as large as the field,
so a field-relative bound tests the stencil.
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


@pytest.mark.parametrize("k,h", [(1, (1.0, 1.0, 1.0)), (2, (1.0, 1.0, 1.0)),
                                 (4, (1.0, 1.0, 1.0)), (2, (1.0, 0.5, 2.0))])
def test_ref_matches_tpu_sweep_interpret(k, h):
    import jax.numpy as jnp

    dt = 0.3 * h[0]
    g = tf.Grid3D(12, 16, 32, hx=h[0], hy=h[1], hz=h[2])
    up, uc = _fast_ic(g, 10 + k)
    lay = ZSplitLayout(g, py=8, xpad=max(g.halo, k * g.radius), z_embed=jsw.z_embedded(g))
    p_core, p_zrim = lay.split(up)
    c_core, _ = lay.split(uc)
    U0 = jnp.asarray(np.stack([p_core, c_core]))
    zr = jnp.asarray(p_zrim if jsw.z_embedded(g) else jsw.pad_zrim(p_zrim), jnp.float32)
    out = np.asarray(jsw.sweep_fused(U0, zr, grid=g, dt=dt, m_val=1.5, k_fuse=k,
                                     interpret=True))
    if k == 1:  # cur = 1 in, new level written to level 0
        want_prev, want_cur = lay.join(out[1], p_zrim), lay.join(out[0], p_zrim)
    else:
        want_prev, want_cur = lay.join(out[0], p_zrim), lay.join(out[1], p_zrim)

    U = torch.tensor(np.stack([up, uc]))
    got = sw.sweep_fused_ref(U, grid=tt.Grid3D.from_fields(g), dt=dt, m_val=1.5, k_fuse=k)
    assert rel_l2(got[0].numpy(), want_prev) <= 1e-6
    assert rel_l2(got[1].numpy(), want_cur) <= 1e-6


def test_ref_is_k_plain_steps_with_frozen_rims():
    """K fused steps equal K steps of the NumPy oracle within f32
    association error, for isotropic and anisotropic h; rims never change."""
    for h in ((0.1, 0.05, 0.2), (0.1, 0.1, 0.1)):
        g = tt.Grid3D(9, 8, 10, hx=h[0], hy=h[1], hz=h[2])
        up, uc = _fast_ic(g, 3)
        got = sw.sweep_fused_ref(torch.tensor(np.stack([up, uc])), grid=g, dt=0.03,
                                 m_val=1.5, k_fuse=3)
        p, c = up.copy(), uc.copy()
        for _ in range(3):
            p, c = c, tt.oracle_step(c, p, np.full(g.padded_shape, 1.5, np.float32), g, 0.03,
                                     target=p)
        assert rel_l2(got[1].numpy(), c) <= 1e-7
        assert rel_l2(got[0].numpy(), p) <= 1e-7
        mask = np.ones(g.padded_shape, bool)
        mask[g.interior_slices()] = False
        for lvl in got.numpy():
            np.testing.assert_array_equal(lvl[mask], uc[mask])


def test_wrapper_runs_plain_version_on_cpu():
    g = tt.Grid3D(9, 8, 10)
    U = torch.tensor(np.stack(_fast_ic(g, 4)))
    out = U.clone()
    sw.reset_counts()
    res = sw.sweep_fused(U, out, grid=g, dt=0.001, m_val=1.5, k_fuse=2)
    assert res is out and sw.counts == {"kernel": 0, "plain": 1}
    np.testing.assert_array_equal(
        out.numpy(), sw.sweep_fused_ref(U, grid=g, dt=0.001, m_val=1.5, k_fuse=2).numpy()
    )


@pytest.mark.parametrize("bad", ["order", "k0", "kdeep", "alias", "m_field", "dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    g = tt.Grid3D(6, 6, 6, order=6 if bad == "order" else 4)
    U = torch.zeros((2,) + g.padded_shape)
    out = U.clone()
    k, m = 2, 1.5
    if bad == "k0":
        k = 0
    elif bad == "kdeep":
        k = sw.k_max() + 1
    elif bad == "alias":
        out = U
    elif bad == "m_field":
        m = torch.ones(g.padded_shape)
    elif bad == "dtype":
        out = out.double()
    with pytest.raises((ValueError, TypeError)):
        sw.sweep_fused(U, out, grid=g, dt=0.001, m_val=m, k_fuse=k)


def test_tiles_fit_shared_memory():
    assert sw.k_max() == max(sw.TILES) == 4
    for k, tile in sw.TILES.items():
        assert sw.smem_bytes(k) <= sw.SMEM_LIMIT
        planes = 4 + 6 + 5 * (k - 1)
        assert sw.smem_bytes(k) == 4 * planes * (tile[1] + 4 * k) * (tile[2] + 4 * k)
    assert sw.smem_bytes(5, sw.TILES[4]) > sw.SMEM_LIMIT
    g = tt.Grid3D(6, 6, 6)
    U = torch.zeros((2,) + g.padded_shape)
    with pytest.raises(ValueError, match="shared memory"):
        sw.sweep_fused(U, U.clone(), grid=g, dt=0.001, m_val=1.5, k_fuse=2, tile=(64, 64, 64, 8))


def test_gpu_shapes_span_several_x_chunks():
    """tests/test_torch_gpu.py and chip_smoke.py check kernel B at nx = 1100
    for the code that stitches a block's x-chunks: wider than one chunk at
    every K, as 512^3 is at K = 1."""
    assert all(tile[0] < 1100 // 2 for tile in sw.TILES.values())
    assert sw.TILES[1][0] < 512

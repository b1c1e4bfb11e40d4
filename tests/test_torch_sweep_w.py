"""Kernel B's w stream (a heterogeneous medium) and the local-medium
correction cubes, on the CPU.

The plain version `sweep_fused_ref(..., w=...)` is held against the TPU
kernel it replaces, tpufdtd/ops/stencil_sweep.py:sweep_fused(..., w=...), in
interpret mode, with the recipe of tests/test_sweep.py:536-553 (the levels
and the w stream split into the ZSplitLayout core). Tolerance: rel-L2 2e-6
on the interior, rims bitwise; both compute the TPU sweep's w form term for
term, so they differ by f32 rounding only. The steps use dt / h = 0.3 with
m in [1.5, 2.0], which makes the stencil's share of each new level as large
as the field, so a field-relative bound tests the stencil and w.
"""

import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd import sources as jsrc
from tpufdtd.layout import ZSplitLayout
from tpufdtd.ops import stencil_sweep as jsw
from tpufdtd_torch import sources
from tpufdtd_torch.ops import stencil_sweep as sw
from conftest import rel_l2

DT = 0.3  # with h = 1


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


def _w_ref(grid, seed):
    m = (1.5 + 0.5 * np.random.default_rng(seed).random(grid.padded_shape)).astype(np.float32)
    return sw.w_stream(tt.Grid3D.from_fields(grid), DT, m)


def _tpu_sweep_w(g, up, uc, w_ref, k):
    """[u_{n+K-1}, u_{n+K}] of the TPU sweep kernel's w mode, interpret mode."""
    import jax.numpy as jnp

    lay = ZSplitLayout(g, py=8, xpad=max(g.halo, k * g.radius), z_embed=jsw.z_embedded(g))
    p_core, p_zrim = lay.split(up)
    c_core, _ = lay.split(uc)
    U0 = jnp.asarray(np.stack([p_core, c_core]))
    zr = jnp.asarray(p_zrim if jsw.z_embedded(g) else jsw.pad_zrim(p_zrim), jnp.float32)
    out = np.asarray(jsw.sweep_fused(U0, zr, grid=g, dt=DT, m_val=None, k_fuse=k,
                                     interpret=True, w=jnp.asarray(lay.split(w_ref)[0])))
    if k == 1:  # cur = 1 in, new level written to level 0
        return lay.join(out[1], p_zrim), lay.join(out[0], p_zrim)
    return lay.join(out[0], p_zrim), lay.join(out[1], p_zrim)


def check_w_mode_against_tpu_sweep(order, k, h=(1.0, 1.0, 1.0)):
    g = tf.Grid3D(8, 8, 16, hx=h[0], hy=h[1], hz=h[2], order=order)
    up, uc = _fast_ic(g, 40 + order + k)
    w_ref = _w_ref(g, order + k)
    want_prev, want_cur = _tpu_sweep_w(g, up, uc, w_ref, k)
    got = sw.sweep_fused_ref(torch.tensor(np.stack([up, uc])), grid=tt.Grid3D.from_fields(g),
                             dt=DT, m_val=None, k_fuse=k, w=torch.tensor(w_ref)).numpy()
    mask = np.zeros(g.padded_shape, bool)
    mask[g.interior_slices()] = True
    for lvl, want in zip(got, (want_prev, want_cur)):
        np.testing.assert_array_equal(lvl[~mask], want[~mask])
        assert rel_l2(lvl[mask], want[mask]) <= 2e-6
        assert rel_l2(want[mask], up[mask]) > 0.1  # the stencil moved the field


@pytest.mark.parametrize("order,k,h", [(2, 1, (1.0, 1.0, 1.0)), (2, 2, (1.0, 1.0, 1.0)),
                                       (2, 3, (1.0, 1.0, 1.0)), (4, 1, (1.0, 1.0, 1.0)),
                                       (4, 2, (1.0, 1.0, 1.0)), (4, 3, (1.0, 1.0, 1.0)),
                                       (4, 2, (1.0, 0.5, 2.0))])
def test_w_mode_ref_matches_tpu_sweep_interpret(order, k, h):
    """Radius 1 and 2 at K = 1-3, and the anisotropic w form at radius 2
    (radius 3: tests/test_torch_sweep_w_radius3.py)."""
    check_w_mode_against_tpu_sweep(order, k, h)


def test_w_stream_matches_the_jax_engine():
    """w = dt^2/(h^2 m) in f64, rounded to f32, as ZSplitEngine builds it
    (tpufdtd/stepper.py:278-293), over the interior cells it reads."""
    gj = tf.Grid3D(16, 16, 16)
    m = (1.2 + np.random.default_rng(3).random(gj.padded_shape)).astype(np.float32)
    eng = tf.Simulator(gj, tf.SimConfig(dt=0.001, backend="pallas"), m).engine
    assert eng.sweep_w is not None
    lay = eng.sweep_lay
    mine = lay.split(sw.w_stream(tt.Grid3D.from_fields(gj), 0.001, m))[0]
    theirs = np.asarray(eng.sweep_w)
    inner = (slice(lay.px, lay.px + gj.nx), slice(lay.py, lay.py + gj.ny))
    h = gj.halo
    np.testing.assert_array_equal(mine[inner][..., h:h + gj.nz], theirs[inner][..., h:h + gj.nz])


@pytest.mark.parametrize("kmax", [2, 3, 4])
def test_cubes_from_the_local_medium_match_jax(kmax):
    """A source in a strong local contrast (tests/test_sweep.py:510-513):
    the correction cubes propagate through the medium's window around the
    deposit, bitwise as the JAX package's injection_cubes_upto(m_core=...)."""
    gj = tf.Grid3D(32, 16, 32)
    x = np.linspace(0, 1, gj.padded_shape[0])[:, None, None]
    y = np.linspace(0, 1, gj.padded_shape[1])[None, :, None]
    z = np.linspace(0, 1, gj.padded_shape[2])[None, None, :]
    m = (1.6 + 0.4 * np.sin(3 * x + 2) * np.cos(2 * y) * np.sin(4 * z)).astype(np.float32)
    m[16:22, 8:14, 16:22] *= 1.3
    coords = np.array([[18.0, 10.0, 18.0]], np.float32) * np.float32(0.1)
    g = tt.Grid3D.from_fields(gj)
    mine = sources.injection_cubes_upto(g, sources.build_source_term(g, coords, m), None, 0.001,
                                        kmax=kmax, m_core=m)
    theirs = jsrc.injection_cubes_upto(gj, jsrc.build_source_term(gj, coords, m), None, 0.001,
                                       kmax=kmax, m_core=m)
    uniform = sources.injection_cubes_upto(g, sources.build_source_term(g, coords, m), 1.6,
                                           0.001, kmax=kmax)
    assert sorted(mine) == sorted(theirs) == list(range(2, kmax + 1))
    for j in mine:
        assert len(mine[j]) == len(theirs[j]) == 1
        (sl, cube, p), (slj, cubej, pj) = mine[j][0], theirs[j][0]
        assert sl == slj and p == pj
        np.testing.assert_array_equal(cube, cubej)
        assert not np.array_equal(cube, uniform[j][0][1])  # the medium reached the cube

"""Kernel B's frozen margins (ops/stencil_sweep: frozen_lo/hi/ylo/yhi) on the CPU.

The plain version `sweep_fused_ref` with margins is held against the TPU
sweep kernel with the same margins, in interpret mode, on the grids of
tests/test_sweep.py's margin tests (16 x 16 x 128, rim-ring mode, and
16 x 16 x 32, z-embed mode). Tolerance: rel-L2 1e-6, as in
tests/test_torch_stencil_sweep.py (association order only), at dt / h =
0.3, where the stencil moves the field. The frozen planes and rows must be
bitwise u_n, the input's level 1, in both output levels.
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

DT = 0.3
TOL = 1e-6


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


def _w(grid, seed):
    """The w stream of a random medium m in [1.5, 2.0]."""
    m = 1.5 + 0.5 * np.random.default_rng(seed).random(grid.padded_shape)
    return sw.w_stream(tt.Grid3D.from_fields(grid), DT, m.astype(np.float32))


def _tpu_sweep(g, up, uc, k, frozen, w=None):
    """[u_{n+K-1}, u_{n+K}] of the TPU sweep with margins, in interpret mode."""
    import jax.numpy as jnp

    lay = ZSplitLayout(g, py=8, xpad=max(g.halo, max(k, 2) * g.radius),
                       z_embed=jsw.z_embedded(g))
    p_core, p_zrim = lay.split(up)
    c_core, _ = lay.split(uc)
    U0 = jnp.asarray(np.stack([p_core, c_core]))
    zr = jnp.asarray(p_zrim if jsw.z_embedded(g) else jsw.pad_zrim(p_zrim), jnp.float32)
    wj = None if w is None else jnp.asarray(lay.split(w)[0])
    flo, fhi, fylo, fyhi = frozen
    out = np.asarray(jsw.sweep_fused(U0, zr, grid=g, dt=DT, m_val=1.5, k_fuse=k,
                                     interpret=True, pair="off", frozen_lo=flo,
                                     frozen_hi=fhi, frozen_ylo=fylo, frozen_yhi=fyhi,
                                     w=wj))
    if k == 1:  # cur = 1 in, new level written to level 0
        return lay.join(out[1], p_zrim), lay.join(out[0], p_zrim)
    return lay.join(out[0], p_zrim), lay.join(out[1], p_zrim)


def _ref(g, up, uc, k, frozen, w=None, dtype=torch.float32):
    flo, fhi, fylo, fyhi = frozen
    U = torch.tensor(np.stack([up, uc])).to(dtype)
    return sw.sweep_fused_ref(U, grid=tt.Grid3D.from_fields(g), dt=DT, m_val=1.5, k_fuse=k,
                              w=None if w is None else torch.tensor(w), frozen_lo=flo,
                              frozen_hi=fhi, frozen_ylo=fylo, frozen_yhi=fyhi)


def _assert_frozen_bitwise(g, got, uc, frozen):
    """Every frozen cell holds u_n in both output levels, bit for bit."""
    slices = sw.frozen_slices(tt.Grid3D.from_fields(g), frozen)
    assert slices
    want = torch.tensor(uc).to(got.dtype)
    for sl in slices:
        for lvl in range(2):
            assert torch.equal(got[lvl][sl], want[sl]), (sl, lvl)


# (nz, K, (frozen_lo, frozen_hi, frozen_ylo, frozen_yhi)): x margins (2, 4)
# as tests/test_sweep.py:330-347, rows (2, 2) and (2, 3) as :444-452
CASES = [
    (128, 1, (2, 4, 0, 0)), (128, 2, (2, 4, 2, 2)), (128, 3, (2, 0, 2, 3)),
    (32, 1, (2, 4, 0, 0)), (32, 2, (2, 4, 2, 2)), (32, 3, (0, 0, 2, 2)),
]


@pytest.mark.parametrize("nz,k,frozen", CASES)
def test_ref_with_margins_matches_tpu_sweep_interpret(nz, k, frozen):
    g = tf.Grid3D(16, 16, nz, hx=1.0, hy=1.0, hz=1.0)
    up, uc = _fast_ic(g, 40 + k + nz)
    got = _ref(g, up, uc, k, frozen)
    want_prev, want_cur = _tpu_sweep(g, up, uc, k, frozen)
    assert rel_l2(got[0].numpy(), want_prev) <= TOL
    assert rel_l2(got[1].numpy(), want_cur) <= TOL
    _assert_frozen_bitwise(g, got, uc, frozen)


@pytest.mark.parametrize("k", [2])
def test_ref_with_margins_and_w_matches_tpu_sweep_interpret(k):
    """The w mode with x margins and rows (the 2-D-mesh edge shard of a
    heterogeneous medium)."""
    g = tf.Grid3D(16, 16, 32, hx=1.0, hy=1.0, hz=1.0)
    up, uc = _fast_ic(g, 50 + k)
    w = _w(g, 60 + k)
    frozen = (2, 0, 0, 2)
    got = _ref(g, up, uc, k, frozen, w)
    want_prev, want_cur = _tpu_sweep(g, up, uc, k, frozen, w)
    assert rel_l2(got[0].numpy(), want_prev) <= TOL
    assert rel_l2(got[1].numpy(), want_cur) <= TOL
    _assert_frozen_bitwise(g, got, uc, frozen)


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_wrapper_writes_frozen_cells_into_out(order, storage):
    """sweep_fused on the CPU: `out` starts as garbage in its interior; the
    frozen cells must come out as u_n in both levels, the rest as the plain
    version, and out's rims stay its own."""
    g = tt.Grid3D(12, 10, 9, hx=1.0, hy=1.0, hz=1.0, order=order)
    up, uc = _fast_ic(g, order)
    dtype = getattr(torch, storage)
    U = torch.tensor(np.stack([up, uc])).to(dtype)
    out = U.clone()
    out[(slice(None),) + g.interior_slices()] = 7.0
    frozen = (g.radius, 2 * g.radius, g.radius, 1)
    kw = dict(zip(("frozen_lo", "frozen_hi", "frozen_ylo", "frozen_yhi"), frozen))
    got = sw.sweep_fused(U, out, grid=g, dt=DT, m_val=1.5, k_fuse=2, **kw)
    want = sw.sweep_fused_ref(U, grid=g, dt=DT, m_val=1.5, k_fuse=2, **kw)
    assert got is out and torch.equal(got, want)
    _assert_frozen_bitwise(g, got, uc, frozen)
    assert not torch.equal(got, sw.sweep_fused_ref(U, grid=g, dt=DT, m_val=1.5, k_fuse=2))


def test_zero_margins_change_nothing():
    g = tt.Grid3D(12, 10, 9, hx=1.0, hy=1.0, hz=1.0)
    up, uc = _fast_ic(g, 3)
    U = torch.tensor(np.stack([up, uc]))
    a = sw.sweep_fused_ref(U, grid=g, dt=DT, m_val=1.5, k_fuse=3)
    b = sw.sweep_fused_ref(U, grid=g, dt=DT, m_val=1.5, k_fuse=3, frozen_lo=0, frozen_hi=0,
                           frozen_ylo=0, frozen_yhi=0)
    assert torch.equal(a, b)


@pytest.mark.parametrize("frozen", [(-1, 0, 0, 0), (7, 6, 0, 0), (0, 0, 6, 5)])
def test_margins_out_of_range_raise(frozen):
    g = tt.Grid3D(12, 10, 9, hx=1.0, hy=1.0, hz=1.0)
    U = torch.zeros((2,) + g.padded_shape)
    kw = dict(zip(("frozen_lo", "frozen_hi", "frozen_ylo", "frozen_yhi"), frozen))
    with pytest.raises(ValueError, match="frozen margins"):
        sw.sweep_fused(U, U.clone(), grid=g, dt=DT, m_val=1.5, k_fuse=1, **kw)

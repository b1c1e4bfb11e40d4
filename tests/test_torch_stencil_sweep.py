"""Kernel B's module (ops/stencil_sweep) on the CPU.

The plain version `sweep_fused_ref` (K eager steps, rims frozen) is held
against the TPU kernels it replaces, in interpret mode: sweep_fused at
radius 1-3 with the recipe of tests/test_sweep.py (ZSplitLayout split,
pad_zrim), and at radius 4 packed_step (K = 1) and packed_fused2 (K = 2)
with the recipe of the JAX engine's packed ring. The TPU kernels flip level
roles at K = 1 (the new level lands in level 1-cur); the port always
returns [u_{n+K-1}, u_{n+K}]. Tolerance: rel-L2 1e-6, association order
only (the TPU sweep's isotropic form against the exact form). The steps
use dt / h = 0.3 (stable at orders 2-8 with m = 1.5), which makes the
stencil's share of each new level as large as the field, so a
field-relative bound tests the stencil.
"""

import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd_torch as tt
from tpufdtd.layout import ZSplitLayout
from tpufdtd.ops import stencil_pallas_z as jpz
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


def _tpu_sweep(g, up, uc, dt, k):
    """[u_{n+K-1}, u_{n+K}] of the TPU sweep kernel in interpret mode."""
    import jax.numpy as jnp

    lay = ZSplitLayout(g, py=8, xpad=max(g.halo, k * g.radius), z_embed=jsw.z_embedded(g))
    p_core, p_zrim = lay.split(up)
    c_core, _ = lay.split(uc)
    U0 = jnp.asarray(np.stack([p_core, c_core]))
    zr = jnp.asarray(p_zrim if jsw.z_embedded(g) else jsw.pad_zrim(p_zrim), jnp.float32)
    out = np.asarray(jsw.sweep_fused(U0, zr, grid=g, dt=dt, m_val=1.5, k_fuse=k,
                                     interpret=True))
    if k == 1:  # cur = 1 in, new level written to level 0
        return lay.join(out[1], p_zrim), lay.join(out[0], p_zrim)
    return lay.join(out[0], p_zrim), lay.join(out[1], p_zrim)


def _assert_ref_matches(g, up, uc, dt, k, want_prev, want_cur):
    U = torch.tensor(np.stack([up, uc]))
    got = sw.sweep_fused_ref(U, grid=tt.Grid3D.from_fields(g), dt=dt, m_val=1.5, k_fuse=k)
    assert rel_l2(got[0].numpy(), want_prev) <= 1e-6
    assert rel_l2(got[1].numpy(), want_cur) <= 1e-6


@pytest.mark.parametrize("k,h", [(1, (1.0, 1.0, 1.0)), (2, (1.0, 1.0, 1.0)),
                                 (4, (1.0, 1.0, 1.0)), (2, (1.0, 0.5, 2.0))])
def test_ref_matches_tpu_sweep_interpret(k, h):
    dt = 0.3 * h[0]
    g = tf.Grid3D(12, 16, 32, hx=h[0], hy=h[1], hz=h[2])
    up, uc = _fast_ic(g, 10 + k)
    _assert_ref_matches(g, up, uc, dt, k, *_tpu_sweep(g, up, uc, dt, k))


@pytest.mark.parametrize("order,k", [(2, 1), (2, 2), (6, 1), (6, 2)])
def test_ref_matches_tpu_sweep_interpret_radius_1_and_3(order, k):
    """sweep_fused's own radius-1 and radius-3 modes (_sweep_kernel)."""
    g = tf.Grid3D(8, 8, 16, hx=1.0, hy=1.0, hz=1.0, order=order)
    up, uc = _fast_ic(g, 20 + order + k)
    _assert_ref_matches(g, up, uc, 0.3, k, *_tpu_sweep(g, up, uc, 0.3, k))


@pytest.mark.parametrize("k", [1, 2])
def test_ref_matches_tpu_packed_interpret_radius_4(k):
    """Order 8: K = 1 is packed_step, K = 2 packed_fused2. The JAX engine's
    packed ring holds the core levels in U with one shared z rim; packed_step
    reads the pair [prev, cur] (cur = 1) and writes u_{n+1} into level
    1 - cur = 0; packed_fused2 reads the source pair at levels (2, 3)
    (src_pair = 2, prev_first: prev at 2, cur at 3) and writes
    (u_{n+1}, u_{n+2}) into levels (0, 1)."""
    import jax.numpy as jnp

    g = tf.Grid3D(12, 16, 16, hx=1.0, hy=1.0, hz=1.0, order=8)
    up, uc = _fast_ic(g, 30 + k)
    lay = ZSplitLayout(g)
    p_core, p_zrim = lay.split(up)
    c_core, _ = lay.split(uc)
    zr = jnp.asarray(p_zrim)
    if k == 1:
        bx, by = jpz.choose_tiling(g)
        out = np.asarray(jpz.packed_step(jnp.asarray(np.stack([p_core, c_core])), zr, grid=g,
                                         dt=0.3, bx=bx, by=by, m_val=1.5, cur=1,
                                         interpret=True))
        want_prev, want_cur = lay.join(out[1], p_zrim), lay.join(out[0], p_zrim)
    else:
        bx, by = jpz.choose_tiling_fused2(g)
        U4 = jnp.asarray(np.stack([p_core, p_core, p_core, c_core]))
        out = np.asarray(jpz.packed_fused2(U4, zr, grid=g, dt=0.3, bx=bx, by=by, m_val=1.5,
                                           src_pair=2, prev_first=True, interpret=True))
        want_prev, want_cur = lay.join(out[0], p_zrim), lay.join(out[1], p_zrim)
    _assert_ref_matches(g, up, uc, 0.3, k, want_prev, want_cur)


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
    assert res is out and sw.counts == {"kernel": {}, "plain": {(2, 2, "float32", "m"): 1}}
    assert sw.launches("plain") == 1 and sw.launches() == 0
    np.testing.assert_array_equal(
        out.numpy(), sw.sweep_fused_ref(U, grid=g, dt=0.001, m_val=1.5, k_fuse=2).numpy()
    )


@pytest.mark.parametrize("bad", ["order", "k0", "kdeep", "alias", "m_field", "dtype", "w_order8",
                                 "bf16_order8", "w_dtype", "w_shape", "mixed_storage"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    order = {"order": 10, "w_order8": 8, "bf16_order8": 8}.get(bad, 4)
    g = tt.Grid3D(6, 6, 6, order=order)
    U = torch.zeros((2,) + g.padded_shape)
    out = U.clone()
    k, m, w = 2, 1.5, None
    if bad in ("w_order8", "w_dtype", "w_shape"):
        w = torch.full(g.padded_shape, 1e-6, dtype=torch.float64 if bad == "w_dtype" else None)
        if bad == "w_shape":
            w = w[1:]
    elif bad == "bf16_order8":
        U, out = U.bfloat16(), out.bfloat16()
    elif bad == "mixed_storage":
        out = out.bfloat16()
    elif bad == "k0":
        k = 0
    elif bad == "kdeep":
        k = sw.k_max(g.radius) + 1
    elif bad == "alias":
        out = U
    elif bad == "m_field":
        m = torch.ones(g.padded_shape)
    elif bad == "dtype":
        out = out.double()
    with pytest.raises((ValueError, TypeError)):
        sw.sweep_fused(U, out, grid=g, dt=0.001, m_val=m, k_fuse=k, w=w)


def test_tiles_fit_shared_memory():
    """Every (R, K) of TILES fits in every storage dtype: its region within
    its threads' cells, its staging rings (2 STAGES + R planes in the
    storage dtype, rows padded to 16 B plus 16 B; STAGES + KR f32 planes of
    w) and 2K f32 centre planes within 227 KB (csrc/stencil_sweep.cuh:smem);
    TILES holds the depths with R * K <= 8 (csrc/stencil_sweep.cuh:built),
    and with the deep form's DEEP_TILES each radius has K = 1..k_max(R),
    the TPU sweep's caps 6, 6, 4 at R = 1-3 and packed_fused2's 2 at R = 4."""
    assert {r for r, _ in sw.TILES} == set(sw.RADII) == {1, 2, 3, 4}
    for (r, k), tile in sw.TILES.items():
        assert len(tile) == 3
        g2 = 2 * k * r
        py, pz = tile[1] + g2, tile[2] + g2
        for storage, esz in (("float32", 4), ("bfloat16", 2)):
            assert sw.tile_fits(r, k, tile, storage)
            v = 16 // esz
            sp = -(-pz // v) * v + v
            staged = (2 * sw.STAGES + r) * py * sp * esz
            assert sw.smem_bytes(r, k, tile, storage) == staged + 4 * 2 * k * py * pz
            w_ring = 4 * (sw.STAGES + k * r) * py * sp
            assert sw.smem_bytes(r, k, tile, storage, "w") == staged + w_ring + 4 * 2 * k * py * pz
        assert py * pz <= sw.cells_per_thread(r, k) * sw.THREADS
    for r in sw.RADII:
        kmax = sw.k_max(r)
        assert sorted(k for rr, k in {**sw.TILES, **sw.DEEP_TILES} if rr == r) == list(
            range(1, kmax + 1))
        assert max(k for rr, k in sw.TILES if rr == r) == max(k for k in range(1, 5) if r * k <= 8)
    assert [sw.k_max(r) for r in sw.RADII] == [6, 6, 4, 2]
    assert [sw.cells_per_thread(2, k) for k in (1, 2, 3, 4)] == [7, 4, 8, 6]
    assert [sw.min_blocks(2, k) for k in (1, 2, 3, 4)] == [2, 2, 1, 1]
    assert sw.min_blocks(3, 2) == 2 and sw.min_blocks(4, 2) == 1
    # the other modes' shapes: radius 1-3, K within k_max, shapes that fit
    for (storage, medium), tiles in sw.MODE_TILES.items():
        assert (storage, medium) in {("float32", "w"), ("bfloat16", "m"), ("bfloat16", "w")}
        for (r, k), tile in tiles.items():
            assert r in sw.MODE_RADII and 1 <= k <= sw.k_max(r)
            assert sw.tile_fits(r, k, tile, storage, medium)
            assert sw.tile_for(r, k, storage, medium) == tile != sw.TILES[r, k]
    assert sw.tile_for(2, 2) == sw.TILES[2, 2]
    for r, k in sw.TILES:  # every mode of every built (R, K) has a shape that fits
        for storage in ("float32", "bfloat16"):
            for medium in ("m", "w") if r in sw.MODE_RADII else ("m",):
                assert sw.tile_fits(r, k, sw.tile_for(r, k, storage, medium), storage, medium)
    g = tt.Grid3D(6, 6, 6)
    U = torch.zeros((2,) + g.padded_shape)
    with pytest.raises(ValueError, match="shared memory"):
        sw.sweep_fused(U, U.clone(), grid=g, dt=0.001, m_val=1.5, k_fuse=2,
                       tile=(64, 128, 128))
    with pytest.raises(ValueError, match="cells per thread"):
        sw.sweep_fused(U, U.clone(), grid=g, dt=0.001, m_val=1.5, k_fuse=2, tile=(64, 64, 32))


@pytest.mark.parametrize("radius,k", sorted(sw.TILES))
def test_register_rings_fit_the_thread_budget(radius, k):
    """Per built (R, K): a cell's K rings of 2R+1 registers, three offsets
    and K temporaries, times cells_per_thread, stay within the registers a
    thread may take beside REG_OVERHEAD (128 at two blocks per SM, 240 at
    one), and the cells of THREADS threads hold an 8 x 8 column with its
    K*R halo."""
    per_cell = k * (2 * radius + 1) + 3 + k
    budget = (128 if sw.min_blocks(radius, k) == 2 else 240) - sw.REG_OVERHEAD
    cells = sw.cells_per_thread(radius, k)
    assert cells >= 1 and cells * per_cell <= budget < (cells + 1) * per_cell
    assert (8 + 2 * k * radius) ** 2 <= cells * sw.THREADS


def test_gpu_shapes_span_several_x_chunks():
    """tests/test_torch_gpu.py and chip_smoke.py check kernel B at nx = 1100
    for the code that stitches a block's x-chunks: wider than two chunks at
    every (R, K), and not a multiple of any chunk, so the last is short."""
    assert all(tile[0] < 1100 // 2 for tile in sw.TILES.values())
    assert all(1100 % tile[0] for tile in sw.TILES.values())

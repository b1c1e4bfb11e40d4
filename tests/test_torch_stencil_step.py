"""Kernel A's module (ops/stencil_step) and the eager step on the CPU.

On the CPU the wrapper runs the plain version `leapfrog_step_ref`, which is
held here against the TPU kernels it replaces, in interpret mode
(leapfrog_step_zsplit through ZSplitLayout.split/join; leapfrog_step_pallas
at orders 10-12 through Layout.tpu embed/extract), and against the JAX
eager step for every order. Tolerance 1e-6 relative: independent f32
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
from tpufdtd.layout import Layout, ZSplitLayout
from tpufdtd.ops import stencil_jnp, stencil_pallas, stencil_pallas_z
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


@pytest.mark.parametrize("order", [10, 12])
@pytest.mark.parametrize("shape,mode", [((8, 16, 16), "y_tiled"), ((12, 13, 10), "y_full")])
def test_ref_matches_leapfrog_step_pallas_interpret(order, shape, mode):
    """Per-point m at the orders that only leapfrog_step_pallas runs, in its
    y-tiled mode and in its y-full mode (ny % 8 != 0). It stores the
    target's rim back; the plain version leaves it untouched: bitwise."""
    g = tf.Grid3D(*shape, hx=0.1, hy=0.1, hz=0.1, order=order)
    cur, prev, tgt, m = _fields(g, 40 + order, True)
    lay = Layout.tpu(g)
    bx, by = (4, 8) if mode == "y_tiled" else stencil_pallas.choose_tiling(g, lay)
    assert (by < g.ny) == (mode == "y_tiled")
    out = stencil_pallas.leapfrog_step_pallas(
        *(jnp.asarray(lay.embed(a)) for a in (cur, prev, m, tgt)),
        grid=g, dt=DT, bx=bx, by=by, interpret=True,
    )
    want = lay.extract(np.asarray(out))
    got = _ref(cur, prev, m, tgt, g)
    inner = _interior_mask(g)
    np.testing.assert_array_equal(want[~inner], tgt[~inner])
    np.testing.assert_array_equal(got[~inner], want[~inner])
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
    assert stencil_step.counts == {"kernel": {}, "plain": {(2, "float32", "per-point"): 1}}
    assert stencil_step.launches("plain") == 1 and stencil_step.launches() == 0
    np.testing.assert_array_equal(out.numpy(), _ref(cur, prev, m, tgt, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_point", [False, True])
def test_counts_are_keyed_by_storage_and_kind_of_m(dtype, per_point):
    """One count per call, under (radius, storage dtype, "scalar" or
    "per-point" m): a path's launches can be told apart by the kind of m."""
    g = tt.Grid3D(6, 5, 7, order=6)
    cur, prev, tgt, m = _fields(g, 6, per_point)
    stencil_step.reset_counts()
    stencil_step.leapfrog_step(*(torch.tensor(a).to(dtype) for a in (cur, prev)),
                               torch.tensor(m) if per_point else m, torch.tensor(tgt).to(dtype),
                               grid=g, dt=DT)
    key = (3, stencil_step.STORAGE[dtype], "per-point" if per_point else "scalar")
    assert stencil_step.counts == {"kernel": {}, "plain": {key: 1}}


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


# ---- kernel A's launch shape, mirrored from csrc/stencil_step.cuh -------------

LAUNCH_GRIDS = [(17, 13, 11), (128, 128, 128), (128, 512, 512), (512, 512, 512),
                (1032, 1032, 1032)]


@pytest.mark.parametrize("mkind", ["scalar", "per-point"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius", stencil_step.RADII)
def test_every_mode_tile_fits_and_gives_a_legal_grid(radius, storage, mkind):
    """Each built mode's tile fits 227 KB of shared memory and its
    instantiation's cells, and cuts every grid into a CUDA grid of legal
    extents whose x-chunks are equal, at most XC planes, and cover nx."""
    tile = stencil_step.tile_for(radius, storage, mkind)
    _xc, ty, tz = tile
    assert stencil_step.tile_fits(radius, tile, storage, mkind)
    assert stencil_step.smem_bytes(radius, tile, storage, mkind) <= 232448
    blocks = stencil_step.blocks_per_sm(radius, tile)
    assert ty * tz <= stencil_step.cells_per_thread(radius, blocks) * stencil_step.THREADS
    for shape in LAUNCH_GRIDS:
        g = tt.Grid3D(*shape, order=2 * radius)
        xc, lty, ltz = stencil_step.launch_tile(g, tile, 132)
        assert (lty, ltz) == (ty, tz) and 1 <= xc <= tile[0]
        dims = (-(-g.nz // tz), -(-g.ny // ty), -(-g.nx // xc))
        assert 1 <= dims[0] < 2**31 and 1 <= dims[1] <= 65535 and 1 <= dims[2] <= 65535
        assert xc * (dims[2] - 1) < g.nx <= xc * dims[2]
        # the padded plane's offsets are int, the plane's stride 64-bit
        assert (g.ny + 2 * g.halo) * (g.nz + 2 * g.halo) < 2**31


def test_smem_bytes_and_cells_per_thread_state_the_kernel_layout():
    """R = 6, (TY, TZ) = (12, 64): rows of 76 cells pitched to 80 f32 or 88
    bf16; 10 planes of cur over 24 rows, 4 of prev (and m) over 12."""
    tile = (512, 12, 64)
    assert stencil_step.smem_bytes(6, tile) == (10 * 24 + 4 * 12) * 80 * 4
    assert stencil_step.smem_bytes(6, tile, "float32", "per-point") == (
        (10 * 24 + 4 * 12) * 80 * 4 + 4 * 12 * 80 * 4)
    assert stencil_step.smem_bytes(6, tile, "bfloat16") == (10 * 24 + 4 * 12) * 88 * 2
    # two cells a pair, (128 or 240 registers - 72) / (two rings of 2R+1,
    # two offsets, four more) pairs
    assert [stencil_step.cells_per_thread(r, 2) for r in stencil_step.RADII] == [10, 8, 6, 4, 4, 2]
    assert [stencil_step.cells_per_thread(r, 1) for r in stencil_step.RADII] == [32, 24, 18, 14,
                                                                                 12, 10]
    assert stencil_step.blocks_per_sm(6, (512, 8, 64)) == 2
    assert stencil_step.blocks_per_sm(6, (512, 9, 64)) == 1


@pytest.mark.parametrize("tile", [(16, 64, 64), (16, 256, 8), (0, 8, 32), (16, 8, 33)])
def test_wrapper_rejects_a_tile_beyond_the_kernel(tile):
    """Beyond its threads' cells (64 x 64 at R = 6), beyond 227 KB of shared
    memory (256 x 8 at R = 6), empty, or of an odd TZ (the kernel's cells
    come in z pairs): refused before any launch, on the CPU too."""
    g = tt.Grid3D(16, 16, 16, order=12)
    cur, prev, tgt = (torch.zeros(g.padded_shape) for _ in range(3))
    assert not stencil_step.tile_fits(6, tile)
    with pytest.raises(ValueError, match="tile"):
        stencil_step.leapfrog_step(cur, prev, 1.5, tgt, grid=g, dt=0.001, tile=tile)


@pytest.mark.parametrize("shape,order,tile,want_chunks", [
    # 344 columns: 3 chunks make 4 waves of 264 blocks, 1 chunk 2 (one short)
    ((512, 512, 512), 12, (512, 12, 64), 3),
    ((128, 512, 512), 8, (512, 16, 64), 1),  # 256 columns fill 264 slots once
    ((128, 128, 128), 4, (512, 24, 64), 22),  # 12 columns: 22 chunks of 6 planes
    ((512, 512, 512), 4, (256, 24, 64), 3),  # 176 columns: 3 chunks fill 2 waves
])
def test_launch_tile_fills_the_card_in_few_waves(shape, order, tile, want_chunks):
    """Two blocks per SM on 132 SMs: 264 block slots."""
    g = tt.Grid3D(*shape, order=order)
    xc, _ty, _tz = stencil_step.launch_tile(g, tile, 132)
    assert -(-g.nx // xc) == want_chunks

"""Kernel B's deep depths (K = 5-6 at radius 1-2, K = 3-4 at radius 3) on
the CPU, f32 storage.

The plain version `sweep_fused_ref` at each depth of DEEP_TILES is held
against the TPU kernel it replaces, tpufdtd/ops/stencil_sweep.py:sweep_fused
at the same depth, in interpret mode, with the recipe of
tests/test_sweep.py, on a small z-embed grid (8 x 8 x 16) with a scalar m
and with the w stream. Tolerance: rel-L2 2e-6 on the interior (the bound
of tests/test_torch_sweep_w.py), rims bitwise: the scalar mode differs by
association only (the TPU sweep's isotropic form against the exact form),
the w mode computes the TPU sweep's w form term for term. dt / h = 0.3
makes the stencil's share of each new level as large as the field, so a
field-relative bound tests the stencil. The rim-ring grid and frozen
margins: tests/test_torch_sweep_deep_rim_ring.py; bf16 storage:
tests/test_torch_sweep_deep_bf16.py; the Simulator at these depths:
tests/test_torch_sweep_deep_sim.py.
"""

import re
from pathlib import Path

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
DEEP = sorted(sw.DEEP_TILES)


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


def _tpu_sweep(g, up, uc, k, w=None):
    """[u_{n+K-1}, u_{n+K}] of the TPU sweep kernel in interpret mode."""
    import jax.numpy as jnp

    lay = ZSplitLayout(g, py=8, xpad=max(g.halo, k * g.radius), z_embed=jsw.z_embedded(g))
    p_core, p_zrim = lay.split(up)
    c_core, _ = lay.split(uc)
    U0 = jnp.asarray(np.stack([p_core, c_core]))
    zr = jnp.asarray(p_zrim if jsw.z_embedded(g) else jsw.pad_zrim(p_zrim), jnp.float32)
    out = np.asarray(jsw.sweep_fused(U0, zr, grid=g, dt=DT, m_val=1.5, k_fuse=k, interpret=True,
                                     w=None if w is None else jnp.asarray(lay.split(w)[0])))
    return lay.join(out[0], p_zrim), lay.join(out[1], p_zrim)


def _check(g, k, seed, with_w=False):
    up, uc = _fast_ic(g, seed)
    w = _w(g, seed + 1) if with_w else None
    got = sw.sweep_fused_ref(torch.tensor(np.stack([up, uc])), grid=tt.Grid3D.from_fields(g),
                             dt=DT, m_val=1.5, k_fuse=k,
                             w=None if w is None else torch.tensor(w)).numpy()
    want = _tpu_sweep(g, up, uc, k, w)
    mask = np.zeros(g.padded_shape, bool)
    mask[g.interior_slices()] = True
    for lvl, wnt in zip(got, want):
        np.testing.assert_array_equal(lvl[~mask], wnt[~mask])
        assert rel_l2(lvl[mask], wnt[mask]) <= TOL
        assert rel_l2(wnt[mask], up[mask]) > 0.1  # the stencil moved the field


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("radius,k", DEEP)
def test_deep_ref_matches_tpu_sweep_interpret(radius, k, with_w):
    """Every deep (R, K), scalar m and the w stream, on a z-embed grid."""
    g = tf.Grid3D(8, 8, 16, hx=1.0, hy=1.0, hz=1.0, order=2 * radius)
    _check(g, k, 10 * radius + k, with_w)


def test_deep_tiles_fit_shared_memory():
    """Each deep (R, K) fits 227 KB in every mode at every tile it is built
    for: one staged plane of u_n and one of u_{n-1} over level 0's region
    in the storage dtype (rows padded to 16 B plus 16 B), each after 32 B
    of guard, and 2R+1 f32 planes of each level u_n .. u_{n+K-1} over its
    stage's region, two columns wider where jR is odd
    (csrc/stencil_sweep_deep.cuh:Shape::smem); the depths are those the
    register form does not build up to the TPU sweep's caps, and tile_for
    and k_max take them."""
    assert set(sw.DEEP_TILES) == {(1, 5), (1, 6), (2, 5), (2, 6), (3, 3), (3, 4)}
    assert set(sw.DEEP_SHAPES) == set(sw.DEEP_TILES)
    assert not set(sw.DEEP_TILES) & set(sw.TILES)
    for (r, k), tile in sw.DEEP_TILES.items():
        assert tile[1:] in sw.DEEP_SHAPES[r, k]
        for ty, tz in sw.DEEP_SHAPES[r, k]:
            g2 = 2 * k * r
            py, pz = ty + g2, tz + g2
            levels = sum((ty + 2 * (k - j) * r) * (tz + 2 * (k - j) * r + 2 * (j * r % 2))
                         for j in range(k))
            for storage, esz in (("float32", 4), ("bfloat16", 2)):
                v = 16 // esz
                sp = -(-pz // v) * v + v
                staged = 2 * (32 + py * sp * esz)
                for medium in ("m", "w"):
                    assert sw.deep_smem_bytes(r, k, (512, ty, tz), storage, medium) == staged + 4 * (
                        2 * r + 1) * levels <= sw.SMEM_LIMIT
                    assert sw.tile_fits(r, k, (256, ty, tz), storage, medium)
                    assert sw.tile_for(r, k, storage, medium) == tile
        assert k <= sw.k_max(r)
    # the deep form takes no cells-per-thread limit, only its built tiles
    g = tt.Grid3D(6, 6, 6)
    U = torch.zeros((2,) + g.padded_shape)
    sw.sweep_fused(U, U.clone(), grid=g, dt=0.001, m_val=1.5, k_fuse=6,
                   tile=(64,) + sw.DEEP_SHAPES[2, 6][-1])


def _source_shapes():
    """The (R, K, TY, TZ) instantiated by csrc/stencil_sweep_deep.cuh's
    TPUFDTD_DEEP_SHAPES list."""
    src = (Path(sw.__file__).resolve().parent.parent / "csrc" / "stencil_sweep_deep.cuh").read_text()
    block = src[src.index("#define TPUFDTD_DEEP_SHAPES(X)"):]
    block = block[:block.index("\n\n")]
    return {tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", block)}


def test_deep_sources_instantiate_every_tile_the_package_names():
    """The deep sources build exactly DEEP_SHAPES: DEEP_TILES' tiles and every
    tile harness/tile_probe.py tries in each mode (at any XC)."""
    from tpufdtd_torch.harness import tile_probe

    built = _source_shapes()
    assert built == {(r, k, ty, tz) for (r, k), shapes in sw.DEEP_SHAPES.items()
                     for ty, tz in shapes}
    for (r, k), (_xc, ty, tz) in sw.DEEP_TILES.items():
        assert (r, k, ty, tz) in built
        for storage in ("float32", "bfloat16"):
            for medium in ("m", "w"):
                for _xc, cty, ctz in tile_probe.candidates(r, k, storage=storage, medium=medium):
                    assert (r, k, cty, ctz) in built


@pytest.mark.parametrize("tile", [(512, 8, 8), (512, 32, 64), (256, 24, 32)])
def test_deep_unbuilt_tile_raises_on_cpu(tile):
    """sweep_fused(tile=...) at a deep depth raises for a tile the deep form is
    not built for, before it picks a device (here the CPU's plain version),
    and runs nothing."""
    g = tt.Grid3D(10, 9, 11, order=4)
    U = torch.zeros((2,) + g.padded_shape)
    assert tile[1:] not in sw.DEEP_SHAPES[2, 5]
    sw.reset_counts()
    with pytest.raises(ValueError, match="deep form is built for"):
        sw.sweep_fused(U, U.clone(), grid=g, dt=0.001, m_val=1.5, k_fuse=5, tile=tile)
    assert not sw.counts["plain"] and not sw.counts["kernel"]


@pytest.mark.parametrize("radius,k", DEEP)
def test_deep_wrapper_counts_and_runs_the_plain_version_on_cpu(radius, k):
    """sweep_fused at a deep (R, K) on CPU tensors runs the plain version,
    counted under its mode key, and writes only out's interior."""
    g = tt.Grid3D(10, 9, 11, hx=1.0, hy=1.0, hz=1.0, order=2 * radius)
    up, uc = _fast_ic(g, radius + k)
    U = torch.tensor(np.stack([up, uc]))
    out = U.clone()
    out[(slice(None),) + g.interior_slices()] = 7.0
    sw.reset_counts()
    got = sw.sweep_fused(U, out, grid=g, dt=DT, m_val=1.5, k_fuse=k)
    assert got is out
    assert sw.counts["plain"] == {(radius, k, "float32", "m"): 1} and not sw.counts["kernel"]
    want = sw.sweep_fused_ref(U, grid=g, dt=DT, m_val=1.5, k_fuse=k)
    assert torch.equal(out, want)


@pytest.mark.parametrize("radius,k", DEEP)
def test_tile_probe_deep_candidates_fit_shared_memory(radius, k):
    """harness/tile_probe.py's shapes for the deep form: DEEP_TILES' first,
    then the other built tiles (DEEP_SHAPES) at each XC, each within shared
    memory and with an output column of at least half the block's
    threads."""
    from tpufdtd_torch.harness import tile_probe

    tiles = tile_probe.candidates(radius, k)
    assert tiles[0] == sw.DEEP_TILES[radius, k] and len(set(tiles)) == len(tiles) > 1
    assert {t[1:] for t in tiles} == set(sw.DEEP_SHAPES[radius, k])
    for tile in tiles[1:]:
        assert sw.deep_smem_bytes(radius, k, tile) <= sw.SMEM_LIMIT
        assert 2 * tile[1] * tile[2] >= sw.DEEP_THREADS


def test_deep_floor_counts_a_pairs_words():
    """harness/tile_probe.deep_floor_ms: half a pair's 8-byte words (z window
    R + 1 + (R & 1), 2R x-, 2R y-neighbours, the level two steps back, the
    store) per cell-stage of every stage's region, at 132 x 128 B x 1.75 GHz."""
    from tpufdtd_torch.harness import tile_probe

    stages = sum((32 + 2 * (5 - j) * 2) ** 2 for j in range(1, 6)) / 32 ** 2
    want = 512 ** 3 * stages * 4 * 13 / (132 * 128 * 1.75e9) * 1e3
    assert tile_probe.deep_floor_ms(2, 5, (512, 32, 32)) == pytest.approx(want, rel=1e-12)
    assert tile_probe.deep_floor_ms(1, 6, (512, 32, 64)) < tile_probe.deep_floor_ms(
        3, 4, (512, 16, 40))

"""Hand-written kernels against their plain versions, on a CUDA card.

Run on the card with `python -m pytest -m gpu tests/test_torch_gpu.py`;
without a card every test skips. Kernel and plain version differ by FMA
contraction only (nvcc contracts a*b+c) and, in kernel B's isotropic
form, by association order; ~1e-6 of the stencil increment over K <= 4
steps, hence the bound of 1e-5 times the largest increment |want - base|,
where base is the same steps with the Laplacian left out. The fields are
random and DT / h = 0.3 (stable at orders 2-12 with m >= 1.5), so that the
increment is as large as the field and the bound tests the stencil.
In bf16 storage the kernel and the plain version compute in f32 and round
once at the end, and may round one element to neighbouring bf16 values:
the bound adds one bf16 ulp of the element (2^-8 to 2^-7 of its value).
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

import tpufdtd_torch as tt
from tpufdtd_torch import graphs
from tpufdtd_torch.harness import media
from tpufdtd_torch.harness.span_times import eager_run
from tpufdtd_torch.ops import stencil_step as A
from tpufdtd_torch.ops import stencil_sweep as B
from tpufdtd_torch.graphs import GRAPH_CACHE, buffers as _buffers
from tpufdtd_torch.stepper import Simulator, Staging

pytestmark = pytest.mark.gpu
RTOL = 1e-5
DT = 0.03


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _mask(grid, dev):
    mask = torch.zeros(grid.padded_shape, dtype=torch.bool, device=dev)
    mask[grid.interior_slices()] = True
    return mask


def _bf16_ulp(t):
    """One bf16 ulp of each element of the f32 tensor t (8 significant bits)."""
    return torch.ldexp(torch.ones_like(t), torch.frexp(t).exponent - 8)


def _close(got, want, base, untouched, mask):
    assert torch.equal(got[..., ~mask], untouched[..., ~mask])
    g, w = got.float(), want.float()
    scale = float((w - base)[..., mask].abs().max())
    assert scale > 0
    allow = torch.full_like(g, RTOL * scale)
    if got.dtype == torch.bfloat16:
        allow += _bf16_ulp(torch.maximum(g.abs(), w.abs()))
    assert bool(((g - w).abs() <= allow).all())


@pytest.mark.parametrize("shape,order,per_point", [
    ((64, 64, 64), 4, False), ((64, 64, 64), 4, True), ((17, 13, 11), 2, True),
    ((17, 13, 11), 8, False), ((17, 13, 11), 12, True)])
def test_kernel_a_matches_plain(dev, shape, order, per_point):
    g = tt.Grid3D(*shape, order=order)
    gen = torch.Generator(device=dev).manual_seed(0)
    cur, prev, tgt = (torch.randn(g.padded_shape, generator=gen, device=dev) for _ in range(3))
    m = 1.5 + 0.5 * torch.rand(g.padded_shape, generator=gen, device=dev) if per_point else 1.5
    key = (g.radius, "float32", "per-point" if per_point else "scalar")
    before = A.counts["kernel"][key]
    got = A.leapfrog_step(cur, prev, m, tgt.clone(), grid=g, dt=DT)
    assert A.counts["kernel"][key] == before + 1
    want = A.leapfrog_step_ref(cur, prev, m, tgt.clone(), grid=g, dt=DT)
    torch.cuda.synchronize()
    _close(got, want, 2 * cur - prev, tgt, _mask(g, dev))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("shape,h", [((64, 64, 64), (0.1, 0.1, 0.1)),
                                     ((17, 13, 11), (0.1, 0.05, 0.2)),
                                     # several x-chunks of a block at every K
                                     ((1100, 12, 20), (0.1, 0.1, 0.1))])
def test_kernel_b_matches_plain(dev, k, shape, h):
    _check_b(dev, tt.Grid3D(*shape, hx=h[0], hy=h[1], hz=h[2]), k)


def _w(g, dev, gen):
    """The w stream of a random medium m in [1.5, 2.0]."""
    m = 1.5 + 0.5 * torch.rand(g.padded_shape, generator=gen, device=dev)
    return torch.as_tensor(B.w_stream(g, DT, m.cpu().numpy()), device=dev)


def _check_b(dev, g, k, dtype=torch.float32, with_w=False, tile=None):
    gen = torch.Generator(device=dev).manual_seed(k)
    U = torch.randn((2,) + g.padded_shape, generator=gen, device=dev)
    mask = _mask(g, dev)
    U[0][~mask] = U[1][~mask]
    U = U.to(dtype)
    w = _w(g, dev, gen) if with_w else None
    out = U.clone()
    key = B.mode_key(g, k, U, w)
    before = B.counts["kernel"][key]
    got = B.sweep_fused(U, out.clone(), grid=g, dt=DT, m_val=1.5, k_fuse=k, w=w, tile=tile)
    assert B.counts["kernel"][key] == before + 1
    want = B.sweep_fused_ref(U, grid=g, dt=DT, m_val=1.5, k_fuse=k, w=w)
    torch.cuda.synchronize()
    Uf = U.float()
    d = Uf[1] - Uf[0]
    _close(got, want, torch.stack([Uf[1] + (k - 1) * d, Uf[1] + k * d]), out, mask)


@pytest.mark.parametrize("radius,k", sorted(rk for rk in B.TILES if rk[0] != 2))
@pytest.mark.parametrize("shape,h", [((64, 64, 64), (0.1, 0.1, 0.1)),
                                     ((17, 13, 11), (0.1, 0.05, 0.2)),
                                     ((1100, 12, 20), (0.1, 0.1, 0.1))])
def test_kernel_b_matches_plain_radius_1_3_4(dev, radius, k, shape, h):
    """Orders 2, 6 and 8: sweep_fused's radius-1 and radius-3 modes, and at
    radius 4 packed_step (K = 1) and packed_fused2 (K = 2)."""
    _check_b(dev, tt.Grid3D(*shape, hx=h[0], hy=h[1], hz=h[2], order=2 * radius), k)


def test_fast_ring_order8_on_card_matches_truth(dev):
    """Order 8 on the fast ring: 13 steps are 13 K_AUTO[4] = 1 blocks (K = 1
    is the fastest per step at radius 4), on kernel B, none on a plain
    version."""
    g = tt.Grid3D(48, 40, 56, order=8)
    m = np.full(g.padded_shape, 1.5, np.float32)
    coords = tt.default_source_coords(1, 48, 40, 56)
    src = tt.ricker_table(13, 1, 0.001)
    u0 = np.zeros(g.padded_shape, np.float32)
    sim = tt.Simulator(g, tt.SimConfig(nsteps=13), m, coords, device=dev)
    B.reset_counts()
    state = sim.run(sim.prepare_state(u0, u0), src, 13)
    assert sim.engine.sweep_k == 1 and B.launches("plain") == 0
    assert B.counts["kernel"] == {(4, 1, "float32", "m"): 13}
    _, c = sim.extract_state(state)
    _, ct, _ = tt.truth_run_ring(u0, u0, m, g, 0.001, 13, src, coords, device=dev)
    err = np.sqrt(((c - ct) ** 2).sum() / (ct**2).sum())
    assert err < 1e-5


def test_fast_ring_on_card_matches_truth(dev):
    g = tt.Grid3D(48, 40, 56)
    m = np.full(g.padded_shape, 1.5, np.float32)
    coords = tt.default_source_coords(1, 48, 40, 56)
    src = tt.ricker_table(12, 1, 0.001)
    u0 = np.zeros(g.padded_shape, np.float32)
    sim = tt.Simulator(g, tt.SimConfig(nsteps=12), m, coords, device=dev)
    B.reset_counts()
    state = sim.run(sim.prepare_state(u0, u0), src, 12)
    assert sim.engine.sweep_k >= 2 and B.launches() > 0 and B.launches("plain") == 0
    _, c = sim.extract_state(state)
    _, ct, _ = tt.truth_run_ring(u0, u0, m, g, 0.001, 12, src, coords, device=dev)
    err = np.sqrt(((c - ct) ** 2).sum() / (ct**2).sum())
    assert err < 1e-5


MODES = [(torch.float32, True), (torch.bfloat16, False), (torch.bfloat16, True)]


@pytest.mark.parametrize("dtype,with_w", MODES)
@pytest.mark.parametrize("radius,k", sorted(rk for rk in B.TILES if rk[0] in B.MODE_RADII))
@pytest.mark.parametrize("shape,h", [((64, 64, 64), (0.1, 0.1, 0.1)),
                                     ((17, 13, 11), (0.1, 0.05, 0.2))])
def test_kernel_b_modes_match_plain(dev, dtype, with_w, radius, k, shape, h):
    """The w stream and bf16 storage (each with and without the other) at
    radius 1-3 and every K, isotropic and anisotropic h."""
    _check_b(dev, tt.Grid3D(*shape, hx=h[0], hy=h[1], hz=h[2], order=2 * radius), k, dtype,
             with_w)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_kernel_b_w_of_the_scale_is_bitwise_the_scalar_mode(dev, k):
    """w filled with the scalar mode's own f32 scale: the w path changes
    nothing else (tests/test_sweep.py:527 on the card)."""
    g = tt.Grid3D(64, 64, 64)
    gen = torch.Generator(device=dev).manual_seed(k)
    U = torch.randn((2,) + g.padded_shape, generator=gen, device=dev)
    w = torch.full(g.padded_shape, float(A.coeff_values(g, DT, 1.5)[15]), device=dev)
    a = B.sweep_fused(U, U.clone(), grid=g, dt=DT, m_val=1.5, k_fuse=k)
    b = B.sweep_fused(U, U.clone(), grid=g, dt=DT, m_val=None, k_fuse=k, w=w)
    assert torch.equal(a, b)


@pytest.mark.parametrize("order", [4, 8, 12])
@pytest.mark.parametrize("per_point", [False, True])
def test_kernel_a_bf16_matches_plain(dev, order, per_point):
    g = tt.Grid3D(33, 17, 40, order=order)
    gen = torch.Generator(device=dev).manual_seed(order)
    cur, prev, tgt = (torch.randn(g.padded_shape, generator=gen, device=dev).bfloat16()
                      for _ in range(3))
    m = 1.5 + 0.5 * torch.rand(g.padded_shape, generator=gen, device=dev) if per_point else 1.5
    key = (g.radius, "bfloat16", "per-point" if per_point else "scalar")
    before = A.counts["kernel"][key]
    got = A.leapfrog_step(cur, prev, m, tgt.clone(), grid=g, dt=DT)
    assert A.counts["kernel"][key] == before + 1
    want = A.leapfrog_step_ref(cur, prev, m, tgt.clone(), grid=g, dt=DT)
    torch.cuda.synchronize()
    _close(got, want, 2 * cur.float() - prev.float(), tgt, _mask(g, dev))


def _check_a(dev, g, dtype, per_point, tile=None):
    """Kernel A against its plain version on random levels, the target's
    rim bitwise unchanged (_close)."""
    gen = torch.Generator(device=dev).manual_seed(g.nx + 7 * g.order)
    cur, prev, tgt = (torch.randn(g.padded_shape, generator=gen, device=dev).to(dtype)
                      for _ in range(3))
    m = 1.5 + 0.5 * torch.rand(g.padded_shape, generator=gen, device=dev) if per_point else 1.5
    got = A.leapfrog_step(cur, prev, m, tgt.clone(), grid=g, dt=DT, tile=tile)
    want = A.leapfrog_step_ref(cur, prev, m, tgt.clone(), grid=g, dt=DT)
    torch.cuda.synchronize()
    _close(got, want, 2 * cur.float() - prev.float(), tgt, _mask(g, dev))


# grids at kernel A's edges: nx (prime) not a multiple of the launch's XC, ny
# and nz not multiples of the tile, narrower than one tile, and row pitches
# nz + 2H that are not multiples of 16 bytes: odd (f32 4-byte copies, bf16
# copied plainly) and even (f32 8-byte, bf16 4-byte copies)
A_EDGES = {"nx % XC": (307, 16, 40), "ny, nz % tile": (20, 37, 70), "narrow": (40, 5, 6),
           "odd pitch": (17, 13, 11), "even pitch": (17, 13, 14)}


@pytest.mark.parametrize("edge", sorted(A_EDGES))
@pytest.mark.parametrize("per_point", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", A.RADII)
def test_kernel_a_edges_match_plain(dev, edge, per_point, dtype, radius):
    g = tt.Grid3D(*A_EDGES[edge], order=2 * radius)
    _check_a(dev, g, dtype, per_point)
    if edge == "nx % XC":  # x-chunks of at most 128 planes: a short last chunk
        tile = (128,) + A.tile_for(*A.mode_key(g, torch.empty(0, dtype=dtype),
                                               torch.empty(0) if per_point else 1.5))[1:]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert g.nx % A.launch_tile(g, tile, sms)[0] != 0
        _check_a(dev, g, dtype, per_point, tile=tile)


@pytest.mark.parametrize("radius", A.RADII)
def test_kernel_a_one_block_per_sm_matches_plain(dev, radius):
    """A column beyond cells_per_thread(R, 2) per thread takes the
    one-block-per-SM instantiation."""
    tile = {1: (64, 56, 64), 2: (64, 48, 64)}.get(radius, (64, 32, 64))
    assert A.blocks_per_sm(radius, tile) == 1 and A.tile_fits(radius, tile)
    g = tt.Grid3D(150, 70, 100, order=2 * radius)
    for dtype in (torch.float32, torch.bfloat16):
        _check_a(dev, g, dtype, radius % 2 == 0, tile=tile)


def test_step_smem_and_policy_are_what_the_launch_requests(dev):
    """ops/stencil_step.smem_bytes states the launch's own expression, and
    cells_per_thread and blocks_per_sm the kernel's register policy, for
    every built mode's tile and a one-block-per-SM column."""
    import ctypes

    from tpufdtd_torch.ops import _build

    lib = _build.library()
    policy = (ctypes.c_int * 2)()
    for r in A.RADII:
        tiles = {A.tile_for(r, s, mk) for s in A.STORAGE.values()
                 for mk in ("scalar", "per-point")} | {(64, 40, 64)}
        for tile in tiles:
            for storage in A.STORAGE.values():
                for mkind in ("scalar", "per-point"):
                    got = lib.tpufdtd_step_smem(r, tile[1], tile[2], int(storage == "bfloat16"),
                                                int(mkind == "per-point"))
                    assert got == A.smem_bytes(r, tile, storage, mkind)
            lib.tpufdtd_step_policy(r, tile[1], tile[2], policy)
            blocks = A.blocks_per_sm(r, tile)
            assert list(policy) == [A.cells_per_thread(r, blocks), blocks]


def test_kernel_a_launch_failure_raises(dev):
    from tpufdtd_torch.ops import _build

    g = tt.Grid3D(16, 16, 16, order=12)
    cur, prev, tgt = (torch.zeros(g.padded_shape, device=dev) for _ in range(3))
    coeffs = _build.coeff_array([0.0] * 16)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.library()
    # a radius the library does not build: the C entry's code raises
    code = lib.tpufdtd_leapfrog_step(cur.data_ptr(), prev.data_ptr(), None, tgt.data_ptr(),
                                     16, 16, 16, 14, 7, 0, 16, 8, 32, coeffs, stream)
    with pytest.raises(ValueError, match="radius 7"):
        _build.check(code, "leapfrog_step")
    # a column its threads' cells hold, in more shared memory than a block
    # has: the wrapper refuses it, and so does the C entry
    tile = (16, 256, 8)
    assert A.smem_bytes(6, tile) > A.SMEM_LIMIT
    assert tile[1] * tile[2] <= A.cells_per_thread(6, 1) * A.THREADS
    with pytest.raises(ValueError, match="shared"):
        A.leapfrog_step(cur, prev, 1.5, tgt, grid=g, dt=1e-3, tile=tile)
    code = lib.tpufdtd_leapfrog_step(cur.data_ptr(), prev.data_ptr(), None, tgt.data_ptr(),
                                     16, 16, 16, 12, 6, 0, *tile, coeffs, stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(code, "leapfrog_step")
    # a column beyond its threads' cells: both refuse it
    with pytest.raises(ValueError, match="cells"):
        A.leapfrog_step(cur, prev, 1.5, tgt, grid=g, dt=1e-3, tile=(16, 64, 64))
    code = lib.tpufdtd_leapfrog_step(cur.data_ptr(), prev.data_ptr(), None, tgt.data_ptr(),
                                     16, 16, 16, 12, 6, 0, 16, 64, 64, coeffs, stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(code, "leapfrog_step")
    # the refusals left no error behind: the next launch runs
    A.leapfrog_step(cur, prev, 1.5, tgt, grid=g, dt=1e-3)
    torch.cuda.synchronize()


@pytest.mark.parametrize("order", [4, 6])
def test_fast_ring_layered_medium_on_card_matches_truth(dev, order):
    """A heterogeneous medium at orders 4-6 runs kernel B's w mode alone."""
    g = tt.Grid3D(48, 40, 56, hx=1.0, hy=1.0, hz=1.0, order=order)
    m = media.layered(g)
    coords = tt.default_source_coords(1, 48, 40, 56, h=1.0)
    src = tt.ricker_table(13, 1, 0.3)
    u0 = np.zeros(g.padded_shape, np.float32)
    sim = tt.Simulator(g, tt.SimConfig(dt=0.3, nsteps=13), m, coords, device=dev)
    A.reset_counts()
    B.reset_counts()
    state = sim.run(sim.prepare_state(u0, u0), src, 13)
    assert sim.engine.sweep_k >= 2 and A.launches() == 0 and A.launches("plain") == 0
    assert B.launches("plain") == 0 and {key[2:] for key in B.counts["kernel"]} == {("float32", "w")}
    _, c = sim.extract_state(state)
    _, ct, _ = tt.truth_run_ring(u0, u0, m, g, 0.3, 13, src, coords, device=dev)
    err = np.sqrt(((c - ct) ** 2).sum() / (ct**2).sum())
    assert err < 1e-5


@pytest.mark.parametrize("order,layered,kernel", [(4, False, "B"), (4, True, "B"), (12, False, "A")])
def test_bf16_paths_on_card_match_truth(dev, order, layered, kernel):
    g = tt.Grid3D(48, 40, 56, order=order)
    m = media.layered(g) if layered else np.full(g.padded_shape, 1.5, np.float32)
    coords = tt.default_source_coords(1, 48, 40, 56)
    src = tt.ricker_table(13, 1, 0.001)
    u0 = np.zeros(g.padded_shape, np.float32)
    sim = tt.Simulator(g, tt.SimConfig(nsteps=13, storage_dtype="bfloat16"), m, coords,
                       device=dev)
    A.reset_counts()
    B.reset_counts()
    state = sim.run(sim.prepare_state(u0, u0), src, 13)
    assert A.launches("plain") == 0 and B.launches("plain") == 0
    assert (A.launches() > 0, B.launches() > 0) == (kernel == "A", kernel == "B")
    c = sim.extract_state(state)[1]
    _, ct, _ = tt.truth_run_ring(u0, u0, m, g, 0.001, 13, src, coords, device=dev)
    err = np.sqrt(((c - ct) ** 2).sum() / (ct**2).sum())
    assert err < 5e-2


def test_launch_failure_raises(dev):
    from tpufdtd_torch.ops import _build

    g = tt.Grid3D(16, 16, 16)
    U = torch.zeros((2,) + g.padded_shape, device=dev)
    out = U.clone()
    with pytest.raises(ValueError):  # beyond its threads' cells: refused before launch
        B.sweep_fused(U, out, grid=g, dt=1e-3, m_val=1.5, k_fuse=2, tile=(64, 64, 32))
    # a depth the library does not build: the C entry's code raises
    code = _build.library().tpufdtd_sweep(
        U.data_ptr(), out.data_ptr(), None, 16, 16, 16, g.halo, 2, 7, 1, 0, 64, 8, 32,
        0, 0, 0, 0, g.padded_shape[0], _build.coeff_array([0.0] * 16),
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(ValueError, match="depth K = 7"):
        _build.check(code, "sweep_fused")
    # more x-chunks than a grid may have blocks along z: the launch fails
    gx = tt.Grid3D(65600, 8, 8)
    Ux = torch.zeros((2,) + gx.padded_shape, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        B.sweep_fused(Ux, Ux.clone(), grid=gx, dt=1e-3, m_val=1.5, k_fuse=1, tile=(1, 8, 8))


@pytest.mark.parametrize("radius,dtype", [(1, torch.float32), (2, torch.float32),
                                          (3, torch.float32), (4, torch.float32),
                                          (1, torch.bfloat16), (2, torch.bfloat16),
                                          (3, torch.bfloat16)])
def test_kernel_b_k1_region_starts_off_16_bytes(dev, radius, dtype):
    """K = 1: a region starts at z = H + bz * TZ - R, which with TZ = 20
    lies off every 16-byte boundary in every column of blocks; each row is
    staged as its aligned superset."""
    g = tt.Grid3D(40, 24, 70, order=2 * radius)
    _check_b(dev, g, 1, dtype, tile=(512, 8, 20))


@pytest.mark.parametrize("order,nz", [(2, 13), (2, 14), (2, 16), (6, 11), (6, 14), (6, 16)])
@pytest.mark.parametrize("with_w", [False, True])
def test_kernel_b_bf16_row_pitch_off_16_bytes(dev, order, nz, with_w):
    """bf16 rows of nz + 2H elements: odd (copied plainly), 2 mod 8 (4-byte
    copies) and 4 mod 8 (8-byte copies), at every K."""
    g = tt.Grid3D(19, 21, nz, order=order)
    assert (nz + 2 * g.halo) % 8 != 0
    for k in range(1, B.k_max(g.radius) + 1):
        _check_b(dev, g, k, torch.bfloat16, with_w)


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_kernel_b_grid_narrower_than_one_tile(dev, radius):
    """ny and nz below every tile's TY and TZ: one block column, clipped."""
    g = tt.Grid3D(40, 5, 6, order=2 * radius)
    for k in range(1, B.k_max(radius) + 1):
        _check_b(dev, g, k)


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_kernel_b_nx_not_a_multiple_of_xc(dev, radius):
    """nx = 300 in x-chunks of 128 (a short third chunk) and of TILES' XC."""
    g = tt.Grid3D(300, 16, 24, order=2 * radius)
    for k in range(1, B.k_max(radius) + 1):
        _check_b(dev, g, k, tile=(128,) + B.tile_for(radius, k)[1:])
        _check_b(dev, g, k)


def test_smem_bytes_is_what_the_launch_requests(dev):
    """ops/stencil_sweep.smem_bytes states the launch's own expression, and
    cells_per_thread and min_blocks the kernel's register policy."""
    import ctypes

    from tpufdtd_torch.ops import _build

    lib = _build.library()
    deep = [((r, k), (64, ty, tz)) for (r, k), shapes in B.DEEP_SHAPES.items()
            for ty, tz in shapes]
    for (r, k), tile in list(B.TILES.items()) + deep:
        smem = B.deep_smem_bytes if (r, k) in B.DEEP_TILES else B.smem_bytes
        for storage in ("float32", "bfloat16"):
            for medium in ("m", "w"):
                want = smem(r, k, tile, storage, medium)
                got = lib.tpufdtd_sweep_smem(r, k, tile[1], tile[2], int(storage == "bfloat16"),
                                             int(medium == "w"))
                assert got == want
        if (r, k) in B.TILES:
            policy = (ctypes.c_int * 2)()
            lib.tpufdtd_sweep_policy(r, k, policy)
            assert list(policy) == [B.cells_per_thread(r, k), B.min_blocks(r, k)]


# ---- kernel B's deep form (K = 5-6 at R = 1-2, K = 3-4 at R = 3) -------------


@pytest.mark.parametrize("dtype,with_w", [(torch.float32, False)] + MODES)
@pytest.mark.parametrize("radius,k", sorted(B.DEEP_TILES))
@pytest.mark.parametrize("shape,h", [((64, 64, 64), (0.1, 0.1, 0.1)),
                                     ((17, 13, 11), (0.1, 0.05, 0.2)),
                                     ((1100, 12, 20), (0.1, 0.1, 0.1))])
def test_kernel_b_deep_matches_plain(dev, dtype, with_w, radius, k, shape, h):
    """The deep form in every mode, isotropic and anisotropic h, on shapes
    narrower than one block's column and over several x-chunks."""
    _check_b(dev, tt.Grid3D(*shape, hx=h[0], hy=h[1], hz=h[2], order=2 * radius), k, dtype,
             with_w)


@pytest.mark.parametrize("radius,k,ty,tz", [(r, k, ty, tz) for (r, k), shapes in
                                             sorted(B.DEEP_SHAPES.items()) for ty, tz in shapes])
@pytest.mark.parametrize("dtype,with_w", [(torch.float32, False), (torch.bfloat16, True)])
def test_kernel_b_deep_every_built_tile_matches_plain(dev, radius, k, ty, tz, dtype, with_w):
    """Every tile the deep form is built for (the template's instantiations,
    which tile_probe times), over two block columns a side and three
    x-chunks, anisotropic h."""
    g = tt.Grid3D(70, ty + 9, tz + 5, hx=0.1, hy=0.05, hz=0.2, order=2 * radius)
    _check_b(dev, g, k, dtype, with_w, tile=(32, ty, tz))


@pytest.mark.parametrize("radius,k", sorted(B.DEEP_TILES))
@pytest.mark.parametrize("dtype,with_w", [(torch.float32, False), (torch.bfloat16, True)])
def test_kernel_b_deep_frozen_margins_match_plain(dev, radius, k, dtype, with_w):
    """Margins on x and y at every deep (R, K): frozen cells bitwise u_n."""
    g = tt.Grid3D(40, 24, 70, order=2 * radius)
    frozen = {"frozen_lo": 2, "frozen_hi": 3, "frozen_ylo": 1, "frozen_yhi": 2}
    gen = torch.Generator(device=dev).manual_seed(9 * k + radius)
    U = torch.randn((2,) + g.padded_shape, generator=gen, device=dev)
    mask = _mask(g, dev)
    U[0][~mask] = U[1][~mask]
    U = U.to(dtype)
    w = _w(g, dev, gen) if with_w else None
    out = U.clone()
    out[:, mask] = 7.0
    got = B.sweep_fused(U, out.clone(), grid=g, dt=DT, m_val=1.5, k_fuse=k, w=w, **frozen)
    want = B.sweep_fused_ref(U, grid=g, dt=DT, m_val=1.5, k_fuse=k, w=w, **frozen)
    torch.cuda.synchronize()
    for sl in B.frozen_slices(g, tuple(frozen.values())):
        assert torch.equal(got[0][sl], U[1][sl]) and torch.equal(got[1][sl], U[1][sl])
    Uf = U.float()
    d = Uf[1] - Uf[0]
    _close(got, want, torch.stack([Uf[1] + (k - 1) * d, Uf[1] + k * d]), out, mask)


def test_kernel_b_deep_launch_refusals(dev):
    """The deep form refuses what it cannot run: a tile it is not built for
    (before the launch, and in the C entry's code) and a depth built in
    neither form (the C entry's code). More x-chunks than a grid may have
    blocks along z are no refusal: its grid is one block an SM, each walking
    its share of the segments."""
    from tpufdtd_torch.ops import _build

    g = tt.Grid3D(16, 16, 16)
    U = torch.zeros((2,) + g.padded_shape, device=dev)
    out = U.clone()
    assert (32, 32) not in B.DEEP_SHAPES[2, 6]
    with pytest.raises(ValueError, match="deep form is built for"):
        B.sweep_fused(U, out, grid=g, dt=1e-3, m_val=1.5, k_fuse=6, tile=(64, 32, 32))
    code = _build.library().tpufdtd_sweep(
        U.data_ptr(), out.data_ptr(), None, 16, 16, 16, g.halo, 2, 6, 1, 0, 64, 32, 32,
        0, 0, 0, 0, g.padded_shape[0], _build.coeff_array([0.0] * 16),
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(ValueError, match="not built for this block shape"):
        _build.check(code, "sweep_fused")
    g6 = tt.Grid3D(16, 16, 16, order=6)
    U6 = torch.zeros((2,) + g6.padded_shape, device=dev)
    out6 = U6.clone()
    code = _build.library().tpufdtd_sweep(
        U6.data_ptr(), out6.data_ptr(), None, 16, 16, 16, g6.halo, 3, 5, 1, 0, 64, 16, 32,
        0, 0, 0, 0, g6.padded_shape[0], _build.coeff_array([0.0] * 16),
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(ValueError, match="depth K = 5"):
        _build.check(code, "sweep_fused")
    _check_b(dev, tt.Grid3D(65600, 8, 8), 6, tile=(1,) + B.DEEP_SHAPES[2, 6][0])


@pytest.mark.parametrize("storage,with_w", [("float32", False), ("bfloat16", True)])
def test_kernel_b_deep_on_x_slabs_is_bitwise_whole_arrays(dev, storage, with_w):
    """The deep form (R = 2, K = 6) on x-slab views of larger two-level
    arrays computes bit for bit what it computes on contiguous copies, and
    writes nothing outside the slab's interior."""
    big = tt.Grid3D(60, 24, 40)
    gen = torch.Generator(device=dev).manual_seed(23)
    U = torch.randn((2,) + big.padded_shape, generator=gen, device=dev)
    U = U.to(getattr(torch, storage))
    out = torch.zeros_like(U)
    a, b = 7, 7 + 30 + 2 * big.halo
    g = tt.Grid3D(30, 24, 40)
    w = None
    if with_w:
        w = torch.as_tensor(B.w_stream(big, DT, media.layered(big)), device=dev)[a:b]
    B.sweep_fused(U[:, a:b], out[:, a:b], grid=g, dt=DT, m_val=1.5, k_fuse=6, w=w,
                  frozen_hi=2, frozen_ylo=1)
    want = torch.zeros((2,) + g.padded_shape, device=dev, dtype=U.dtype)
    B.sweep_fused(U[:, a:b].contiguous(), want, grid=g, dt=DT, m_val=1.5, k_fuse=6,
                  w=None if w is None else w.contiguous(), frozen_hi=2, frozen_ylo=1)
    torch.cuda.synchronize()
    assert torch.equal(out[:, a:b], want)
    rest = torch.ones(out.shape[1], dtype=torch.bool, device=dev)
    rest[a + g.halo: b - g.halo] = False
    assert not bool(out[:, rest].any())


# ---- kernel B's frozen margins and the sharded engines -----------------------


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("dtype,with_w", [(torch.float32, False), (torch.float32, True),
                                          (torch.bfloat16, False), (torch.bfloat16, True)])
def test_kernel_b_frozen_margins_match_plain(dev, k, radius, dtype, with_w):
    """Margins on x and y (the sharded sweep's edge shards): the kernel
    against its plain version with the same margins; every frozen cell holds
    u_n in both output levels, bit for bit, although `out` starts as
    something else there."""
    g = tt.Grid3D(40, 24, 70, order=2 * radius)
    frozen = {"frozen_lo": 2, "frozen_hi": 3, "frozen_ylo": 1, "frozen_yhi": 2}
    gen = torch.Generator(device=dev).manual_seed(7 * k + radius)
    U = torch.randn((2,) + g.padded_shape, generator=gen, device=dev)
    mask = _mask(g, dev)
    U[0][~mask] = U[1][~mask]
    U = U.to(dtype)
    w = _w(g, dev, gen) if with_w else None
    out = U.clone()
    out[:, mask] = 7.0
    key = B.mode_key(g, k, U, w)
    before = B.frozen_counts[key]
    got = B.sweep_fused(U, out.clone(), grid=g, dt=DT, m_val=1.5, k_fuse=k, w=w, **frozen)
    assert B.frozen_counts[key] == before + 1
    want = B.sweep_fused_ref(U, grid=g, dt=DT, m_val=1.5, k_fuse=k, w=w, **frozen)
    torch.cuda.synchronize()
    for sl in B.frozen_slices(g, tuple(frozen.values())):
        assert torch.equal(got[0][sl], U[1][sl]) and torch.equal(got[1][sl], U[1][sl])
    Uf = U.float()
    d = Uf[1] - Uf[0]
    _close(got, want, torch.stack([Uf[1] + (k - 1) * d, Uf[1] + k * d]), out, mask)


def _zero_rim_pair(g, seed):
    rng = np.random.default_rng(seed)
    h = g.halo
    out = []
    for _ in range(2):
        a = np.zeros(g.padded_shape, np.float32)
        a[h:-h, h:-h, h:-h] = rng.standard_normal((g.nx, g.ny, g.nz))
        out.append(a)
    return out


@pytest.mark.parametrize("shape", [None, (2, 2)])
@pytest.mark.parametrize("storage,layered", [("float32", False), ("float32", True),
                                             ("bfloat16", False)])
def test_sharded_sweep_on_card_is_bitwise_single_device(dev, shape, storage, layered):
    """Four shards on one card, no sources: the sharded sweep's u_N is
    bitwise the single-device sweep's at the same depth, and every kernel-B
    launch of it ran on the card, the edge shards' with frozen margins."""
    from tpufdtd_torch.parallel import ShardedSimulator, make_mesh

    g = tt.Grid3D(64, 48, 40)
    m = media.layered(g) if layered else np.full(g.padded_shape, 1.5, np.float32)
    up, uc = _zero_rim_pair(g, 5)
    cfg = tt.SimConfig(nsteps=9, storage_dtype=storage)
    mesh = make_mesh(shape=shape, devices=[dev] * 4) if shape else make_mesh(devices=[dev] * 4)
    sim = ShardedSimulator(g, cfg, m, mesh)
    B.reset_counts()
    st, ms, pk = sim.prepare(up, uc, m)
    p, c = sim.extract_state(sim.run(st, ms, pk, None, 9))
    assert B.launches("plain") == 0 and B.launches("frozen") > 0
    s1 = tt.Simulator(g, cfg, m, device=dev)
    assert s1.engine.sweep_k == sim.sweep.K
    p1, c1 = s1.extract_state(s1.run(s1.prepare_state(up, uc), None, 9))
    assert np.array_equal(c, c1) and np.array_equal(p, p1)


def test_sharded_per_step_on_card_matches_single_device(dev):
    """The per-step engine at order 8, four shards on kernel A: bitwise the
    single-device exact ring."""
    from tpufdtd_torch.parallel import make_mesh, simulate_sharded

    g = tt.Grid3D(64, 40, 36, order=8)
    m = np.full(g.padded_shape, 1.5, np.float32)
    up, uc = _zero_rim_pair(g, 6)
    coords = np.array([[3.15, 2.0, 1.8]], np.float32)  # x = 31.5 cells: shards 1 | 2
    src = tt.ricker_table(7, 1, 0.001)
    cfg = tt.SimConfig(nsteps=7, ring="exact")
    A.reset_counts()
    ring = simulate_sharded(up, uc, m, g, cfg, make_mesh(devices=[dev] * 4), src, coords)
    assert A.launches() == 28 and A.launches("plain") == 0
    ring1 = tt.simulate_ring(up, uc, m, g, cfg, src, coords, device=dev)
    for a, b in zip(ring, ring1):
        assert np.array_equal(a, b)


# ---- the reference ABI, checkpoints and the sharded sweep's overlap -----------


@pytest.mark.parametrize("storage,with_w", [("float32", False), ("float32", True),
                                            ("bfloat16", False)])
def test_kernel_b_on_x_slabs_is_bitwise_whole_arrays(dev, storage, with_w):
    """Kernel B on x-slab views of larger two-level arrays (the overlap's
    slabs; the C entry's level stride) computes bit for bit what it computes
    on contiguous copies of the slabs, and writes nothing outside the
    slab's interior."""
    big = tt.Grid3D(60, 24, 40)
    gen = torch.Generator(device=dev).manual_seed(21)
    U = torch.randn((2,) + big.padded_shape, generator=gen, device=dev).to(getattr(torch, storage))
    out = torch.zeros_like(U)
    a, b = 7, 7 + 30 + 2 * big.halo
    g = tt.Grid3D(30, 24, 40)
    w = None
    if with_w:
        w_big = torch.as_tensor(B.w_stream(big, DT, media.layered(big)), device=dev)
        w = w_big[a:b]
    B.sweep_fused(U[:, a:b], out[:, a:b], grid=g, dt=DT, m_val=1.5, k_fuse=2, w=w,
                  frozen_hi=2, frozen_ylo=1)
    want = torch.zeros((2,) + g.padded_shape, device=dev, dtype=U.dtype)
    B.sweep_fused(U[:, a:b].contiguous(), want, grid=g, dt=DT, m_val=1.5, k_fuse=2,
                  w=None if w is None else w.contiguous(), frozen_hi=2, frozen_ylo=1)
    torch.cuda.synchronize()
    assert torch.equal(out[:, a:b], want)
    rest = torch.ones(out.shape[1], dtype=torch.bool, device=dev)
    rest[a + g.halo: b - g.halo] = False
    assert not bool(out[:, rest].any())


def test_kernel_cuda_on_card(dev):
    """The reference ABI on kernel A: every exit slot bitwise simulate_ring
    on the card and within the gate of the f64 truth."""
    from tpufdtd_torch.compat import Profiler, kernel_cuda

    g = tt.Grid3D(48, 40, 36)
    m = np.full(g.padded_shape, 1.5, np.float32)
    u = np.zeros((3,) + g.padded_shape, np.float32)
    src = tt.ricker_table(12, 1, 0.001)
    coords = tt.default_source_coords(1, 48, 40, 36)
    timers = Profiler()
    A.reset_counts()
    kernel_cuda(m, src, coords, u, 47, 0, 39, 0, 35, 0, 0.001, 0.1, 0.1, 0.1, 0.0, 0.0, 0.0,
                0, 0, 11, 0, timers=timers, device=dev)
    assert A.launches() == 12 and A.launches("plain") == 0 and timers.section0 > 0
    z = np.zeros(g.padded_shape, np.float32)
    ring = tt.simulate_ring(z, z, m, g, tt.SimConfig(nsteps=12), src, coords, device=dev)
    truth = tt.truth_run_ring(z, z, m, g, 0.001, 12, src, coords, device=dev)
    # (u_{N-1}, u_N, u_{N-2}) sit in slots time_M % 3, (time_M + 1) % 3, (time_M + 2) % 3
    for slot, want, t in zip((11 % 3, 12 % 3, 13 % 3), ring, truth):
        assert np.array_equal(u[slot], want)
        assert np.sqrt(((u[slot] - t) ** 2).sum() / (t**2).sum()) < 1e-4


def test_checkpoint_resume_on_card(dev, tmp_path):
    """The fast ring on kernel B checkpointed at step 6 (a multiple of K)
    and resumed from the file on a fresh Simulator: bitwise the unbroken
    run."""
    from tpufdtd_torch import checkpoint as ck

    g = tt.Grid3D(48, 40, 36)
    m = np.full(g.padded_shape, 1.5, np.float32)
    u0 = np.zeros(g.padded_shape, np.float32)
    src = tt.ricker_table(14, 1, 0.001)
    coords = tt.default_source_coords(1, 48, 40, 36)
    cfg = tt.SimConfig(nsteps=14)
    sim = tt.Simulator(g, cfg, m, coords, device=dev)
    ref = sim.extract_state(sim.run(sim.prepare_state(u0, u0), src, 14))
    fmt = str(tmp_path / "ck_{step:06d}.npz")
    B.reset_counts()
    ck.run_with_checkpoints(sim, u0, u0, 14, src=src, checkpoint_every=6, path_fmt=fmt)
    p, c = ck.resume(fmt.format(step=6), cfg, m, 14, src=src, src_coords=coords, device=dev)
    assert B.launches() > 0 and B.launches("plain") == 0
    assert np.array_equal(c, ref[1]) and np.array_equal(p, ref[0])


def _overlap_run(dev, overlap, storage="float32", layered=False, nsteps=7):
    from tpufdtd_torch.parallel import ShardedSimulator, make_mesh

    g = tt.Grid3D(128, 48, 40)
    m = media.layered(g) if layered else np.full(g.padded_shape, 1.5, np.float32)
    up, uc = _zero_rim_pair(g, 8)
    src = tt.ricker_table(nsteps, 1, 0.001)
    coords = np.array([[6.43, 2.0, 1.8]], np.float32)  # x = 64.3 cells: shards 1 | 2
    cfg = tt.SimConfig(nsteps=nsteps, storage_dtype=storage, overlap=overlap)
    sim = ShardedSimulator(g, cfg, m, make_mesh(devices=[dev] * 4), coords)
    assert sim.sweep.overlap == (overlap == "on")
    st, ms, pk = sim.prepare(up, uc, m)
    return sim.extract_state(sim.run(st, ms, pk, src, nsteps))


@pytest.mark.parametrize("storage,layered", [("float32", False), ("float32", True),
                                             ("bfloat16", False)])
def test_overlap_on_card_is_bitwise_off(dev, storage, layered):
    on = _overlap_run(dev, "on", storage, layered)
    off = _overlap_run(dev, "off", storage, layered)
    assert all(np.array_equal(a, b) for a, b in zip(on, off))


def test_overlap_interior_slab_does_not_wait_on_the_exchange(dev, monkeypatch):
    """The x exchange is held back on its side stream (a device sleep before
    its copies): the interior slabs' kernels finish while it still sleeps,
    so their launch waits on the y exchange only; the edge slabs wait for
    the exchange, and the result is bitwise the serial order's."""
    marks = {}

    def monkey(sw):
        real_x, real_kern = sw._exchange_x, sw._kern

        def slow_exchange(Us):
            torch.cuda._sleep(1_000_000_000)  # ~0.5 s at the H100's clock
            real_x(Us)
            marks["x"] = torch.cuda.Event()
            marks["x"].record()

        def kern(U, out, dx, dy, kk, part="all"):
            r = real_kern(U, out, dx, dy, kk, part)
            if part == "mid":
                marks["mid"] = torch.cuda.Event()
                marks["mid"].record()
            return r

        monkeypatch.setattr(sw, "_exchange_x", slow_exchange)
        monkeypatch.setattr(sw, "_kern", kern)

    from tpufdtd_torch.parallel import ShardedSimulator, make_mesh

    g = tt.Grid3D(128, 48, 40)
    m = np.full(g.padded_shape, 1.5, np.float32)
    up, uc = _zero_rim_pair(g, 9)
    sims = {}
    for overlap in ("on", "off"):
        sim = ShardedSimulator(g, tt.SimConfig(nsteps=2, overlap=overlap), m,
                               make_mesh(devices=[dev] * 4))
        if overlap == "on":
            monkey(sim.sweep)
        st, ms, pk = sim.prepare(up, uc, m)
        torch.cuda.synchronize()
        st = sim._eager_span(st, ms, pk, None, 2)()  # one overlapped block, eagerly
        if overlap == "on":
            marks["mid"].synchronize()
            assert not marks["x"].query(), "the interior slabs waited on the x exchange"
        torch.cuda.synchronize()
        sims[overlap] = sim.extract_state(st)
    assert all(np.array_equal(a, b) for a, b in zip(sims["on"], sims["off"]))


# The Simulator's captured spans (stepper.Simulator.graphs): each replay is
# bitwise the engine's eager loop on a copy of the same state with the same
# source rows, since it replays the same launches in the same order.
GRAPH_N, GRAPH_STEPS = 64, 13  # 13 steps: a K = 2 span ends on a K = 1 block
GRAPH_CASES = {  # name -> (order, layered, storage, t_fuse, ring): every mode and both forms
    "order4": (4, False, "float32", 0, "auto"),
    "order2_deep_k6": (2, False, "float32", 0, "auto"),
    "order6_deep_k3": (6, False, "float32", 0, "auto"),
    "order4_t_fuse5_deep": (4, False, "float32", 5, "auto"),
    "order8_k1": (8, False, "float32", 0, "auto"),
    "order8_t_fuse2": (8, False, "float32", 2, "auto"),
    "order12_exact": (12, False, "float32", 0, "auto"),
    "order4_exact": (4, False, "float32", 0, "exact"),
    "order4_layered_w": (4, True, "float32", 0, "auto"),
    "order8_layered_exact": (8, True, "float32", 0, "auto"),
    "order4_bf16": (4, False, "bfloat16", 0, "auto"),
    "order4_layered_bf16": (4, True, "bfloat16", 0, "auto"),
    "order12_bf16_exact": (12, False, "bfloat16", 0, "auto"),
}


def _graph_sim(dev, order=4, layered=False, storage="float32", t_fuse=0, ring="auto",
               nsteps=GRAPH_STEPS, warmup=5):
    n = GRAPH_N
    g = tt.Grid3D(n, n, n, order=order)
    m = media.layered(g) if layered else np.full(g.padded_shape, 1.5, np.float32)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, warmup_steps=warmup, storage_dtype=storage,
                       t_fuse=t_fuse, ring=ring)
    sim = tt.Simulator(g, cfg, m, tt.default_source_coords(1, n, n, n), device=dev)
    assert sim.graphs is not None
    return sim, sim.prepare_state(*_zero_rim_pair(g, order))


def _bitwise(a, b):
    torch.cuda.synchronize()
    return isinstance(a, dict) == isinstance(b, dict) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(_buffers(a), _buffers(b)))


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_replay_is_bitwise_eager(dev, case):
    sim, state = _graph_sim(dev, *GRAPH_CASES[case])
    src = tt.ricker_table(GRAPH_STEPS, 1, 0.001)
    twin = Simulator._copy(state)
    ptrs = {b.data_ptr() for b in _buffers(state)}
    for _ in range(2):  # the second span starts from the roles the first returned
        state = sim.run(state, src, GRAPH_STEPS)
        twin = eager_run(sim, twin, src, [GRAPH_STEPS])
        assert _bitwise(state, twin)
        assert {b.data_ptr() for b in _buffers(state)} == ptrs  # advanced in place
    assert 1 <= len(sim.graphs) <= 2


def test_graph_takes_each_source_table_on_the_same_buffers(dev):
    sim, state = _graph_sim(dev)
    start = Simulator._copy(state)
    tables = [tt.ricker_table(GRAPH_STEPS, 1, 0.001), -3.0 * tt.ricker_table(GRAPH_STEPS, 1, 0.002)]
    outs = []
    for src in tables:
        for b, v in zip(_buffers(state), _buffers(start)):  # the same buffers, in the same roles
            b.copy_(v)
        out = sim.run(state, src, GRAPH_STEPS)
        assert _bitwise(out, eager_run(sim, Simulator._copy(start), src, [GRAPH_STEPS]))
        outs.append(Simulator._copy(out))
    assert len(sim.graphs) == 1 and not _bitwise(outs[0], outs[1])


@pytest.mark.parametrize("case,graphs", [("order4", 2), ("order6_deep_k3", 2),
                                         ("order12_exact", 3)])
def test_graph_replays_count_their_launches(dev, case, graphs):
    """The wrappers count at call time, which is at capture: each replay
    adds the launches its capture recorded, and a capture adds none. Three
    spans cycle the fast ring's two roles and the exact ring's three."""
    sim, state = _graph_sim(dev, *GRAPH_CASES[case])
    src = tt.ricker_table(GRAPH_STEPS, 1, 0.001)
    A.reset_counts()
    B.reset_counts()
    eager_run(sim, Simulator._copy(state), src, [GRAPH_STEPS])
    once = (dict(A.counts["kernel"]), dict(B.counts["kernel"]))
    assert sum(once[0].values()) + sum(once[1].values()) > 0
    A.reset_counts()
    B.reset_counts()
    for _ in range(3):
        state = sim.run(state, src, GRAPH_STEPS)
    assert len(sim.graphs) == graphs
    assert (dict(A.counts["kernel"]), dict(B.counts["kernel"])) == tuple(
        {k: 3 * v for k, v in c.items()} for c in once)
    assert A.launches("plain") == B.launches("plain") == 0


@pytest.mark.parametrize("case", ["order4", "order12_exact", "order4_layered_bf16"])
@pytest.mark.parametrize("q", [1, 3])
def test_run_timed_state_is_bitwise_run(dev, case, q):
    sim, state = _graph_sim(dev, *GRAPH_CASES[case])
    src = tt.ricker_table(GRAPH_STEPS, 1, 0.001)
    twin = Simulator._copy(state)
    timed, secs = sim.run_timed(state, src, timing_repeat=q)
    assert secs > 0 and sim.last_clock == "cuda_event"
    plain = sim.run(sim.run(twin, src[:5], 5), src[5:], GRAPH_STEPS - 5)
    assert _bitwise(timed, plain)


def test_graph_cache_stays_bounded(dev):
    sim, _ = _graph_sim(dev)
    src = tt.ricker_table(4, 1, 0.001)
    states = [sim.prepare_state_random(seed) for seed in range(10)]  # ten sets of buffers
    for st in states:
        sim.run(st, src, 4)
        assert len(sim.graphs) <= GRAPH_CACHE
    assert len(sim.graphs) == GRAPH_CACHE


def test_program_spans_stay_off_the_device_timeline(dev):
    """Traced with CUDA activity, a shot's ranges are host events only: no
    annotation on the device's timeline, which a reader of device intervals
    would count as device work. The transfers record their bytes, the graph
    cache counts what it captured."""
    from torch.profiler import ProfilerActivity, profile

    from tpufdtd_torch.utils import tracing

    sim, _ = _graph_sim(dev)
    src = tt.ricker_table(GRAPH_STEPS, 1, 0.001)
    levels = _zero_rim_pair(sim.grid, 4)
    state = sim.prepare_state(*levels)
    for _ in range(2):  # both roles of the fast ring's buffers captured before the trace
        state = sim.run(state, src)
    tracing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = sim.extract_state(sim.run(state, src))
        fresh = sim.prepare_state(*levels)
        torch.cuda.synchronize()
    ours = [e for e in prof.events() if e.name.startswith(tracing.PREFIX + ".")]
    assert {e.name.split(".", 1)[1] for e in ours} == {
        "run", "load", "replay", "extract_state", "d2h", "prepare_state", "rims", "h2d",
        "assemble"}  # no `stage`: on the card a level's host copies are inside its transfer
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ours)
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    moved = Counter()
    for name, _a, _b, nbytes in tracing.record:
        moved[name] += nbytes
    level = levels[0].nbytes
    assert moved == Counter(h2d=2 * level, d2h=2 * level) and len(out) == 2 and fresh
    # both spans were captured before the trace; the four levels went through the slots
    assert not tracing.counts["captures"] and not tracing.counts["evictions"]
    assert tracing.counts["staged_bytes"] == 4 * level
    assert set(tracing.counts) <= {"captures", "evictions", "staged_bytes", "staging_waits"}


STAGING_CASES = {  # name -> (order, storage, ring, backend): both rings, f32 and bf16
    "fast_f32": (4, "float32", "auto", "cuda"),
    "fast_bf16": (4, "bfloat16", "auto", "cuda"),
    "exact_f32": (4, "float32", "exact", "cuda"),
    "exact_bf16": (4, "bfloat16", "exact", "cuda"),
    "torch_f32": (4, "float32", "exact", "torch"),
}
SMALL_SLOTS = 96 << 10  # 16 chunks of a 72^3 f32 level, over 2 slots


def _staged_sim(dev, case, slot_bytes=None):
    """A Simulator of STAGING_CASES[case] on the card; with slot_bytes, its
    engine stages through two slots of that size instead of its own."""
    order, storage, ring, backend = STAGING_CASES[case]
    n = GRAPH_N
    g = tt.Grid3D(n, n, n, order=order)
    cfg = tt.SimConfig(dt=0.001, nsteps=GRAPH_STEPS, storage_dtype=storage, ring=ring,
                       backend=backend)
    sim = tt.Simulator(g, cfg, np.full(g.padded_shape, 1.5, np.float32),
                       tt.default_source_coords(1, n, n, n), device=dev)
    assert bool(getattr(sim.engine, "sweep_k", 0)) == (ring == "auto")
    if slot_bytes is not None:
        sim.engine.staging = Staging(sim.device, sim.engine.dtype, slots=2, slot_bytes=slot_bytes)
    return sim


def _unstaged(sim, levels):
    """The levels on the card by the copies without slots: a host copy in
    the storage dtype, then a pageable transfer."""
    return [torch.tensor(np.asarray(u, np.float32)).to(sim.engine.dtype).to(sim.device)
            for u in levels]


def _state_levels(state):
    return list(state["sweep"][0]) if isinstance(state, dict) else list(state)


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("slot_bytes", [None, SMALL_SLOTS])
@pytest.mark.parametrize("case", list(STAGING_CASES))
def test_staged_transfers_are_bitwise_the_unstaged(dev, case, slot_bytes):
    """prepare_state puts bitwise the levels the copies without slots put on
    the card (the fast ring's spare a copy of U), and extract_state returns
    bitwise their `.float().cpu()`, before and after a run."""
    sim = _staged_sim(dev, case, slot_bytes)
    up, uc = _zero_rim_pair(sim.grid, 11)
    state = sim.prepare_state(up, uc)
    fast = isinstance(state, dict)
    want = _unstaged(sim, (up, uc) if fast else (up, uc, uc))
    assert _bitwise(_state_levels(state), want)
    if fast:
        assert _bitwise(state["sweep"][1], state["sweep"][0])
    for _ in range(2):
        out = sim.extract_state(state)
        assert len(out) == len(want)
        assert all(_same_bits(o, x.float().cpu().numpy()) for o, x in zip(out, _state_levels(state)))
        state = sim.run(state, tt.ricker_table(GRAPH_STEPS, 1, 0.001))


@pytest.mark.parametrize("case", ["fast_f32", "exact_bf16"])
def test_back_to_back_prepares_take_no_stale_slot(dev, case):
    """Two prepare_state calls back to back with other data, more chunks a
    level than slots: each state holds its own levels."""
    sim = _staged_sim(dev, case, SMALL_SLOTS)
    st = sim.engine.staging
    assert np.prod(sim.grid.padded_shape) > 2 * st.chunk * len(st.slots)
    a, b = _zero_rim_pair(sim.grid, 12), _zero_rim_pair(sim.grid, 13)
    first = sim.prepare_state(*a)
    second = sim.prepare_state(*b)
    levels = 2 if isinstance(first, dict) else 3
    assert _bitwise(_state_levels(first), _unstaged(sim, (*a, a[1])[:levels]))
    assert _bitwise(_state_levels(second), _unstaged(sim, (*b, b[1])[:levels]))


@pytest.mark.parametrize("case", ["fast_f32", "exact_bf16"])
def test_arrays_overwritten_after_prepare_do_not_reach_the_state(dev, case):
    """prepare_state returns with transfers in flight, but no longer reads
    the arrays passed: overwriting them at once changes nothing on the card."""
    sim = _staged_sim(dev, case, SMALL_SLOTS)
    up, uc = _zero_rim_pair(sim.grid, 14)
    kept = (up.copy(), uc.copy())
    state = sim.prepare_state(up, uc)
    up.fill(np.nan)
    uc.fill(np.nan)
    levels = 2 if isinstance(state, dict) else 3
    assert _bitwise(_state_levels(state), _unstaged(sim, (*kept, kept[1])[:levels]))


@pytest.mark.parametrize("case", ["fast_f32", "fast_bf16", "exact_f32"])
def test_extract_results_share_no_memory(dev, case):
    """Two extract_state results are arrays of their own, apart from each
    other and from the slots: staging other levels after leaves them as they
    were."""
    sim = _staged_sim(dev, case, SMALL_SLOTS)
    state = sim.prepare_state(*_zero_rim_pair(sim.grid, 15))
    one, two = sim.extract_state(state), sim.extract_state(state)
    kept = [o.copy() for o in one]
    arrays = list(one) + list(two)
    slots = [s.view(torch.uint8).numpy() for s in sim.engine.staging.slots]
    assert all(a.flags.owndata for a in arrays)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(arrays) for b in arrays[i + 1:])
    assert not any(np.shares_memory(a, s) for a in arrays for s in slots)
    sim.extract_state(sim.prepare_state(*_zero_rim_pair(sim.grid, 16)))
    assert all(_same_bits(o, k) for o, k in zip(one, kept))


@pytest.mark.parametrize("case", list(STAGING_CASES))
def test_staged_bytes_count_the_levels(dev, case):
    """tracing.counts' staged_bytes is the levels' bytes in the storage
    dtype, in and out, whatever the slots; the waits are counted where a
    slot's transfer was not done."""
    from tpufdtd_torch.utils import tracing

    sim = _staged_sim(dev, case, SMALL_SLOTS)
    up, uc = _zero_rim_pair(sim.grid, 17)
    tracing.reset_counts()
    state = sim.prepare_state(up, uc)
    out = sim.extract_state(state)
    level = up.size * sim.engine.dtype.itemsize
    assert tracing.counts["staged_bytes"] == 2 * len(out) * level
    assert set(tracing.counts) <= {"staged_bytes", "staging_waits"}


@pytest.mark.parametrize("bad", ["spare_on_cpu", "spare_in_bf16", "target_on_cpu"])
def test_failed_capture_raises_and_runs_nothing(dev, bad):
    """A capture that fails (buffers off the card are refused before it, a
    bf16 spare by kernel B's wrapper inside it) raises and leaves no
    launch, write or graph: nothing retries eagerly."""
    sim, state = _graph_sim(dev, ring="exact" if bad == "target_on_cpu" else "auto")
    bufs = list(_buffers(state))
    if bad == "spare_in_bf16":
        bufs[1] = bufs[1].to(torch.bfloat16)
    else:
        bufs[-1] = bufs[-1].cpu()
    it = iter(bufs)
    state = graphs.state_of(state, lambda _: next(it))
    before = [b.clone() for b in bufs]
    A.reset_counts()
    B.reset_counts()
    with pytest.raises(ValueError):
        sim.run(state, tt.ricker_table(GRAPH_STEPS, 1, 0.001), GRAPH_STEPS)
    torch.cuda.synchronize()
    assert A.launches() == B.launches() == A.launches("plain") == B.launches("plain") == 0
    assert all(torch.equal(b, v) for b, v in zip(bufs, before))
    assert len(sim.graphs) == 0


def test_capture_records_on_the_simulators_card(dev, monkeypatch):
    """The capture runs on a side stream of the Simulator's own card (not
    torch.cuda.graph's shared default stream, made on whichever card was
    current first), and its recorded graph holds a kernel node at least for
    every launch counted; device="cuda" names the current card."""
    streams, real = [], torch.cuda.graph

    def spy(graph, **kw):
        streams.append(kw.get("stream"))
        return real(graph, **kw)

    monkeypatch.setattr(torch.cuda, "graph", spy)
    sim, state = _graph_sim(dev)
    sim.run(state, tt.ricker_table(GRAPH_STEPS, 1, 0.001), GRAPH_STEPS)
    assert len(streams) == 1 and streams[0] is not None and streams[0].device == sim.device
    (g,) = sim.graphs.values()
    launched = sum(g.deltas[0].values()) + sum(g.deltas[2].values())
    assert g.nodes >= g.kernels >= launched > 0
    assert graphs.graph_nodes(g.graph) == (g.nodes, g.kernels)
    g1 = tt.Grid3D(16, 16, 16)
    plain = tt.Simulator(g1, tt.SimConfig(), np.full(g1.padded_shape, 1.5, np.float32),
                         device="cuda")
    assert plain.device == torch.device("cuda", torch.cuda.current_device())


def test_capture_with_fewer_kernels_than_counted_raises(dev, monkeypatch):
    """A recorded graph that holds fewer kernel nodes than the wrappers
    counted at capture (its launches went elsewhere) raises, keeps no graph
    and counts nothing."""
    sim, state = _graph_sim(dev)
    before = Simulator._copy(state)
    monkeypatch.setattr(graphs, "graph_nodes", lambda graph: (0, 0))
    A.reset_counts()
    B.reset_counts()
    with pytest.raises(RuntimeError, match="recorded 0 nodes"):
        sim.run(state, tt.ricker_table(GRAPH_STEPS, 1, 0.001), GRAPH_STEPS)
    assert A.launches() == B.launches() == 0 and len(sim.graphs) == 0
    assert _bitwise(state, before)


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two CUDA cards: a Simulator on a card that is not current")
@pytest.mark.parametrize("case", ["order4", "order12_exact"])
def test_graph_on_a_card_that_is_not_current(case):
    """A Simulator on cuda:1 while cuda:0 is current captures, replays and
    times on cuda:1: each span is bitwise the eager loop, and cuda:0 stays
    current."""
    torch.cuda.set_device(0)
    sim, state = _graph_sim(torch.device("cuda", 1), *GRAPH_CASES[case])
    src = tt.ricker_table(GRAPH_STEPS, 1, 0.001)
    twin = Simulator._copy(state)
    for _ in range(2):
        state = sim.run(state, src, GRAPH_STEPS)
        twin = eager_run(sim, twin, src, [GRAPH_STEPS])
        torch.cuda.synchronize(1)
        assert _bitwise(state, twin)
    timed, secs = sim.run_timed(Simulator._copy(twin), src)
    plain = sim.run(sim.run(Simulator._copy(twin), src[:5], 5), src[5:], GRAPH_STEPS - 5)
    torch.cuda.synchronize(1)
    assert secs > 0 and _bitwise(timed, plain)
    assert torch.cuda.current_device() == 0
    assert all(g.nodes > 0 for g in sim.graphs.values())


# The ShardedSimulator's captured spans (parallel/sharded.py): four shards on
# one card replay one graph per span, bitwise the eager loop (_enqueue) on a
# copy of the state with the same source rows; 7 steps end the K = 2 sweep on
# a short block, 50 are the main path's span.
SHARDED_GRAPH_N = 64
SHARDED_GRAPH_CASES = {  # name -> (order, mesh shape, layered, storage, overlap)
    "x4_order4": (4, None, False, "float32", "auto"),
    "2x2_order4": (4, (2, 2), False, "float32", "auto"),
    "x4_order4_layered": (4, None, True, "float32", "auto"),
    "x4_order4_bf16": (4, None, False, "bfloat16", "auto"),
    "x4_order4_overlap_on": (4, None, False, "float32", "on"),
    "x4_order8_per_step": (8, None, False, "float32", "auto"),
}


def _sharded_sim(devices, order=4, shape=None, layered=False, storage="float32",
                 overlap="auto"):
    from tpufdtd_torch.parallel import ShardedSimulator, make_mesh

    n = SHARDED_GRAPH_N
    g = tt.Grid3D(n, n, n, order=order)
    m = media.layered(g) if layered else np.full(g.padded_shape, 1.5, np.float32)
    cfg = tt.SimConfig(dt=0.001, storage_dtype=storage, overlap=overlap)
    sim = ShardedSimulator(g, cfg, m, make_mesh(shape=shape, devices=devices),
                           tt.default_source_coords(1, n, n, n))
    state, m_sh, terms = sim.prepare(*_zero_rim_pair(g, order), m)
    assert isinstance(state, dict) == (order <= 4)
    assert order <= 4 or terms is not None
    return sim, state, m_sh, terms


def _sharded_eager(sim, state, m_sh, terms, src, spans):
    from tpufdtd_torch.harness.perf_sharded import eager_run

    with graphs.counts_kept():
        return eager_run(sim, state, m_sh, terms, src, spans)


@pytest.mark.parametrize("nsteps", [7, 50])
@pytest.mark.parametrize("case", list(SHARDED_GRAPH_CASES))
def test_sharded_graph_replay_is_bitwise_eager(dev, case, nsteps):
    sim, state, m_sh, terms = _sharded_sim([dev] * 4, *SHARDED_GRAPH_CASES[case])
    assert sim.graphs is not None and sim.graphs.device == dev
    if "overlap" in case:
        assert sim.sweep.overlap
    src = tt.ricker_table(nsteps, 1, 0.001)
    twin = graphs.copy_state(state)
    ptrs = {b.data_ptr() for b in _buffers(state)}
    for _ in range(2):  # the second span starts from the roles the first returned
        state = sim.run(state, m_sh, terms, src, nsteps)
        twin = _sharded_eager(sim, twin, m_sh, terms, src, [nsteps])
        assert _bitwise(state, twin)
        assert {b.data_ptr() for b in _buffers(state)} == ptrs  # advanced in place
    assert 1 <= len(sim.graphs) <= 2
    for g in sim.graphs.values():
        launched = sum(g.deltas[0].values()) + sum(g.deltas[2].values())
        assert g.nodes >= g.kernels >= launched > 0


def test_sharded_graph_takes_each_source_table_on_the_same_buffers(dev):
    for case in ("x4_order4", "x4_order8_per_step"):
        sim, state, m_sh, terms = _sharded_sim([dev] * 4, *SHARDED_GRAPH_CASES[case])
        start = graphs.copy_state(state)
        tables = [tt.ricker_table(7, 1, 0.001), -3.0 * tt.ricker_table(7, 1, 0.002)]
        outs = []
        for src in tables:
            for b, v in zip(_buffers(state), _buffers(start)):
                b.copy_(v)
            out = sim.run(state, m_sh, terms, src, 7)
            assert _bitwise(out, _sharded_eager(sim, graphs.copy_state(start), m_sh, terms, src,
                                                [7]))
            outs.append(graphs.copy_state(out))
        assert len(sim.graphs) == 1 and not _bitwise(outs[0], outs[1]), case


@pytest.mark.parametrize("case", ["x4_order4", "2x2_order4", "x4_order4_overlap_on",
                                  "x4_order8_per_step"])
def test_sharded_graph_replays_count_their_launches(dev, case):
    """Per replay the launches the eager loop counts, kernel B's
    frozen-margin launches included; a capture counts none."""
    sim, state, m_sh, terms = _sharded_sim([dev] * 4, *SHARDED_GRAPH_CASES[case])
    src = tt.ricker_table(12, 1, 0.001)  # 12 steps return every buffer to its role
    A.reset_counts()
    B.reset_counts()
    from tpufdtd_torch.harness.perf_sharded import eager_run

    eager_run(sim, graphs.copy_state(state), m_sh, terms, src, [12])
    once = [dict(c) for c in graphs.counters()]
    assert sum(once[0].values()) + sum(once[2].values()) > 0
    assert (sum(once[4].values()) > 0) == (case != "x4_order8_per_step")
    A.reset_counts()
    B.reset_counts()
    for _ in range(3):
        state = sim.run(state, m_sh, terms, src, 12)
    assert len(sim.graphs) == 1
    assert [dict(c) for c in graphs.counters()] == [{k: 3 * v for k, v in c.items()}
                                                    for c in once]


def test_sharded_timed_run_captures_before_its_first_event(dev, monkeypatch):
    """perf_sharded.timed_run times a replay alone: no capture between its
    CUDA events, in the warm-up's or the timed span's graph."""
    from tpufdtd_torch.harness import perf_sharded

    sim, _, _, _ = _sharded_sim([dev] * 4)
    spans, real = [], perf_sharded.timed_span

    def spy(s, fn):
        before, launches = len(s.graphs), B.launches()
        out = real(s, fn)
        spans.append((before, len(s.graphs), B.launches() - launches))
        return out

    monkeypatch.setattr(perf_sharded, "timed_span", spy)
    cfg = dataclasses.replace(sim.cfg, nsteps=13, warmup_steps=5)
    src = tt.ricker_table(13, 1, 0.001)
    m = np.full(sim.grid.padded_shape, 1.5, np.float32)
    for seed in range(2):
        assert perf_sharded.timed_run(sim, sim.grid, cfg, src, seed, m) > 0
    assert len(spans) == 2 and all(a == b > 0 and n > 0 for a, b, n in spans)


@pytest.mark.parametrize("case", ["x4_order4_overlap_on", "x4_order8_per_step"])
def test_sharded_eager_loop_makes_no_implicit_sync(dev, case):
    """A synchronisation inside the sharded loop would end a capture."""
    sim, state, m_sh, terms = _sharded_sim([dev] * 4, *SHARDED_GRAPH_CASES[case])
    go = sim._eager_span(state, m_sh, terms, tt.ricker_table(7, 1, 0.001), 7)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        go()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["x4_order4", "x4_order4_overlap_on", "x4_order8_per_step"])
def test_sharded_graph_on_cards_that_are_not_current(case):
    """Four shards on cuda:1 while cuda:0 is current capture and replay on
    cuda:1, bitwise the eager loop, and cuda:0 stays current; shards on two
    cards take the eager route (sharded.graphed) and give the same bits."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: shards on a card that is not current")
    torch.cuda.set_device(0)
    one = torch.device("cuda", 1)
    src = tt.ricker_table(7, 1, 0.001)
    sim, state, m_sh, terms = _sharded_sim([one] * 4, *SHARDED_GRAPH_CASES[case])
    twin = graphs.copy_state(state)
    state = sim.run(state, m_sh, terms, src, 7)
    twin = _sharded_eager(sim, twin, m_sh, terms, src, [7])
    torch.cuda.synchronize(1)
    assert sim.graphs.device == one and len(sim.graphs) == 1 and _bitwise(state, twin)
    assert torch.cuda.current_device() == 0
    cards = [torch.device("cuda", i) for i in (0, 0, 1, 1)]
    sim2, state2, m_sh2, terms2 = _sharded_sim(cards, *SHARDED_GRAPH_CASES[case])
    assert sim2.graphs is None
    got = sim2.extract_state(sim2.run(state2, m_sh2, terms2, src, 7))
    assert all(np.array_equal(a, b) for a, b in zip(got, sim.extract_state(state)))


@pytest.mark.parametrize("case", ["order4", "order2_deep_k6", "order12_exact",
                                  "order4_layered_bf16"])
def test_eager_loop_makes_no_implicit_sync(dev, case):
    """A synchronisation inside the loop would end a capture: run the
    eager loop with torch's sync debug mode raising on one."""
    sim, state = _graph_sim(dev, *GRAPH_CASES[case])
    table = torch.as_tensor(tt.ricker_table(GRAPH_STEPS, 1, 0.001), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim.engine.run_scan(state, sim.engine.m_args, table, GRAPH_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_run_benchmark_split_modes_and_timing_repeat_on_card(dev, capsys):
    from tpufdtd_torch.harness import perf

    for split, word in ((True, "measured"), (False, "estimated")):
        res = perf.run_benchmark("cuda", [32], 10, 1, 1, None, "float32", None, True, 0.8, 0,
                                 "auto", split, 4, 2, device=dev)
        assert len(res) == 1 and res[0]["device_time_s"] > 0 and not res[0]["nan"]
        assert f"split {word}" in capsys.readouterr().out


def test_run_sharded_benchmark_baseline_single_on_one_card(dev):
    from tpufdtd_torch.harness import perf_sharded

    res = perf_sharded.run_sharded_benchmark(2, (32,), 10, 1, 1, None, False, True,
                                             devices=[dev, dev])
    # shards on one card give no scaling figure, so the one-shard run is skipped
    assert len(res) == 1 and res[0]["device_time_s"] > 0
    assert res[0]["single_device_time_s"] is None and res[0]["scaling_eff_pct"] is None


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two CUDA cards: one shard on each")
def test_run_sharded_benchmark_baseline_single_on_two_cards():
    """Shards on cards of their own: baseline_single times the one-shard
    run and fills Scaling_Eff from it."""
    from tpufdtd_torch.harness import perf_sharded

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    res = perf_sharded.run_sharded_benchmark(2, (32,), 10, 1, 1, None, False, True,
                                             devices=cards)
    assert len(res) == 1 and res[0]["cards"] == 2 and res[0]["single_device_time_s"] > 0
    assert res[0]["scaling_eff_pct"] > 0


COLD_CAPTURE = """
import numpy as np, torch, tpufdtd_torch as tt
from tpufdtd_torch.graphs import buffers as _buffers
n = 64
for order, kw in ((4, {}), (2, {}), (6, {}), (12, {}), (4, {"storage_dtype": "bfloat16"}),
                  (4, {"t_fuse": 5})):
    g = tt.Grid3D(n, n, n, order=order)
    sim = tt.Simulator(g, tt.SimConfig(dt=0.001, nsteps=13, **kw),
                       np.full(g.padded_shape, 1.5, np.float32),
                       tt.default_source_coords(1, n, n, n), device="cuda")
    u = np.zeros(g.padded_shape, np.float32)
    u[g.interior_slices()] = np.random.default_rng(order).standard_normal((n, n, n))
    state = sim.prepare_state(u, u)
    twin = tt.Simulator._copy(state)
    src = tt.ricker_table(13, 1, 0.001)
    out = sim.run(state, src, 13)  # this mode's kernels launch first inside the capture
    want = sim.engine.run_scan(twin, sim.engine.m_args, torch.as_tensor(src, device="cuda"), 13)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_buffers(out), _buffers(want))), (order, kw)
print("cold captures bitwise")
"""


def test_a_kernel_first_launched_inside_a_capture(dev):
    """A process's first span records kernels that never ran before (CUDA
    loads them lazily, here inside the capture): in a fresh process, each
    mode's first replay is bitwise the eager loop run after it."""
    import subprocess
    import sys
    from pathlib import Path

    res = subprocess.run([sys.executable, "-c", COLD_CAPTURE], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=900)
    assert res.returncode == 0 and "cold captures bitwise" in res.stdout, res.stderr[-3000:]

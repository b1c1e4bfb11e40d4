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

import numpy as np
import pytest
import torch

import tpufdtd_torch as tt
from tpufdtd_torch.harness import media
from tpufdtd_torch.ops import stencil_step as A
from tpufdtd_torch.ops import stencil_sweep as B

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


@pytest.mark.parametrize("k", [1, 2, 3, 4])
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
        U.data_ptr(), out.data_ptr(), None, 16, 16, 16, g.halo, 2, 5, 1, 0, 64, 8, 32,
        0, 0, 0, 0, g.padded_shape[0], _build.coeff_array([0.0] * 16),
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(ValueError, match="depth K = 5"):
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
        _check_b(dev, g, k, tile=(128,) + B.TILES[radius, k][1:])
        _check_b(dev, g, k)


def test_smem_bytes_is_what_the_launch_requests(dev):
    """ops/stencil_sweep.smem_bytes states the launch's own expression, and
    cells_per_thread and min_blocks the kernel's register policy."""
    import ctypes

    from tpufdtd_torch.ops import _build

    lib = _build.library()
    for (r, k), tile in B.TILES.items():
        for storage in ("float32", "bfloat16"):
            for medium in ("m", "w"):
                want = B.smem_bytes(r, k, tile, storage, medium)
                got = lib.tpufdtd_sweep_smem(r, k, tile[1], tile[2], int(storage == "bfloat16"),
                                             int(medium == "w"))
                assert got == want
        policy = (ctypes.c_int * 2)()
        lib.tpufdtd_sweep_policy(r, k, policy)
        assert list(policy) == [B.cells_per_thread(r, k), B.min_blocks(r, k)]


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
        st = sim.run(st, ms, pk, None, 2)  # one overlapped block
        if overlap == "on":
            marks["mid"].synchronize()
            assert not marks["x"].query(), "the interior slabs waited on the x exchange"
        torch.cuda.synchronize()
        sims[overlap] = sim.extract_state(st)
    assert all(np.array_equal(a, b) for a, b in zip(sims["on"], sims["off"]))

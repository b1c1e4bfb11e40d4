"""Hand-written kernels against their plain versions, on a CUDA card.

Run on the card with `python -m pytest -m gpu tests/test_torch_gpu.py`;
without a card every test skips. Kernel and plain version differ by FMA
contraction only (nvcc contracts a*b+c) and, in kernel B's isotropic
form, by association order; ~1e-6 of the stencil increment over K <= 4
steps, hence the bound of 1e-5 times the largest increment |want - base|,
where base is the same steps with the Laplacian left out. The fields are
random and DT / h = 0.3 (stable at orders 2-12 with m >= 1.5), so that the
increment is as large as the field and the bound tests the stencil.
"""

import numpy as np
import pytest
import torch

import tpufdtd_torch as tt
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


def _close(got, want, base, untouched, mask):
    assert torch.equal(got[..., ~mask], untouched[..., ~mask])
    scale = float((want - base)[..., mask].abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= RTOL * scale


@pytest.mark.parametrize("shape,order,per_point", [
    ((64, 64, 64), 4, False), ((64, 64, 64), 4, True), ((17, 13, 11), 2, True),
    ((17, 13, 11), 8, False), ((17, 13, 11), 12, True)])
def test_kernel_a_matches_plain(dev, shape, order, per_point):
    g = tt.Grid3D(*shape, order=order)
    gen = torch.Generator(device=dev).manual_seed(0)
    cur, prev, tgt = (torch.randn(g.padded_shape, generator=gen, device=dev) for _ in range(3))
    m = 1.5 + 0.5 * torch.rand(g.padded_shape, generator=gen, device=dev) if per_point else 1.5
    before = A.counts["kernel"][g.radius]
    got = A.leapfrog_step(cur, prev, m, tgt.clone(), grid=g, dt=DT)
    assert A.counts["kernel"][g.radius] == before + 1
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


def _check_b(dev, g, k):
    gen = torch.Generator(device=dev).manual_seed(k)
    U = torch.randn((2,) + g.padded_shape, generator=gen, device=dev)
    mask = _mask(g, dev)
    U[0][~mask] = U[1][~mask]
    out = U.clone()
    before = B.counts["kernel"][g.radius, k]
    got = B.sweep_fused(U, out.clone(), grid=g, dt=DT, m_val=1.5, k_fuse=k)
    assert B.counts["kernel"][g.radius, k] == before + 1
    want = B.sweep_fused_ref(U, grid=g, dt=DT, m_val=1.5, k_fuse=k)
    torch.cuda.synchronize()
    d = U[1] - U[0]
    _close(got, want, torch.stack([U[1] + (k - 1) * d, U[1] + k * d]), out, mask)


@pytest.mark.parametrize("radius,k", sorted(rk for rk in B.TILES if rk[0] != 2))
@pytest.mark.parametrize("shape,h", [((64, 64, 64), (0.1, 0.1, 0.1)),
                                     ((17, 13, 11), (0.1, 0.05, 0.2)),
                                     ((1100, 12, 20), (0.1, 0.1, 0.1))])
def test_kernel_b_matches_plain_radius_1_3_4(dev, radius, k, shape, h):
    """Orders 2, 6 and 8: sweep_fused's radius-1 and radius-3 modes, and at
    radius 4 packed_step (K = 1) and packed_fused2 (K = 2)."""
    _check_b(dev, tt.Grid3D(*shape, hx=h[0], hy=h[1], hz=h[2], order=2 * radius), k)


def test_fast_ring_order8_on_card_matches_truth(dev):
    """Order 8 on the fast ring: 13 steps are K_AUTO[4] = 2 blocks and one
    K = 1 block, both on kernel B, none on a plain version."""
    g = tt.Grid3D(48, 40, 56, order=8)
    m = np.full(g.padded_shape, 1.5, np.float32)
    coords = tt.default_source_coords(1, 48, 40, 56)
    src = tt.ricker_table(13, 1, 0.001)
    u0 = np.zeros(g.padded_shape, np.float32)
    sim = tt.Simulator(g, tt.SimConfig(nsteps=13), m, coords, device=dev)
    B.reset_counts()
    state = sim.run(sim.prepare_state(u0, u0), src, 13)
    assert sim.engine.sweep_k == 2 and B.launches("plain") == 0
    assert B.counts["kernel"] == {(4, 2): 6, (4, 1): 1}
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


def test_launch_failure_raises(dev):
    g = tt.Grid3D(16, 16, 16)
    U = torch.zeros((2,) + g.padded_shape, device=dev)
    with pytest.raises(ValueError):  # beyond shared memory: refused before launch
        B.sweep_fused(U, U.clone(), grid=g, dt=1e-3, m_val=1.5, k_fuse=2, tile=(64, 64, 64, 8))
    with pytest.raises(RuntimeError):  # too many threads per block: the launch fails
        B.sweep_fused(U, U.clone(), grid=g, dt=1e-3, m_val=1.5, k_fuse=1, tile=(64, 8, 32, 64))

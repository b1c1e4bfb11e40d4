"""Bitwise fingerprints of the kernels' outputs on seeded inputs, on a CUDA card.

Prints one line per mode: kernel A (`leapfrog_step`) at radius 1-6 in f32
and bf16 with a scalar and a per-point m, and kernel B (`sweep_fused`) at
every (R, K) of its register form in f32 with a scalar m and in its w and
bf16 modes at R = 2, K = 2, then at every (R, K) of its deep form in f32
with a scalar m and at R = 2, K = 6 in bf16 with w, each with the sha256 of
the output's bytes. The levels are
made on the card from a seeded generator. Two versions of the package
whose lines agree compute bitwise the same values on these inputs. The
script imports `tpufdtd_torch` by its absolute name, so PYTHONPATH picks
the checkout it runs:

  PYTHONPATH=. python3 tpufdtd_torch/harness/kernel_digest.py
  PYTHONPATH=path/to/other/checkout python3 tpufdtd_torch/harness/kernel_digest.py
"""

import hashlib
import sys

import torch

import tpufdtd_torch as tt
from tpufdtd_torch.ops import stencil_step as A
from tpufdtd_torch.ops import stencil_sweep as B

SHAPE = (61, 45, 70)
DT = 0.03


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_digest: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"package {tt.__file__}")
    for r in range(1, 7):  # kernel A's radii
        g = tt.Grid3D(*SHAPE, order=2 * r)
        for dtype in (torch.float32, torch.bfloat16):
            for per_point in (False, True):
                gen = torch.Generator(device=dev).manual_seed(r)
                cur, prev, tgt = (torch.randn(g.padded_shape, generator=gen, device=dev).to(dtype)
                                  for _ in range(3))
                m = (1.5 + 0.5 * torch.rand(g.padded_shape, generator=gen, device=dev)
                     if per_point else 1.5)
                out = A.leapfrog_step(cur, prev, m, tgt, grid=g, dt=DT)
                print(f"A R={r} {A.STORAGE[dtype]} {'per-point' if per_point else 'scalar'} m:"
                      f" {digest(out)}")
    modes = [(r, k, torch.float32, False) for r, k in sorted(B.TILES)]
    modes += [(2, 2, torch.float32, True), (2, 2, torch.bfloat16, False)]
    deep = sorted(getattr(B, "DEEP_TILES", {}))  # a checkout without the deep form has none
    modes += [(r, k, torch.float32, False) for r, k in deep]
    modes += [(2, 6, torch.bfloat16, True)] if deep else []
    for r, k, dtype, with_w in modes:
        g = tt.Grid3D(*SHAPE, order=2 * r)
        gen = torch.Generator(device=dev).manual_seed(10 * r + k)
        U = torch.randn((2,) + g.padded_shape, generator=gen, device=dev)
        mask = torch.zeros(g.padded_shape, dtype=torch.bool, device=dev)
        mask[g.interior_slices()] = True
        U[0][~mask] = U[1][~mask]
        U = U.to(dtype)
        w = None
        if with_w:
            m = 1.5 + 0.5 * torch.rand(g.padded_shape, generator=gen, device=dev)
            w = torch.as_tensor(B.w_stream(g, DT, m.cpu().numpy()), device=dev)
        out = B.sweep_fused(U, U.clone(), grid=g, dt=DT, m_val=1.5, k_fuse=k, w=w)
        print(f"B R={r} K={k} {B.STORAGE[dtype]} {'w' if with_w else 'm'}: {digest(out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

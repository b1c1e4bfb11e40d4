"""Block-shape probe for kernel B (ops/stencil_sweep.TILES).

Times `sweep_fused` at n^3 for each fusion depth K over a grid of block
shapes (XC, TY, TZ, YT) that fit shared memory, with CUDA events, and
prints each shape's ms per call and ms per step, the fastest shape per K
and the one TILES holds. Every shape is first checked against the shape
TILES holds on one small grid, so a shape that computes something else
fails the probe instead of winning it.

Usage (on a CUDA card):
  python -m tpufdtd_torch.harness.tile_probe               # 512^3, K = 1..4
  python -m tpufdtd_torch.harness.tile_probe --n 256 --k 2
"""

from __future__ import annotations

import argparse
import itertools

import torch

from ..config import Grid3D
from ..ops import stencil_sweep
from ..stepper import resolve_device

XCS = (128, 256, 512)
TYS = (8, 16, 32)
TZS = (32, 64, 128)
YTS = (4, 8, 16)


def candidates(k: int) -> list:
    """Block shapes for depth k: 32 x YT threads, YT <= TY, within the
    shared memory of one block; TILES[k] comes first."""
    out = [stencil_sweep.TILES[k]]
    for tile in itertools.product(XCS, TYS, TZS, YTS):
        if tile[3] <= tile[1] and tile not in out:
            if stencil_sweep.smem_bytes(k, tile) <= stencil_sweep.SMEM_LIMIT:
                out.append(tile)
    return out


def _ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _pair(grid: Grid3D, dev, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    U = torch.randn((2,) + grid.padded_shape, generator=gen, device=dev)
    mask = torch.zeros(grid.padded_shape, dtype=torch.bool, device=dev)
    mask[grid.interior_slices()] = True
    U[0][~mask] = U[1][~mask]
    return U, U.clone()


def probe(n: int, ks, iters: int, device="cuda") -> dict:
    """{k: [(tile, ms per call), ...]} at n^3, fastest first."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the tile probe times CUDA devices only; got {device!r}")
    small = Grid3D(300, 40, 72)
    grid = Grid3D(n, n, n)
    kw = dict(dt=0.03, m_val=1.5)
    results = {}
    for k in ks:
        Us, outs = _pair(small, dev, k)
        want = stencil_sweep.sweep_fused(Us, outs.clone(), grid=small, k_fuse=k, **kw)
        U, out = _pair(grid, dev, 100 + k)
        rows = []
        for tile in candidates(k):
            got = stencil_sweep.sweep_fused(Us, outs.clone(), grid=small, k_fuse=k,
                                            tile=tile, **kw)
            if not torch.equal(got, want):
                raise AssertionError(f"K={k} tile {tile} disagrees with TILES[{k}]")
            ms = _ms(lambda: stencil_sweep.sweep_fused(U, out, grid=grid, k_fuse=k, tile=tile,
                                                       **kw), iters)
            rows.append((tile, ms))
            print(f"K={k} tile {tile}: {ms:.4f} ms/call, {ms / k:.4f} ms/step", flush=True)
        rows.sort(key=lambda r: r[1])
        best, held = rows[0], next(r for r in rows if r[0] == stencil_sweep.TILES[k])
        print(f"K={k} fastest {best[0]} {best[1]:.4f} ms/call; TILES[{k}] {held[0]}"
              f" {held[1]:.4f} ms/call")
        results[k] = rows
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="block-shape probe for the fused sweep kernel")
    p.add_argument("--n", type=int, default=512, help="cubic grid size")
    p.add_argument("--k", type=int, nargs="*", default=list(stencil_sweep.TILES))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    probe(args.n, args.k, args.iters, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

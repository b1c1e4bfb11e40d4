"""Block-shape probe for kernel B (ops/stencil_sweep.TILES).

Times `sweep_fused` at n^3 in one mode (storage dtype, and a scalar m or
the w stream) for each stencil radius R and fusion depth K over a grid of
block shapes (XC, TY, TZ) that fit (stencil_sweep.tile_fits), with
CUDA events, and prints each shape's ms per call and ms per step, the fastest shape per
(R, K) and the one the kernel takes (stencil_sweep.tile_for), then the
fastest K per step of each radius (stepper.K_AUTO, from the f32 scalar-m
mode) and the fastest K >= 2 (stepper.MODE_K, the w and bf16 modes').
Every shape is first checked bitwise against the kernel's own shape on one
small grid, so a shape that computes something else fails the probe
instead of winning it.

Usage (on a CUDA card):
  python -m tpufdtd_torch.harness.tile_probe               # 512^3, f32, scalar m
  python -m tpufdtd_torch.harness.tile_probe --n 256 --radius 3 --k 2
  python -m tpufdtd_torch.harness.tile_probe --storage bfloat16 --medium w
"""

from __future__ import annotations

import argparse
import itertools

import torch

from ..config import Grid3D
from ..ops import stencil_sweep
from ..stepper import resolve_device

XCS = (256, 512)
TYS = (8, 16, 24, 32, 40, 48)
TZS = (8, 16, 24, 32, 40, 48, 64, 96, 128)


def candidates(radius: int, k: int, first=None, storage: str = "float32",
               medium: str = "m") -> list:
    """Block shapes for (radius, k) that fit (stencil_sweep.tile_fits) and
    give at least half of their threads' cells work; `first` (default
    TILES[radius, k]) comes first."""
    out = [stencil_sweep.TILES[radius, k] if first is None else first]
    g2 = 2 * k * radius
    cells = stencil_sweep.cells_per_thread(radius, k) * stencil_sweep.THREADS
    for tile in itertools.product(XCS, TYS, TZS):
        _xc, ty, tz = tile
        if (2 * (ty + g2) * (tz + g2) > cells and tile not in out
                and stencil_sweep.tile_fits(radius, k, tile, storage, medium)):
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


def _pair(grid: Grid3D, dev, seed: int, dtype, medium: str):
    """U, a second buffer with its rims, and a w stream (medium "w") of a
    random m in [1.5, 2.0]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    U = torch.randn((2,) + grid.padded_shape, generator=gen, device=dev)
    mask = torch.zeros(grid.padded_shape, dtype=torch.bool, device=dev)
    mask[grid.interior_slices()] = True
    U[0][~mask] = U[1][~mask]
    U = U.to(dtype)
    w = None
    if medium == "w":
        m = 1.5 + 0.5 * torch.rand(grid.padded_shape, generator=gen, device=dev)
        w = torch.as_tensor(stencil_sweep.w_stream(grid, 0.03, m.cpu().numpy()), device=dev)
    return U, U.clone(), w


def probe(n: int, radii, ks, iters: int, device="cuda", storage="float32",
          medium="m") -> dict:
    """{(radius, k): [(tile, ms per call), ...]} at n^3 in one mode, fastest
    first, for every (radius, k) of TILES with radius in radii and k in ks."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the tile probe times CUDA devices only; got {device!r}")
    dtype = getattr(torch, storage)
    results = {}
    for R in radii:
        small = Grid3D(300, 40, 72, order=2 * R)
        grid = Grid3D(n, n, n, order=2 * R)
        for k in sorted(k for r, k in stencil_sweep.TILES if r == R and k in ks):
            held_tile = stencil_sweep.tile_for(R, k, storage, medium)
            Us, outs, ws = _pair(small, dev, k, dtype, medium)
            kw = dict(dt=0.03, m_val=1.5, k_fuse=k)
            want = stencil_sweep.sweep_fused(Us, outs.clone(), grid=small, w=ws, **kw)
            U, out, w = _pair(grid, dev, 100 + k, dtype, medium)
            rows = []
            for tile in candidates(R, k, held_tile, storage, medium):
                got = stencil_sweep.sweep_fused(Us, outs.clone(), grid=small, w=ws, tile=tile,
                                                **kw)
                if not torch.equal(got, want):
                    raise AssertionError(f"R={R} K={k} tile {tile} disagrees with {held_tile}")
                ms = _ms(lambda: stencil_sweep.sweep_fused(U, out, grid=grid, w=w, tile=tile,
                                                           **kw), iters)
                rows.append((tile, ms))
                print(f"{storage} {medium} R={R} K={k} tile {tile}: {ms:.4f} ms/call,"
                      f" {ms / k:.4f} ms/step", flush=True)
            rows.sort(key=lambda r: r[1])
            best = rows[0]
            held = next(r for r in rows if r[0] == held_tile)
            print(f"{storage} {medium} R={R} K={k} fastest {best[0]} {best[1]:.4f} ms/call,"
                  f" {best[1] / k:.4f} ms/step; held {held[0]} {held[1]:.4f} ms/call")
            results[R, k] = rows
            del U, out, w
        per_step = {k: rows[0][1] / k for (r, k), rows in results.items() if r == R}
        for k_min in (1, 2):
            ks_ = {k: t for k, t in per_step.items() if k >= k_min}
            if ks_:
                k_auto = min(ks_, key=ks_.get)
                print(f"{storage} {medium} R={R} fastest K >= {k_min} per step: K={k_auto}"
                      f" ({ks_[k_auto]:.4f} ms/step)")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="block-shape probe for the fused sweep kernel")
    p.add_argument("--n", type=int, default=512, help="cubic grid size")
    p.add_argument("--radius", type=int, nargs="*", default=list(stencil_sweep.RADII))
    p.add_argument("--k", type=int, nargs="*", default=sorted({k for _, k in stencil_sweep.TILES}))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--storage", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--medium", choices=("m", "w"), default="m",
                   help="a scalar m, or the w stream of a heterogeneous medium")
    args = p.parse_args(argv)
    radii = args.radius
    if (args.storage, args.medium) != ("float32", "m"):
        radii = [r for r in radii if r in stencil_sweep.MODE_RADII]
    probe(args.n, radii, args.k, args.iters, device=args.device, storage=args.storage,
          medium=args.medium)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

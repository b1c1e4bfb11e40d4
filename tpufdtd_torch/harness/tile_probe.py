"""Block-shape probe for kernels B (ops/stencil_sweep.TILES, and
DEEP_TILES for its deep form) and A (ops/stencil_step.TILES).

Kernel B:

Times `sweep_fused` at n^3 in one mode (storage dtype, and a scalar m or
the w stream) for each stencil radius R and fusion depth K (the register
form's and the deep form's) over a grid of
block shapes (XC, TY, TZ) that fit (stencil_sweep.tile_fits), with
CUDA events, and prints each shape's ms per call and ms per step, the fastest shape per
(R, K) and the one the kernel takes (stencil_sweep.tile_for), then the
fastest K per step of each radius (stepper.K_AUTO, from the f32 scalar-m
mode) and the fastest K >= 2 (stepper.MODE_K, the w and bf16 modes'); for
the deep form, which takes only the tiles it is built for
(stencil_sweep.DEEP_SHAPES), the fastest tile per (R, K) as a DEEP_TILES
entry and each depth's ms per call beside its break-even, K times the held
auto depth's ms per step (K_AUTO, or MODE_K in the other modes) measured in
the same run (pass that depth in --k too).
Every shape is first checked bitwise against the kernel's own shape on one
small grid, so a shape that computes something else fails the probe
instead of winning it.

Kernel A: times `leapfrog_step` at each of its places (A_PLACES: the
shape and mode in which a path launches it) over the block shapes that fit
(stencil_step.tile_fits) and give at least half of their threads' cells
work, each as the launch cuts it (stencil_step.launch_tile), first checked
bitwise against the kernel's own shape on a small grid; prints each
shape's ms per step, and the fastest and the held shape per place.

Usage (on a CUDA card):
  python -m tpufdtd_torch.harness.tile_probe               # 512^3, f32, scalar m
  python -m tpufdtd_torch.harness.tile_probe --n 256 --radius 3 --k 2
  python -m tpufdtd_torch.harness.tile_probe --radius 1 2 3 --k 3 4 5 6   # the deep form
  python -m tpufdtd_torch.harness.tile_probe --storage bfloat16 --medium w
  python -m tpufdtd_torch.harness.tile_probe --kernel A    # every place
  python -m tpufdtd_torch.harness.tile_probe --kernel A --place gate shard
"""

from __future__ import annotations

import argparse
import itertools

import torch

from ..config import Grid3D
from ..ops import stencil_step, stencil_sweep
from ..stepper import K_AUTO, MODE_K, resolve_device

XCS = (256, 512)
TYS = (8, 16, 24, 32, 40, 48)
TZS = (8, 16, 24, 32, 40, 48, 64, 96, 128)


# Kernel A's places: name -> (interior shape, order, storage dtype, m's kind)
A_PLACES = {
    "order 12": ((512, 512, 512), 12, "float32", "scalar"),
    "order 12 bf16": ((512, 512, 512), 12, "bfloat16", "scalar"),
    "order 8 layered": ((512, 512, 512), 8, "float32", "per-point"),
    "shard": ((128, 512, 512), 8, "float32", "scalar"),  # the sharded per-step path's
    "gate": ((128, 128, 128), 4, "float32", "scalar"),
}
A_TYS = (4, 8, 12, 16, 24, 32, 40, 48, 64)
A_TZS = (32, 64, 96, 128)


def candidates(radius: int, k: int, first=None, storage: str = "float32",
               medium: str = "m") -> list:
    """Block shapes for (radius, k) that fit (stencil_sweep.tile_fits) and
    give at least half of their threads' cells work; on the deep form, each
    tile it is built for (stencil_sweep.DEEP_SHAPES) at each XC. `first`
    (default the kernel's own, tile_for) comes first."""
    out = [stencil_sweep.tile_for(radius, k) if first is None else first]
    if (radius, k) in stencil_sweep.DEEP_TILES:
        for xc, (ty, tz) in itertools.product(XCS, stencil_sweep.DEEP_SHAPES[radius, k]):
            if (xc, ty, tz) not in out and stencil_sweep.tile_fits(radius, k, (xc, ty, tz),
                                                                    storage, medium):
                out.append((xc, ty, tz))
        return out
    g2 = 2 * k * radius
    cells = stencil_sweep.cells_per_thread(radius, k) * stencil_sweep.THREADS
    for tile in itertools.product(XCS, TYS, TZS):
        _xc, ty, tz = tile
        if (2 * (ty + g2) * (tz + g2) > cells and tile not in out
                and stencil_sweep.tile_fits(radius, k, tile, storage, medium)):
            out.append(tile)
    return out


# Shared memory's rate on an H100 SXM: 132 SMs x 128 B a clock x ~1.75 GHz
SMEM_BYTES_PER_S = 132 * 128 * 1.75e9


def deep_floor_ms(radius: int, k: int, tile, n: int = 512) -> float:
    """The least time the deep form's data flow needs at n^3 from shared
    memory alone (csrc/stencil_sweep_deep.cuh): each cell-stage of stages
    1..K over its region (TY + 2(K-j)R) x (TZ + 2(K-j)R) moves half of its
    pair's 8-byte words, R + 1 + (R & 1) for the z window, 2R x- and 2R
    y-neighbours, the level two steps back and its store, over
    SMEM_BYTES_PER_S."""
    _xc, ty, tz = tile
    words = radius + 1 + (radius & 1) + 4 * radius + 2
    stages = sum((ty + 2 * (k - j) * radius) * (tz + 2 * (k - j) * radius)
                 for j in range(1, k + 1)) / (ty * tz)
    return n ** 3 * stages * 4 * words / SMEM_BYTES_PER_S * 1e3


def candidates_a(grid: Grid3D, storage: str, mkind: str, sms: int) -> list:
    """Kernel A's block shapes at a place that fit (stencil_step.tile_fits)
    and give at least half of their threads' cells work, the held shape
    (stencil_step.tile_for) first; one per distinct launch
    (stencil_step.launch_tile)."""
    R = grid.radius
    out, launched = [], set()
    for tile in [stencil_step.tile_for(R, storage, mkind)] + list(
            itertools.product(XCS, A_TYS, A_TZS)):
        _xc, ty, tz = tile
        cells = stencil_step.cells_per_thread(R, stencil_step.blocks_per_sm(R, tile))
        key = stencil_step.launch_tile(grid, tile, sms)
        if out and (2 * ty * tz <= cells * stencil_step.THREADS or key in launched
                    or not stencil_step.tile_fits(R, tile, storage, mkind)):
            continue
        out.append(tile)
        launched.add(key)
    return out


def _levels(grid: Grid3D, dev, seed: int, storage: str, mkind: str):
    """cur, prev, a target and m (f32 in [1.5, 2.0] per point, or 1.5)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cur, prev, target = (torch.randn(grid.padded_shape, generator=gen, device=dev)
                         .to(getattr(torch, storage)) for _ in range(3))
    m = (1.5 + 0.5 * torch.rand(grid.padded_shape, generator=gen, device=dev)
         if mkind == "per-point" else 1.5)
    return cur, prev, target, m


def probe_a(places, iters: int, device="cuda") -> dict:
    """{place: [(tile, ms per step), ...]} of kernel A, fastest first."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the tile probe times CUDA devices only; got {device!r}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}
    for name in places:
        shape, order, storage, mkind = A_PLACES[name]
        grid = Grid3D(*shape, order=order)
        small = Grid3D(61, 40, 72, order=order)
        held_tile = stencil_step.tile_for(grid.radius, storage, mkind)
        cs, ps, ts, ms_ = _levels(small, dev, order, storage, mkind)
        kw = dict(dt=0.03)
        want = stencil_step.leapfrog_step(cs, ps, ms_, ts.clone(), grid=small, **kw)
        cur, prev, target, m = _levels(grid, dev, 100 + order, storage, mkind)
        rows = []
        for tile in candidates_a(grid, storage, mkind, sms):
            got = stencil_step.leapfrog_step(cs, ps, ms_, ts.clone(), grid=small, tile=tile, **kw)
            if not torch.equal(got, want):
                raise AssertionError(f"kernel A {name} tile {tile} disagrees with {held_tile}")
            ms = _ms(lambda: stencil_step.leapfrog_step(cur, prev, m, target, grid=grid,
                                                        tile=tile, **kw), iters)
            rows.append((tile, ms))
            launch = stencil_step.launch_tile(grid, tile, sms)
            print(f"A {name} R={grid.radius} {storage} m {mkind} tile {tile} (launch {launch},"
                  f" {stencil_step.blocks_per_sm(grid.radius, tile)}/SM): {ms:.4f} ms/step",
                  flush=True)
        rows.sort(key=lambda r: r[1])
        held = next(r for r in rows if r[0] == held_tile)
        print(f"A {name} fastest {rows[0][0]} {rows[0][1]:.4f} ms/step; held {held[0]}"
              f" {held[1]:.4f} ms/step")
        results[name] = rows
        del cur, prev, target, m
    return results


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
    first, for every (radius, k) of TILES and DEEP_TILES with radius in
    radii and k in ks."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the tile probe times CUDA devices only; got {device!r}")
    dtype = getattr(torch, storage)
    results = {}
    for R in radii:
        small = Grid3D(300, 40, 72, order=2 * R)
        grid = Grid3D(n, n, n, order=2 * R)
        built = {**stencil_sweep.TILES, **stencil_sweep.DEEP_TILES}
        for k in sorted(k for r, k in built if r == R and k in ks):
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
        deep = [k for k in sorted(per_step) if (R, k) in stencil_sweep.DEEP_TILES]
        # the held auto depth (K_AUTO; MODE_K in the other modes), timed at
        # its own tile where it was not probed: each deep depth's break-even
        k_held = K_AUTO[R] if (storage, medium) == ("float32", "m") else MODE_K
        if deep and k_held not in per_step:
            U, out, w = _pair(grid, dev, 100 + k_held, dtype, medium)
            ms = _ms(lambda: stencil_sweep.sweep_fused(U, out, grid=grid, w=w, dt=0.03,
                                                       m_val=1.5, k_fuse=k_held), iters)
            per_step[k_held] = ms / k_held
            print(f"{storage} {medium} R={R} K={k_held} at"
                  f" {stencil_sweep.tile_for(R, k_held, storage, medium)}: {ms:.4f} ms/call,"
                  f" {ms / k_held:.4f} ms/step")
            del U, out, w
        for k_min in (1, 2):
            ks_ = {k: t for k, t in per_step.items() if k >= k_min}
            if ks_:
                k_auto = min(ks_, key=ks_.get)
                print(f"{storage} {medium} R={R} fastest K >= {k_min} per step: K={k_auto}"
                      f" ({ks_[k_auto]:.4f} ms/step)")
        for k in deep:
            even = k * per_step[k_held]
            floor = deep_floor_ms(R, k, results[R, k][0][0], n)
            print(f"{storage} {medium} DEEP_TILES[{R}, {k}] = {results[R, k][0][0]}:"
                  f" {per_step[k] * k:.4f} ms/call, break-even with K={k_held}"
                  f" {even:.4f} ms/call ({per_step[k] * k / even:.3f} of it), shared-memory"
                  f" floor {floor:.4f} ms/call ({per_step[k] * k / floor:.2f} times it)")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="block-shape probe for kernels B and A")
    p.add_argument("--kernel", choices=("B", "A"), default="B")
    p.add_argument("--place", nargs="*", choices=list(A_PLACES), default=list(A_PLACES),
                   help="kernel A: the places to probe")
    p.add_argument("--n", type=int, default=512, help="cubic grid size")
    p.add_argument("--radius", type=int, nargs="*", default=list(stencil_sweep.RADII))
    depths = {k for _, k in {**stencil_sweep.TILES, **stencil_sweep.DEEP_TILES}}
    p.add_argument("--k", type=int, nargs="*", default=sorted(depths))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--storage", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--medium", choices=("m", "w"), default="m",
                   help="a scalar m, or the w stream of a heterogeneous medium")
    args = p.parse_args(argv)
    if args.kernel == "A":
        probe_a(args.place, args.iters, device=args.device)
        return 0
    radii = args.radius
    if (args.storage, args.medium) != ("float32", "m"):
        radii = [r for r in radii if r in stencil_sweep.MODE_RADII]
    probe(args.n, radii, args.k, args.iters, device=args.device, storage=args.storage,
          medium=args.medium)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpufdtd_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:
  1. card: name, power limit, torch / CUDA / nvcc versions;
  2. build: both kernels from tpufdtd_torch/csrc, each source's nvcc time,
     and each kernel's registers and spills from -Xptxas -v (fails on any
     spill); 2b. kernel A's block shape per mode;
  3. kernel A (single step) against its plain version, rims bitwise;
  3b. kernel A at order 12 (leapfrog_step_pallas's role) at 512^3, scalar
     and per-point m, checked then timed;
  4. kernel B (K fused steps) at radius 2 against K plain steps, for
     K = 1..k_max (K = 5-6 on its deep form), at the main path's 512^3
     among other shapes, each K timed there, with its plain version at
     K_AUTO and the deep form's K; each deep K's ms a call and per step
     beside its break-even, K steps of the register form's fastest depth
     per step in the same run;
  4b. kernel B at radius 1, 3 and 4 (orders 2, 6, 8) the same way (the
     deep form at radius 1: K = 5-6, at radius 3: K = 3-4);
  5. correctness gate: simulate() at 128^3 x 50 through kernel A against
     the torch-f64 truth (rel-L2 < 1e-4), counting kernel A's launches;
  6. main path: Simulator at 512^3 x 50, one Ricker source, fast ring on
     kernel B, against the f64 truth, counting kernel B's launches;
     ms/step, Gcell/s and % of HBM peak; the same run on the plain
     "torch" backend;
  7. high-order paths: the run of phase 6 at orders 6, 8 and 12 (kernel B
     at radius 3 at K_AUTO = 3, on its deep form, and at radius 4 at K_AUTO
     = 1, kernel A at radius 6), and at order 8
     with t_fuse = 2 (kernel B at radius 4, K = 2: packed_fused2's role),
     each with its launches, levels, rel-L2 and times;
  8. kernel modes against their plain versions: kernel B with the w stream,
     in bf16 and in bf16 with w at radius 1-3 and every K, the deep form's
     included, timed with their plain versions at MODE_K and the deep K (the w stream
     filled with the scalar mode's scale bitwise equal to the scalar mode
     at radius 2), kernel A in bf16 at radius 2, 4 and 6; timed at 512^3;
  9. heterogeneous paths on the layered medium (harness/media.py): the
     128^3 x 50 gate at dt/h = 0.3, orders 4 and 6, on kernel B's w mode
     alone; then 512^3 x 50 at orders 4, 6 (kernel B, w) and 8 (kernel A,
     per-point m);
  10. bf16 paths at 512^3 x 50: order 4 uniform (kernel B, bf16), order 4
     layered (kernel B, bf16 + w), order 12 uniform (kernel A, bf16), each
     against the f64 truth (< 5e-2) and the f32 run of the same path;
  10b. an explicit t_fuse at the deep form's depths, 512^3 x 50: order 2 at
     t_fuse 6, order 4 at 5 and 6, order 6 at 3 and 4, and order 4 at 6 and
     order 6 at 4 on the layered medium (w), in bf16 and in bf16 + w; each
     against the f64 truth (computed once per order and medium since phase
     6), its launches per depth, ms/step beside the same path at t_fuse = 0,
     and in bf16 its error beside the register form's deepest K;
  11. kernel B with frozen margins (sweep_fused's frozen_lo/hi/ylo/yhi, the
     sharded sweep's edge shards) against its plain version at radius 1-2,
     K = 1-3, and radius 2, K = 6 (the deep form), in every mode, margins on
     x and y, frozen cells bitwise u_n;
     at the shard shapes of phase 12, timed there;
  12. sharded paths at 512^3 x 50, four shards on this one card through
     tpufdtd_torch.parallel (every exchange and freeze case; no scaling
     figure): the sharded sweep over 4 x-shards at order 4 (the default
     source straddles shards 0 | 1), over 2 x 2 shards, on the layered
     medium (w) and in bf16, and the per-step engine at order 8 on kernel A;
     each against the single-device run of its path from phases 6, 7, 9 and
     10 and that run's f64 truth, with launches and ms/step;
  13. the reference ABI, compat.kernel_cuda, at 512^3 x 50, order 4, one
     source (kernel A): every exit slot bitwise simulate_ring and within
     the gate of the f64 truth, the Profiler's sections;
  14. checkpoint: the main path checkpointed at step 20 and resumed from the
     file on a fresh Simulator, bitwise the unbroken run; save and load
     times;
  15. sharded checkpoint: x4 order 4 at 512^3 x 50 checkpointed at step 30,
     resumed on a 2 x 2 mesh and on one device, against the unbroken x4
     run: bitwise without sources, within 1e-6 rel-L2 with the source;
  16. the sharded sweep's exchange/compute overlap: x4 order 4 at 512^3 x 50
     with overlap "on" bitwise "off" in f32 with the source, in the w mode
     and in bf16, both timed;
  17. tracing.trace of 10 main-path steps: the device's busy share;
  18. the bench line of tpufdtd_torch/harness/bench.py.
Then the JSON line of the kernels (one entry per TPU kernel replaced), the
nvidia-smi line, and the last line {"ok": true, "device": {...}}. Exits 1
without a CUDA device.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Kernel against plain version. The bound is relative to the largest
# stencil increment, want - (the same steps with the Laplacian left out),
# not to the field: at the main path's dt = 1e-3, h = 0.1 the stencil adds
# ~1e-4 of the field per step, and a field-relative bound would pass a
# wrong stencil. CHECK_DT = 0.03 (dt/h = 0.3) makes the
# increment as large as the field; nvcc contracts a*b+c into FMAs and the
# plain version does not, and kernel B's isotropic form associates the sum
# otherwise (DEVIATIONS.md:31-35), which costs ~1e-6 of the increment over
# K <= 4 steps, while a 1e-3 error in the radius-2 weight alone shows as
# ~3e-5. With m = 1.5, 0.3 is inside the leapfrog limit on dt/h at every
# order (3 sum|w| dt^2 / (m h^2) <= 4: 0.61 at order 4, 0.53 at order 12).
KERNEL_RTOL = 1e-5
CHECK_DT = 0.03
GATE_TOL = 1e-4  # rel-L2 against the f64 truth (harness/correctness.py)
GATE_N = 128  # correctness gate grid (bench.py:43)
MAIN_N = 512  # main-path grid (bench.py:60)
HIGH_ORDERS = (6, 8, 12)  # phase 7
BF16_TOL = 5e-2  # rel-L2 of a bf16 path's u_N against the f64 truth (phase 10)
LAYERED_GATE_DT = 0.3  # phase 9's gate: dt at h = 1, where the stencil moves the field
# Published H100 SXM peaks (NVIDIA data sheet) for the least time a call
# could take: device memory 3.35 TB/s, f32 outside the tensor cores 67
# TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def ptxas_summary(log: str) -> list:
    """(kernel, registers, stack bytes, spill stores, spill loads) of every
    kernel in nvcc's -Xptxas -v output; kernel B's instantiations (its deep
    form's "B deep") are named by their template arguments."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            b = re.search(r"kernelILi(\d)ELi(\d)E(?:Li(\d+)ELi(\d+)E)?Lb(\d)E"
                          r"(f|13__nv_bfloat16)Lb(\d)E", cur)
            a = re.search(r"leapfrog_xsweepILi(\d)E(f|13__nv_bfloat16)Li(\d)E", cur)
            if b:
                tile = f" {b[3]}x{b[4]}" if b[3] else ""
                cur = (f"B{' deep' if 'sweep_deep' in cur else ''} R={b[1]} K={b[2]}{tile}"
                       f" {'iso' if b[5] == '1' else 'exact'}"
                       f" {'f32' if b[6] == 'f' else 'bf16'} {'w' if b[7] == '1' else 'm'}")
            elif a:
                cur = f"A R={a[1]} {'f32' if a[2] == 'f' else 'bf16'} {a[3]} blocks/SM"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill"
                      r" loads", line)
        if m and cur:
            out.append([cur, None, *map(int, m.groups())])
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1][0] == cur and out[-1][1] is None:
            out[-1][1] = int(m.group(1))
    return [tuple(k) for k in out]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls after one
    warm call."""
    import torch

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


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2) / (np.sum(b**2) + 1e-30)))


def interior_mask(grid, device):
    import torch

    mask = torch.zeros(grid.padded_shape, dtype=torch.bool, device=device)
    mask[grid.interior_slices()] = True
    return mask


def bf16_ulp(t):
    """One bf16 ulp of each element of the f32 tensor t (8 significant
    bits): 2^-8 to 2^-7 of its value."""
    import torch

    return torch.ldexp(torch.ones_like(t), torch.frexp(t).exponent - 8)


def compare(name, got, want, base, untouched, mask) -> float:
    """Max abs error of `got` against `want`, bounded by KERNEL_RTOL times
    the largest interior stencil increment |want - base|; in bf16 storage
    each element may also differ by one bf16 ulp (the kernel and the plain
    version compute in f32 and may round to neighbouring bf16 values). The
    rim must equal `untouched` bit for bit."""
    import torch

    rim = ~mask
    if not torch.equal(got[..., rim], untouched[..., rim]):
        raise AssertionError(f"{name}: a rim cell changed")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    scale = float((w - base)[..., mask].abs().max())
    if got.dtype == torch.bfloat16:
        diff = (diff - bf16_ulp(torch.maximum(g.abs(), w.abs()))).clamp_(min=0)
    beyond = float(diff.max())
    if not np.isfinite(err) or not scale > 0 or beyond > KERNEL_RTOL * scale:
        raise AssertionError(f"{name}: max abs err {err:.3e} ({beyond:.3e} beyond one bf16"
                             f" ulp) > {KERNEL_RTOL} * {scale:.3e}")
    ulp_note = f", {beyond:.3e} beyond one bf16 ulp" if got.dtype == torch.bfloat16 else ""
    print(f"  {name}: max_abs_err {err:.3e}{ulp_note} (stencil increment max {scale:.3e}),"
          " rims bitwise unchanged")
    return err


def bound(grid, levels_read: int, levels_written: int, steps: int, esz: int = 4,
          f32_fields: int = 0):
    """(bound_ms, bound_by) of a call on `grid`: the larger of its bytes over
    the memory rate and its operations over the f32 rate. Bytes, at esz
    bytes per level element (4 in f32, 2 in bf16): u_n read once over the
    interior and the R cells the stencil reaches beyond it, each further
    input level (u_{n-1}) over the interior, each output level written once
    over the interior; plus 4 B per interior point for each f32 field read
    (a per-point m, the w stream). Operations: the reference's
    3 (order + 1) 2 + 6 per point per step (main.cpp:129-136)."""
    from tpufdtd_torch.utils import metrics

    n = grid.interior_cells
    r2 = 2 * grid.radius
    reach = (grid.nx + r2) * (grid.ny + r2) * (grid.nz + r2)
    nbytes = esz * (reach + n * (levels_read - 1 + levels_written)) + 4 * n * f32_fields
    flops = steps * n * metrics.flops_per_point(grid.order)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_a(grid, per_point_m: bool, esz: int = 4):
    """Kernel A: reads u_n, u_{n-1} (and m), writes one level."""
    return bound(grid, 2, 1, 1, esz, int(per_point_m))


def bound_b(grid, k: int, esz: int = 4, w: bool = False):
    """Kernel B: reads u_{n-1}, u_n (and w), writes u_{n+K-1}, u_{n+K}."""
    return bound(grid, 2, 2, k, esz, int(w))


def phase_kernel_a(tt, dev):
    import torch
    from tpufdtd_torch.ops import stencil_step as A

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [((GATE_N,) * 3, 4, "scalar"), ((GATE_N,) * 3, 4, "per-point"),
             ((17, 13, 11), 4, "scalar"), ((17, 13, 11), 4, "per-point")]
    cases += [((17, 13, 11), order, "per-point") for order in (2, 6, 8, 10, 12)]
    cases += [((17, 13, 11), 12, "scalar")]
    worst = 0.0
    for shape, order, mkind in cases:
        grid = tt.Grid3D(*shape, order=order)
        cur, prev, target = (torch.randn(grid.padded_shape, generator=gen, device=dev)
                             for _ in range(3))
        m = (1.5 + 0.5 * torch.rand(grid.padded_shape, generator=gen, device=dev)
             if mkind == "per-point" else 1.5)
        got = A.leapfrog_step(cur, prev, m, target.clone(), grid=grid, dt=CHECK_DT)
        want = A.leapfrog_step_ref(cur, prev, m, target.clone(), grid=grid, dt=CHECK_DT)
        torch.cuda.synchronize()
        worst = max(worst, compare(f"A {shape} order {order} m {mkind}", got, want,
                                   2 * cur - prev, target, interior_mask(grid, dev)))
    # time at the correctness gate's shape (order 4, scalar m)
    grid = tt.Grid3D(GATE_N, GATE_N, GATE_N)
    cur, prev, target = (torch.randn(grid.padded_shape, generator=gen, device=dev)
                         for _ in range(3))
    ms = cuda_ms(lambda: A.leapfrog_step(cur, prev, 1.5, target, grid=grid, dt=1e-3), 50)
    plain = cuda_ms(lambda: A.leapfrog_step_ref(cur, prev, 1.5, target, grid=grid, dt=1e-3), 20)
    bms, by = bound_a(grid, False)
    print(f"  A at {GATE_N}^3: kernel {ms:.4f} ms/step, plain {plain:.4f} ms/step,"
          f" bound {bms:.4f} ms ({by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by}


def phase_kernel_a_order12(tt, dev):
    """Kernel A at radius 6, leapfrog_step_pallas's role, at the main path's
    shape: scalar m (the order-12 path's medium) and per-point m, checked
    against the plain version, then timed."""
    import torch
    from tpufdtd_torch.ops import stencil_step as A

    gen = torch.Generator(device=dev).manual_seed(3)
    grid = tt.Grid3D(MAIN_N, MAIN_N, MAIN_N, order=12)
    mask = interior_mask(grid, dev)
    cur, prev, target = (torch.randn(grid.padded_shape, generator=gen, device=dev)
                         for _ in range(3))
    out = {}
    for mkind in ("scalar", "per-point"):
        m = (1.5 + 0.5 * torch.rand(grid.padded_shape, generator=gen, device=dev)
             if mkind == "per-point" else 1.5)
        got = A.leapfrog_step(cur, prev, m, target.clone(), grid=grid, dt=CHECK_DT)
        want = A.leapfrog_step_ref(cur, prev, m, target.clone(), grid=grid, dt=CHECK_DT)
        torch.cuda.synchronize()
        err = compare(f"A {MAIN_N}^3 order 12 m {mkind}", got, want, 2 * cur - prev, target, mask)
        del got, want
        ms = cuda_ms(lambda: A.leapfrog_step(cur, prev, m, target, grid=grid, dt=1e-3), 20)
        plain = cuda_ms(lambda: A.leapfrog_step_ref(cur, prev, m, target, grid=grid, dt=1e-3), 3)
        bms, by = bound_a(grid, mkind == "per-point")
        print(f"  A at {MAIN_N}^3 order 12 m {mkind}: kernel {ms:.4f} ms/step, plain"
              f" {plain:.4f} ms/step, bound {bms:.4f} ms ({by})")
        out[mkind] = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
                      "bound_by": by}
        del m
    return out


def phase_kernel_a_shard(tt, dev):
    """Kernel A in the mode and at the shape the sharded per-step path
    launches it (order 8, f32, scalar m, one shard of four of 512^3:
    nx = 128), against its plain version, then timed."""
    import torch
    from tpufdtd_torch.ops import stencil_step as A

    gen = torch.Generator(device=dev).manual_seed(7)
    grid = tt.Grid3D(MAIN_N // 4, MAIN_N, MAIN_N, order=8)
    cur, prev, target = (torch.randn(grid.padded_shape, generator=gen, device=dev)
                         for _ in range(3))
    got = A.leapfrog_step(cur, prev, 1.5, target.clone(), grid=grid, dt=CHECK_DT)
    want = A.leapfrog_step_ref(cur, prev, 1.5, target.clone(), grid=grid, dt=CHECK_DT)
    torch.cuda.synchronize()
    shape = "x".join(str(n) for n in (grid.nx, grid.ny, grid.nz))
    err = compare(f"A {shape} order 8 m scalar", got, want, 2 * cur - prev, target,
                  interior_mask(grid, dev))
    del got, want
    ms = cuda_ms(lambda: A.leapfrog_step(cur, prev, 1.5, target, grid=grid, dt=1e-3), 20)
    plain = cuda_ms(lambda: A.leapfrog_step_ref(cur, prev, 1.5, target, grid=grid, dt=1e-3), 3)
    bms, by = bound_a(grid, False)
    print(f"  A at {shape} order 8 m scalar (a shard of the sharded per-step path): kernel"
          f" {ms:.4f} ms/step, plain {plain:.4f} ms/step, bound {bms:.4f} ms ({by})")
    return shape, {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
                   "bound_by": by}


def _fast_pair(grid, gen, dev, storage="float32"):
    """U = [u_{n-1}, u_n] with one shared random rim (the fast ring's
    contract), in the storage dtype, and the second buffer holding the same
    rims."""
    import torch

    U = torch.randn((2,) + grid.padded_shape, generator=gen, device=dev)
    mask = interior_mask(grid, dev)
    U[0][~mask] = U[1][~mask]
    U = U.to(getattr(torch, storage))
    return U, U.clone(), mask


def _w_stream(B, grid, gen, dev, medium):
    """The w stream of a random medium m in [1.5, 2.0] for medium "w", else
    None."""
    import torch

    if medium != "w":
        return None
    m = 1.5 + 0.5 * torch.rand(grid.padded_shape, generator=gen, device=dev)
    return torch.as_tensor(B.w_stream(grid, CHECK_DT, m.cpu().numpy()), device=dev)


def _lap_free(U, k):
    """[u_{n+K-1}, u_{n+K}] of K leapfrog steps with no Laplacian: the
    linear extrapolation u_n + j (u_n - u_{n-1}), in f32."""
    import torch

    U = U.float()
    d = U[1] - U[0]
    return torch.stack([U[1] + (k - 1) * d, U[1] + k * d])


def check_b(B, grid, U, out, mask, k, w=None):
    got = B.sweep_fused(U, out.clone(), grid=grid, dt=CHECK_DT, m_val=1.5, k_fuse=k, w=w)
    want = B.sweep_fused_ref(U, grid=grid, dt=CHECK_DT, m_val=1.5, k_fuse=k, w=w)
    mode = B.mode_key(grid, k, U, w)[2:]
    tag = "B" if mode == ("float32", "m") else f"B {mode[0]} {mode[1]}"
    name = (f"{tag} R={grid.radius} {grid.nx}x{grid.ny}x{grid.nz}"
            f" h=({grid.hx},{grid.hy},{grid.hz}) K={k}")
    return compare(name, got, want, _lap_free(U, k), out, mask)


def check_w_of_scale(B, grid, U, k):
    """The w stream filled with the scalar mode's own f32 scale gives the
    scalar mode's output bit for bit: the w path changes nothing else."""
    import torch
    from tpufdtd_torch.ops.stencil_step import coeff_values

    w = torch.full(grid.padded_shape, float(coeff_values(grid, CHECK_DT, 1.5)[15]),
                   device=U.device)
    a = B.sweep_fused(U, U.clone(), grid=grid, dt=CHECK_DT, m_val=1.5, k_fuse=k)
    b = B.sweep_fused(U, U.clone(), grid=grid, dt=CHECK_DT, m_val=None, k_fuse=k, w=w)
    if not torch.equal(a, b):
        raise AssertionError(f"B R={grid.radius} {grid.nx}^3 K={k}: w of the scale differs"
                             " from the scalar mode")
    print(f"  B R={grid.radius} {grid.nx}x{grid.ny}x{grid.nz} K={k}: w filled with the scale"
          " is bitwise the scalar mode")


def phase_kernel_b(tt, dev, radius, plain_ks, storage="float32", medium="m"):
    """Kernel B in one mode (storage dtype, scalar m or the w stream) at one
    radius against its plain version for every K: on small shapes and at
    the main path's 512^3, which is then timed per K; the plain version is
    timed at 512^3 for each K of plain_ks. Returns {"max_abs_err": worst
    error, K: {"ms", "plain_ms", "bound_ms", ...}}."""
    import torch
    from tpufdtd_torch.ops import stencil_sweep as B

    seed = 2 + 10 * radius + {"float32": 0, "bfloat16": 100}[storage] + 200 * (medium == "w")
    gen = torch.Generator(device=dev).manual_seed(seed)
    order = 2 * radius
    kmax = B.k_max(radius)
    esz = 2 if storage == "bfloat16" else 4
    worst = 0.0
    # 1100 x-planes span several x-chunks of a block at every K
    # (stencil_sweep.TILES), as 512^3 does at K = 1
    grids = [tt.Grid3D(GATE_N, GATE_N, GATE_N, order=order),
             tt.Grid3D(17, 13, 11, hx=0.1, hy=0.05, hz=0.2, order=order),
             tt.Grid3D(1100, 12, 20, order=order)]
    if radius == 2:
        grids.insert(1, tt.Grid3D(17, 13, 11))
    pin_scale = (storage, medium, radius) == ("float32", "w", 2)
    for grid in grids:
        U, out, mask = _fast_pair(grid, gen, dev, storage)
        w = _w_stream(B, grid, gen, dev, medium)
        for k in range(1, kmax + 1):
            worst = max(worst, check_b(B, grid, U, out, mask, k, w))
            if pin_scale and grid.nx == GATE_N:
                check_w_of_scale(B, grid, U, k)
    # the main path's shape: checked, then timed
    grid = tt.Grid3D(MAIN_N, MAIN_N, MAIN_N, order=order)
    U, out, mask = _fast_pair(grid, gen, dev, storage)
    w = _w_stream(B, grid, gen, dev, medium)
    res = {}
    tag = f"B {storage} {medium}" if (storage, medium) != ("float32", "m") else "B"
    for k in range(1, kmax + 1):
        worst = max(worst, check_b(B, grid, U, out, mask, k, w))
        if pin_scale:
            check_w_of_scale(B, grid, U, k)
        ms = cuda_ms(lambda: B.sweep_fused(U, out, grid=grid, dt=1e-3, m_val=1.5, k_fuse=k,
                                           w=w), 10)
        bms, by = bound_b(grid, k, esz, w is not None)
        res[k] = {"ms": ms, "bound_ms": bms, "bound_by": by}
        print(f"  {tag} R={radius} at {MAIN_N}^3 K={k}: {ms:.4f} ms/call, {ms / k:.4f} ms/step,"
              f" bound {bms:.4f} ms/call ({by})")
    # each deep depth beside its break-even: K steps of the register form's
    # fastest depth per step, timed above
    k_reg = min((k for k in res if (radius, k) in B.TILES), key=lambda k: res[k]["ms"] / k)
    for k in sorted(k for k in res if (radius, k) in B.DEEP_TILES):
        ms, even = res[k]["ms"], k * res[k_reg]["ms"] / k_reg
        print(f"  {tag} R={radius} deep K={k} at {MAIN_N}^3: {ms:.4f} ms/call, {ms / k:.4f}"
              f" ms/step, break-even with K={k_reg} {even:.4f} ms/call ({ms / even:.3f} of it)")
    for k in plain_ks:
        plain = cuda_ms(lambda: B.sweep_fused_ref(U, grid=grid, dt=1e-3, m_val=1.5,
                                                  k_fuse=k, w=w), 3)
        res[k]["plain_ms"] = plain
        print(f"  {tag} plain R={radius} at {MAIN_N}^3 K={k}: {plain:.4f} ms/call,"
              f" {plain / k:.4f} ms/step")
    res["max_abs_err"] = worst
    return res


def phase_kernel_a_bf16(tt, dev):
    """Kernel A in bf16 at radius 2, 4 and 6 with a scalar and a per-point
    m against its plain version; then timed at 512^3: bf16 at radius 2 and
    6 (scalar and per-point m), and f32 at radius 4 with a per-point m (the
    order-8 layered path). Returns {(radius, storage, m's kind): {"max_abs_err",
    "ms", ...}}."""
    import torch
    from tpufdtd_torch.ops import stencil_step as A

    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for shape in ((17, 13, 11), (GATE_N,) * 3):
        for order in (4, 8, 12):
            for mkind in ("scalar", "per-point"):
                grid = tt.Grid3D(*shape, order=order)
                cur, prev, target = (torch.randn(grid.padded_shape, generator=gen,
                                                 device=dev).bfloat16() for _ in range(3))
                m = (1.5 + 0.5 * torch.rand(grid.padded_shape, generator=gen, device=dev)
                     if mkind == "per-point" else 1.5)
                got = A.leapfrog_step(cur, prev, m, target.clone(), grid=grid, dt=CHECK_DT)
                want = A.leapfrog_step_ref(cur, prev, m, target.clone(), grid=grid, dt=CHECK_DT)
                torch.cuda.synchronize()
                worst = max(worst, compare(f"A bf16 {shape} order {order} m {mkind}", got, want,
                                           2 * cur.float() - prev.float(), target,
                                           interior_mask(grid, dev)))
    out = {}
    for order, storage, mkind in ((4, "bfloat16", "scalar"), (12, "bfloat16", "scalar"),
                                  (12, "bfloat16", "per-point"), (8, "float32", "per-point")):
        grid = tt.Grid3D(MAIN_N, MAIN_N, MAIN_N, order=order)
        dtype = getattr(torch, storage)
        cur, prev, target = (torch.randn(grid.padded_shape, generator=gen, device=dev).to(dtype)
                             for _ in range(3))
        m = (1.5 + 0.5 * torch.rand(grid.padded_shape, generator=gen, device=dev)
             if mkind == "per-point" else 1.5)
        mask = interior_mask(grid, dev)
        got = A.leapfrog_step(cur, prev, m, target.clone(), grid=grid, dt=CHECK_DT)
        want = A.leapfrog_step_ref(cur, prev, m, target.clone(), grid=grid, dt=CHECK_DT)
        torch.cuda.synchronize()
        err = compare(f"A {storage} {MAIN_N}^3 order {order} m {mkind}", got, want,
                      2 * cur.float() - prev.float(), target, mask)
        del got, want, mask
        ms = cuda_ms(lambda: A.leapfrog_step(cur, prev, m, target, grid=grid, dt=1e-3), 20)
        plain = cuda_ms(lambda: A.leapfrog_step_ref(cur, prev, m, target, grid=grid, dt=1e-3), 3)
        bms, by = bound_a(grid, mkind == "per-point", 2 if storage == "bfloat16" else 4)
        print(f"  A {storage} at {MAIN_N}^3 order {order} m {mkind}: kernel {ms:.4f} ms/step,"
              f" plain {plain:.4f} ms/step, bound {bms:.4f} ms ({by})")
        out[grid.radius, storage, mkind] = {
            "max_abs_err": max(err, worst) if storage == "bfloat16" else err, "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by}
        del cur, prev, target, m
    return out


def launch_counts():
    """Launches since the last reset: kernel A, kernel B, plain versions."""
    from tpufdtd_torch.ops import stencil_step as A, stencil_sweep as B

    return A.launches(), B.launches(), A.launches("plain") + B.launches("plain")


def launches_by_mode():
    """Launches since the last reset per kernel and mode: {"A R=6 float32
    scalar": n, "B R=4 K=2 float32 m": n, ...}, plain versions included
    ("A plain ...", "B plain ...")."""
    from tpufdtd_torch.ops import stencil_step as A, stencil_sweep as B

    out = {}
    for route in ("kernel", "plain"):
        tag = "" if route == "kernel" else " plain"
        out.update({f"A{tag} R={r} {d} {mk}": n for (r, d, mk), n in A.counts[route].items()})
        out.update({f"B{tag} R={r} K={k} {d} {med}": n
                    for (r, k, d, med), n in B.counts[route].items()})
    return out


def check_launches(label, modes, allowed, needed):
    """Every launch of a run is of a mode in `allowed` (regular expressions
    over launches_by_mode's keys), and each pattern of `needed` matched a
    launched mode."""
    stray = [key for key in modes if not any(re.fullmatch(a, key) for a in allowed)]
    missing = [n for n in needed if not any(re.fullmatch(n, key) and modes[key] for key in modes)]
    if stray or missing or not modes:
        raise AssertionError(f"{label}: launches {modes}; allowed {allowed}, needed {needed}")


def reset_counts():
    from tpufdtd_torch.ops import stencil_step as A, stencil_sweep as B

    A.reset_counts()
    B.reset_counts()


def phase_gate(tt, dev):
    """The main path's correctness half; returns kernel A's launches in it."""
    from tpufdtd_torch.harness.correctness import make_ic

    grid = tt.Grid3D(GATE_N, GATE_N, GATE_N, hx=1.0, hy=1.0, hz=1.0)
    up, uc, m = make_ic(grid)
    _, c_true, _ = tt.truth_run_ring(up, uc, m, grid, 0.001, 50, device=dev)
    reset_counts()
    _, c = tt.simulate(up, uc, m, grid, tt.SimConfig(dt=0.001, nsteps=50, backend="cuda"),
                       device=dev)
    a, b, plain = launch_counts()
    print(f"  gate launches: A {a}, B {b}, plain {plain}")
    if a == 0 or b != 0 or plain != 0:
        raise AssertionError(f"the gate's exact ring must run on kernel A alone; got A {a},"
                             f" B {b}, plain {plain}")
    l2 = rel_l2(c, c_true)
    print(f"  gate {GATE_N}^3 x 50 (exact ring, kernel A): rel-L2 {l2:.3e} vs f64 truth")
    if not l2 < GATE_TOL:
        raise AssertionError(f"gate rel-L2 {l2} >= {GATE_TOL}")
    return a


def run_main(tt, dev, backend, order=4, medium=None, storage="float32", t_fuse=0):
    """The bench's 512^3 x 50 run (h = 0.1, dt = 1e-3, one Ricker source,
    zero ICs, ring "auto"), timed; medium is m's array (default uniform
    1.5); t_fuse > 0 asks for that fusion depth."""
    n, nsteps = MAIN_N, 50
    grid = tt.Grid3D(n, n, n, order=order)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, warmup_steps=5, backend=backend,
                       storage_dtype=storage, t_fuse=t_fuse)
    m = np.full(grid.padded_shape, 1.5, np.float32) if medium is None else medium
    src = tt.ricker_table(nsteps, 1, cfg.dt)
    coords = tt.default_source_coords(1, n, n, n)
    u0 = np.zeros(grid.padded_shape, np.float32)
    sim = tt.Simulator(grid, cfg, m, coords, device=dev)
    state = sim.prepare_state(u0, u0)
    state, secs = sim.run_timed(state, src)
    if sim.last_clock != "cuda_event":
        raise AssertionError(f"run_timed's clock is {sim.last_clock!r}, not CUDA events")
    return sim, state, secs, (u0, m, src, coords)


def phase_main(tt, dev, smi):
    """The main path's perf half; returns kernel B's launches in it."""
    n, nsteps = MAIN_N, 50
    reset_counts()
    sim, state, secs, (u0, m, src, coords) = run_main(tt, dev, "cuda")
    a, b, plain = launch_counts()
    print(f"  main path: fast ring K={sim.engine.sweep_k}, launches: A {a}, B {b}, plain {plain}")
    if not isinstance(state, dict) or sim.engine.sweep_k < 2:
        raise AssertionError("the main path did not take the fused fast ring")
    if a != 0 or b == 0 or plain != 0:
        raise AssertionError(f"the fast ring must run on kernel B alone; got A {a}, B {b},"
                             f" plain {plain}")
    mx, nan = sim.state_field_stats(state)
    _, c = sim.extract_state(state)
    del state
    if nan or not np.isfinite(c).all() or mx == 0.0:
        raise AssertionError(f"main-path field: max {mx}, nan {nan}")
    c_true = truth(tt, dev, sim, u0, m, src, coords)
    l2 = rel_l2(c, c_true)
    print(f"  {n}^3 x 50 u_N: rel-L2 {l2:.3e} vs f64 truth, max |u| {mx:.4e}")
    if not l2 < GATE_TOL:
        raise AssertionError(f"main-path rel-L2 {l2} >= {GATE_TOL}")
    ms = report_times(tt, dev, smi, sim, secs, src)
    SINGLE["order 4"] = {"c": c, "truth": c_true, "ms": ms}
    AUTO[4, False, "float32"] = (ms, l2)
    return b


TRUTHS = {}  # (order, layered): u_N of the f64 truth of the 512^3 x 50 run
# (order, layered, storage): (ms/step, rel-L2 to the truth) of the path at
# t_fuse = 0 (K_AUTO, MODE_K)
AUTO = {}


def truth(tt, dev, sim, u0, m, src, coords):
    """u_N of the f64 truth of a 512^3 x 50 run, computed once per order and
    medium (the uniform m = 1.5 or the layered one): storage dtype and
    fusion depth do not change it."""
    key = (sim.grid.order, bool(np.any(m != m.flat[0])))
    if key not in TRUTHS:
        TRUTHS[key] = tt.truth_run_ring(u0, u0, m, sim.grid, 0.001, sim.cfg.nsteps, src, coords,
                                        device=dev)[1]
    return TRUTHS[key]


def report_times(tt, dev, smi, sim, secs, src, plain=True, label="", spans=4):
    """Median of `spans` timed spans on "cuda" (the checked run's and the
    rest from random states) and, with `plain`, one on the plain "torch"
    backend:
    ms/step, Gcell/s and % of HBM peak, each beside the nvidia-smi line.
    The HBM model is the perf harness's (metrics.optimized_bytes): 12 B per
    point per step in f32 and 6 B in bf16 (read u_n and u_{n-1}, write
    u_{n+1}), plus 4 B for each medium field the engine reads per step (the
    w stream once per K-block, a per-point m every step). Returns the
    "cuda" ms/step."""
    from tpufdtd_torch.utils import metrics
    from tpufdtd_torch.utils.peaks import detect_peaks

    n, nsteps, timed = MAIN_N, 50, 45
    order = sim.grid.order
    bytes_pt = metrics.optimized_bytes(sim.cfg.storage_dtype, sim.engine.field_reads_per_step)
    peaks = detect_peaks(dev)
    times = [secs]
    for seed in range(spans - 1):
        st = sim.prepare_state_random(seed)
        _, s = sim.run_timed(st, src)
        times.append(s)
        del st
    t = float(np.median(times))
    runs = [("cuda", t)]
    if plain:
        _, state_t, secs_t, _ = run_main(tt, dev, "torch", order)
        del state_t
        runs.append(("torch", secs_t))
    for name, tt_s in runs:
        ms_step = tt_s / timed * 1e3
        gcell = n**3 * timed / tt_s / 1e9
        # the reference convention (main.cpp:429-431): 50 steps over the
        # 45-step timed span, as the 28.3 % CUDA_Optimized yardstick uses
        hbm_ref = metrics.gbps_model(n, n, n, nsteps, tt_s, bytes_pt) / peaks.hbm_gbps * 100
        hbm_step = n**3 * bytes_pt / (ms_step * 1e-3) / 1e9 / peaks.hbm_gbps * 100
        print(f"  {n}^3 order {order}{label} {name}: {ms_step:.4f} ms/step, {gcell:.3f} Gcell/s, "
              f"{hbm_step:.2f} % of HBM peak ({bytes_pt:g} B/pt per timed step), "
              f"{hbm_ref:.2f} % (reference convention) [{smi}]")
    print(f"  {n}^3 order {order}{label} cuda timed spans (s): {times}")
    return t / timed * 1e3


# per order of phase 7: the only launches allowed, and those that must occur
# (order 6 at K_AUTO = 3 and order 8 at K_AUTO = 1, the fastest per step)
HIGH_ORDER_LAUNCHES = {6: ([r"B R=3 K=\d float32 m"], [r"B R=3 K=3 float32 m"]),
                       8: ([r"B R=4 K=[12] float32 m"], [r"B R=4 K=\d float32 m"]),
                       12: ([r"A R=6 float32 scalar"], [r"A R=6 float32 scalar"])}
# phase 7's order-8 run at t_fuse = 2, packed_fused2's role: K = 2 blocks
# and, after each odd span, one K = 1 block
FUSED2_LAUNCHES = ([r"B R=4 K=[12] float32 m"], [r"B R=4 K=2 float32 m", r"B R=4 K=1 float32 m"])


def phase_path(tt, dev, smi, order, allowed, needed, *, layered=False, storage="float32",
               tol=GATE_TOL, plain=True, f32_twin=False, t_fuse=0, keep=None, spans=4):
    """Phase 6's run at another order, medium (the layered medium when
    `layered`), storage dtype or fusion depth (t_fuse > 0): launches,
    levels, rel-L2 against the f64 truth (< tol) and times; with
    `f32_twin`, also the rel-L2 against the f32 run of the same path. With
    `keep`, u_N, the truth and ms/step stay in SINGLE[keep] for phase 12.
    The truth is computed once per order and medium (`truth`); ms/step is
    the median of `spans` spans (no time with spans = 0), and at t_fuse = 0
    stays in AUTO with the rel-L2. Returns (launches per mode, cuda ms/step, rel-L2 to
    the truth)."""
    from tpufdtd_torch.harness import media

    n, nsteps = MAIN_N, 50
    medium = media.layered(tt.Grid3D(n, n, n, order=order)) if layered else None
    label = ((" layered" if layered else "") + (" bf16" if storage == "bfloat16" else "")
             + (f" t_fuse {t_fuse}" if t_fuse else ""))
    reset_counts()
    sim, state, secs, (u0, m, src, coords) = run_main(tt, dev, "cuda", order, medium, storage,
                                                      t_fuse)
    modes = launches_by_mode()
    ring = f"fast, K={sim.engine.sweep_k}" if sim.engine.sweep_k else "exact"
    print(f"  order {order}{label}: ring {ring}, launches {modes}")
    check_launches(f"order {order}{label}", modes, allowed, needed)
    levels = sim.extract_state(state)
    want_levels = 2 if sim.engine.sweep_k else 3
    if len(levels) != want_levels or isinstance(state, dict) != (want_levels == 2):
        raise AssertionError(f"order {order}{label}: {len(levels)} levels, expected {want_levels}")
    c = levels[1]
    del levels
    mx, nan = sim.state_field_stats(state)
    del state
    if nan or not np.isfinite(c).all() or mx == 0.0:
        raise AssertionError(f"order {order}{label} field: max {mx}, nan {nan}")
    c_true = truth(tt, dev, sim, u0, m, src, coords)
    l2 = rel_l2(c, c_true)
    twin = ""
    if f32_twin:
        sim32 = tt.Simulator(sim.grid, tt.SimConfig(dt=0.001, nsteps=nsteps), m, coords,
                             device=dev)
        c32 = sim32.extract_state(sim32.run(sim32.prepare_state(u0, u0), src, nsteps))[1]
        twin = f", rel-L2 {rel_l2(c, c32):.3e} vs the f32 run"
        del sim32, c32
    print(f"  {n}^3 x 50 order {order}{label} u_N: rel-L2 {l2:.3e} vs f64 truth{twin},"
          f" max |u| {mx:.4e}, {want_levels} levels")
    if not l2 < tol:
        raise AssertionError(f"order {order}{label} rel-L2 {l2} >= {tol}")
    ms = report_times(tt, dev, smi, sim, secs, src, plain=plain, label=label,
                      spans=spans) if spans else None
    if keep:
        SINGLE[keep] = {"c": c, "truth": c_true, "ms": ms}
    if not t_fuse and ms is not None:
        AUTO[order, layered, storage] = (ms, l2)
    return modes, ms, l2


def phase_high_order(tt, dev, smi, order):
    """Phase 6's run at a higher order. Returns the launches per mode."""
    return phase_path(tt, dev, smi, order, *HIGH_ORDER_LAUNCHES[order],
                      keep=f"order {order}" if order == 8 else None)[0]


def phase_layered_gate(tt, dev, order):
    """The w mode's gate: 128^3 x 50 at h = 1, dt = 0.3 on the layered
    medium, zero ICs, one Ricker source at the default coordinates, on
    kernel B's w mode alone, against the f64 truth. At the bench's dt =
    1e-3 the stencil moves the field by ~1e-4 per step, so the 512^3
    rel-L2 alone cannot see a wrong w."""
    from tpufdtd_torch.harness import media

    n, nsteps, dt = GATE_N, 50, LAYERED_GATE_DT
    grid = tt.Grid3D(n, n, n, hx=1.0, hy=1.0, hz=1.0, order=order)
    m = media.layered(grid)
    coords = tt.default_source_coords(1, n, n, n, h=1.0)
    src = tt.ricker_table(nsteps, 1, dt)
    u0 = np.zeros(grid.padded_shape, np.float32)
    _, c_true, _ = tt.truth_run_ring(u0, u0, m, grid, dt, nsteps, src, coords, device=dev)
    reset_counts()
    sim = tt.Simulator(grid, tt.SimConfig(dt=dt, nsteps=nsteps), m, coords, device=dev)
    state = sim.run(sim.prepare_state(u0, u0), src, nsteps)
    modes = launches_by_mode()
    pattern = rf"B R={grid.radius} K=\d float32 w"
    check_launches(f"layered gate order {order}", modes, [pattern], [pattern])
    c = sim.extract_state(state)[1]
    l2 = rel_l2(c, c_true)
    print(f"  layered gate {n}^3 x 50 order {order}, dt/h {dt}: fast ring K={sim.engine.sweep_k},"
          f" launches {modes}, rel-L2 {l2:.3e} vs f64 truth, max |u| {np.abs(c).max():.4e}")
    if not l2 < GATE_TOL:
        raise AssertionError(f"layered gate order {order}: rel-L2 {l2} >= {GATE_TOL}")
    return modes


NEW_MODES = (("float32", "w"), ("bfloat16", "m"), ("bfloat16", "w"))  # phase 8
# phase 9's 512^3 layered runs: order -> (allowed, needed) launches
LAYERED_LAUNCHES = {4: ([r"B R=2 K=\d float32 w"],) * 2, 6: ([r"B R=3 K=\d float32 w"],) * 2,
                    8: ([r"A R=4 float32 per-point"],) * 2}
# phase 10's bf16 runs: name -> (order, layered, launches allowed and needed)
BF16_PATHS = {"order 4": (4, False, [r"B R=2 K=\d bfloat16 m"]),
              "order 4 layered": (4, True, [r"B R=2 K=\d bfloat16 w"]),
              "order 12": (12, False, [r"A R=6 bfloat16 scalar"])}


# Phase 10b: an explicit t_fuse at the depths of kernel B's deep form, 512^3 x
# 50: name -> (order, layered, storage dtype, t_fuse). Each runs beside its
# path at t_fuse = 0 (K_AUTO or MODE_K, from phases 6-10 or run here), and in
# bf16 beside its run at the register form's deepest K (stencil_sweep.TILES),
# where the stepper capped such a t_fuse before the deep form (at order 6 that
# is the t_fuse = 0 run: MODE_K = 2).
DEEP_PATHS = {
    "order 2 t_fuse 6": (2, False, "float32", 6),
    "order 4 t_fuse 5": (4, False, "float32", 5),
    "order 4 t_fuse 6": (4, False, "float32", 6),
    "order 6 t_fuse 3": (6, False, "float32", 3),
    "order 6 t_fuse 4": (6, False, "float32", 4),
    "order 4 layered t_fuse 6": (4, True, "float32", 6),
    "order 4 bf16 t_fuse 6": (4, False, "bfloat16", 6),
    "order 4 layered bf16 t_fuse 6": (4, True, "bfloat16", 6),
    "order 6 layered t_fuse 4": (6, True, "float32", 4),
    "order 6 bf16 t_fuse 4": (6, False, "bfloat16", 4),
    "order 6 layered bf16 t_fuse 4": (6, True, "bfloat16", 4),
}
DEEP_SPANS = 2  # timed spans a deep path (phase 6's paths take 4)


def phase_deep_paths(tt, dev, smi):
    """Phase 10b: each path of DEEP_PATHS against the f64 truth (< 1e-4 in
    f32, < 5e-2 in bf16), its launches per depth, ms/step beside the same
    path at t_fuse = 0; bf16's rel-L2 at the depth asked for beside the
    register form's cap. Returns {name: launches per mode}."""
    from tpufdtd_torch.ops.stencil_sweep import TILES
    from tpufdtd_torch.stepper import MODE_K

    out = {}
    for name, (order, layered, storage, t_fuse) in DEEP_PATHS.items():
        R = order // 2
        mode = f"{storage} {'w' if layered else 'm'}"
        allowed = [rf"B R={R} K=\d {mode}"]
        tol = BF16_TOL if storage == "bfloat16" else GATE_TOL
        kw = dict(layered=layered, storage=storage, tol=tol, plain=False)
        modes, ms, l2 = phase_path(tt, dev, smi, order, allowed, [rf"B R={R} K={t_fuse} {mode}"],
                                   t_fuse=t_fuse, spans=DEEP_SPANS, **kw)
        out[name] = modes
        key = (order, layered, storage)
        if key not in AUTO:
            phase_path(tt, dev, smi, order, allowed, allowed, spans=DEEP_SPANS, **kw)
        auto_ms, auto_l2 = AUTO[key]
        print(f"  {name}: {ms:.4f} ms/step at K={t_fuse}, {auto_ms:.4f} at t_fuse 0"
              f" ({ms / auto_ms:.3f} of it) [{smi}]")
        if storage == "bfloat16":
            cap = max(k for r, k in TILES if r == R)
            l2_cap = (auto_l2 if cap == MODE_K else
                      phase_path(tt, dev, smi, order, allowed, allowed, t_fuse=cap, spans=0,
                                 **kw)[2])
            print(f"  {name}: rel-L2 {l2:.3e} vs f64 truth at K={t_fuse}, {l2_cap:.3e} at the"
                  f" register form's K={cap}")
    return out


# Phase 11: kernel B with frozen margins (the sharded sweep's edge shards)
FROZEN_KEYS = ("frozen_lo", "frozen_hi", "frozen_ylo", "frozen_yhi")
FROZEN_MODE = f"frozen margins R=2,K=2, x edge shard of 4 at {MAIN_N}^3"
FROZEN_LAUNCHES = {}  # phase 12: kernel-B launches with a margin, per sharded path
SINGLE = {}  # u_N, f64 truth and ms/step of the single-device paths phase 12 compares with
# phase 12: name -> (order, 2-D mesh shape or None, layered, storage, single-device path,
# launches allowed, launches needed, rel-L2 bound against the single-device run). The
# kernels give the same values per cell; the source correction groups its adds
# otherwise: one scatter-add of all of a block's entries, each rounded to the level's
# dtype, against the single device's corner add and then one add per cube, each rounded.
# In f32 that is association (DEVIATIONS.md:31-35). In bf16 the two round differently
# (3.05e-2 apart on the card, PERF.md), so the bf16 sweep is held to the single-device
# bf16 sweep bitwise without sources (BF16_BITWISE_STEPS steps from random levels), and
# with the source to the f32 sharded run at SHARD_TOL_BF16_F32, twice the 5.0e-3 the
# card read between the bf16 sharded run and the truth. The per-step engine is bitwise
# the single-device exact ring on kernel A, run here (phase 7's order-8 path runs
# kernel B at K = 1)
SHARD_TOL_F32 = 2e-6
SHARD_TOL_BF16 = BF16_TOL
SHARD_TOL_BF16_F32 = 1e-2
BF16_BITWISE_STEPS = 10
SHARDED_U = {}  # u_N of the f32 sharded run the bf16 run is held to
SHARDED_PATHS = {
    "sharded x4 order 4": (4, None, False, "float32", "order 4", [r"B R=2 K=\d float32 m"],
                           [r"B R=2 K=2 float32 m"], SHARD_TOL_F32),
    "sharded 2x2 order 4": (4, (2, 2), False, "float32", "order 4", [r"B R=2 K=\d float32 m"],
                            [r"B R=2 K=2 float32 m"], SHARD_TOL_F32),
    "sharded x4 order 4 layered": (4, None, True, "float32", "order 4 layered",
                                   [r"B R=2 K=\d float32 w"], [r"B R=2 K=2 float32 w"],
                                   SHARD_TOL_F32),
    "sharded x4 order 4 bf16": (4, None, False, "bfloat16", "order 4 bf16",
                                [r"B R=2 K=\d bfloat16 m"], [r"B R=2 K=2 bfloat16 m"],
                                SHARD_TOL_BF16),
    "sharded x4 order 8 per-step": (8, None, False, "float32", "order 8 exact ring",
                                    [r"A R=4 float32 scalar"], [r"A R=4 float32 scalar"], 0.0),
}


def check_frozen(B, grid, U, out, mask, k, w, frozen):
    """Kernel B with margins against its plain version with the same
    margins; every frozen cell must hold u_n in both output levels, bit for
    bit."""
    import torch

    kw = dict(zip(FROZEN_KEYS, frozen))
    got = B.sweep_fused(U, out.clone(), grid=grid, dt=CHECK_DT, m_val=1.5, k_fuse=k, w=w, **kw)
    want = B.sweep_fused_ref(U, grid=grid, dt=CHECK_DT, m_val=1.5, k_fuse=k, w=w, **kw)
    mode = B.mode_key(grid, k, U, w)[2:]
    name = (f"B {mode[0]} {mode[1]} R={grid.radius} {grid.nx}x{grid.ny}x{grid.nz} K={k}"
            f" frozen {frozen}")
    for sl in B.frozen_slices(grid, frozen):
        for lvl in range(2):
            if not torch.equal(got[lvl][sl], U[1][sl]):
                raise AssertionError(f"{name}: a frozen cell of level {lvl} is not u_n")
    return compare(name + ", frozen cells bitwise u_n", got, want, _lap_free(U, k), out, mask)


def phase_frozen_margins(tt, dev):
    """Kernel B's frozen margins in every mode at radius 1-2 and K = 1-3,
    and at radius 2, K = 6 (the deep form), margins on x and y, on small
    shapes; then at the sharded main path's
    shard shapes (the 1-D x edge shard, the 2x2 corner shard), and timed at
    the 1-D shard's shape beside the same call without margins. Returns
    the timed mode's {"ms", "plain_ms", "bound_ms", ...}."""
    import torch
    from tpufdtd_torch.ops import stencil_sweep as B

    gen = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    for storage, medium in (("float32", "m"),) + NEW_MODES:
        for radius in (1, 2):
            order = 2 * radius
            for grid in (tt.Grid3D(17, 13, 11, hx=0.1, hy=0.05, hz=0.2, order=order),
                         tt.Grid3D(40, 24, 70, order=order)):
                U, out, mask = _fast_pair(grid, gen, dev, storage)
                w = _w_stream(B, grid, gen, dev, medium)
                for k in (1, 2, 3) + ((6,) if radius == 2 else ()):  # 6: the deep form
                    for frozen in ((2, 3, 1, 2), (0, radius * (k - 1) or 1, 3, 0)):
                        worst = max(worst, check_frozen(B, grid, U, out, mask, k, w, frozen))
    # the sharded 512^3 path's shards at order 4, K = 2: M = 2
    M, k = 2, 2
    for shape, frozen in (((MAIN_N // 4 + 2 * M, MAIN_N, MAIN_N), (M, 0, 0, 0)),
                          ((MAIN_N // 2 + 2 * M, MAIN_N // 2 + 2 * M, MAIN_N), (M, 0, M, 0))):
        grid = tt.Grid3D(*shape)
        for storage, medium in (("float32", "m"),) + NEW_MODES:
            U, out, mask = _fast_pair(grid, gen, dev, storage)
            w = _w_stream(B, grid, gen, dev, medium)
            worst = max(worst, check_frozen(B, grid, U, out, mask, k, w, frozen))
            del U, out, mask, w
    grid = tt.Grid3D(MAIN_N // 4 + 2 * M, MAIN_N, MAIN_N)
    U, out, _mask = _fast_pair(grid, gen, dev)
    kw = dict(zip(FROZEN_KEYS, (M, 0, 0, 0)))
    ms = cuda_ms(lambda: B.sweep_fused(U, out, grid=grid, dt=1e-3, m_val=1.5, k_fuse=k, **kw),
                 20)
    ms0 = cuda_ms(lambda: B.sweep_fused(U, out, grid=grid, dt=1e-3, m_val=1.5, k_fuse=k), 20)
    plain = cuda_ms(lambda: B.sweep_fused_ref(U, grid=grid, dt=1e-3, m_val=1.5, k_fuse=k, **kw), 3)
    bms, by = bound_b(grid, k)
    print(f"  B R=2 K=2 frozen (M, 0) at {grid.nx}x{grid.ny}x{grid.nz} (a 1-D shard of"
          f" {MAIN_N}^3): {ms:.4f} ms/call, the same call without margins {ms0:.4f}, plain"
          f" {plain:.4f}, bound {bms:.4f} ms ({by})")
    return {"max_abs_err": worst, "ms": ms, "ms_no_margins": ms0, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by}


def phase_sharded(tt, dev, smi, name, order, shape, layered, storage, single, allowed,
                  needed, single_tol):
    """One sharded 512^3 x 50 run with four shards on this card, through
    ShardedSimulator: launches (kernel B with margins counted apart), u_N
    against the single-device run of the same path (phases 6, 7, 9, 10)
    and its f64 truth (in bf16 also against the f32 sharded run, and
    without sources bitwise against the single-device sweep), and ms/step
    over the 45 steps after the warmup,
    median of three spans, beside the single-device run's. Returns the
    launches per mode."""
    from tpufdtd_torch.harness import media
    from tpufdtd_torch.harness.perf_sharded import NO_SCALING, timed_span
    from tpufdtd_torch.ops import stencil_sweep as B
    from tpufdtd_torch.parallel import ShardedSimulator, make_mesh

    n, nsteps, warm = MAIN_N, 50, 5
    grid = tt.Grid3D(n, n, n, order=order)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, warmup_steps=warm, storage_dtype=storage)
    m = media.layered(grid) if layered else np.full(grid.padded_shape, 1.5, np.float32)
    src = tt.ricker_table(nsteps, 1, cfg.dt)
    coords = tt.default_source_coords(1, n, n, n)
    u0 = np.zeros(grid.padded_shape, np.float32)
    mesh = make_mesh(shape=shape, devices=[dev] * 4) if shape else make_mesh(devices=[dev] * 4)
    sim = ShardedSimulator(grid, cfg, m, mesh, coords)
    term = tt.build_source_term(grid, coords, m)
    live = term.scale != 0
    owners = sorted({(int(x) - grid.halo) // (n // mesh.ndx) for x in term.ix[live]})
    state, m_sh, terms = sim.prepare(u0, u0, m)
    engine = f"sweep K={sim.sweep.K}" if isinstance(state, dict) else "per-step (kernel A)"
    reset_counts()
    state = sim.run(state, m_sh, terms, src[:warm], warm)
    secs, state = timed_span(sim, lambda: sim.run(state, m_sh, terms, src[warm:], nsteps - warm))
    modes = launches_by_mode()
    frozen = B.launches("frozen")
    print(f"  {name} ({mesh.ndx}x{mesh.ndy} shards, {engine}): source corners in x shards"
          f" {owners}; launches {modes}, of them kernel B with frozen margins {frozen}")
    check_launches(name, modes, allowed, needed)
    if isinstance(state, dict) != (frozen > 0):
        raise AssertionError(f"{name}: {frozen} frozen-margin launches on the {engine} engine")
    FROZEN_LAUNCHES[name] = frozen
    c = sim.extract_state(state)[1]
    if single not in SINGLE:  # the exact ring of phase 7's order: run it here
        path = SINGLE[single.removesuffix(" exact ring")]
        sim1 = tt.Simulator(grid, dataclasses.replace(cfg, ring="exact"), m, coords, device=dev)
        st1, secs1 = sim1.run_timed(sim1.prepare_state(u0, u0), src)
        SINGLE[single] = {"c": sim1.extract_state(st1)[1], "truth": path["truth"],
                          "ms": secs1 / (nsteps - warm) * 1e3}
        print(f"  single-device {single}, order {order}: {SINGLE[single]['ms']:.4f} ms/step,"
              f" rel-L2 {rel_l2(SINGLE[single]['c'], path['c']):.3e} vs phase 7's run [{smi}]")
        del sim1, st1
    want = SINGLE[single]
    l2_truth, l2_single = rel_l2(c, want["truth"]), rel_l2(c, want["c"])
    same = np.array_equal(c, want["c"])
    tol = BF16_TOL if storage == "bfloat16" else GATE_TOL
    print(f"  {name} u_N: rel-L2 {l2_truth:.3e} vs f64 truth (< {tol}), {l2_single:.3e} vs the"
          f" single-device {single} run (<= {single_tol}; bitwise {same}), max |u|"
          f" {np.abs(c).max():.4e}")
    if not (np.isfinite(c).all() and l2_truth < tol and l2_single <= single_tol
            and (same or single_tol > 0)):
        raise AssertionError(f"{name}: rel-L2 {l2_truth} vs truth, {l2_single} vs single device")
    if name == "sharded x4 order 4":
        SHARDED_U[name] = c
    if storage == "bfloat16":
        l2_f32 = rel_l2(c, SHARDED_U.pop("sharded x4 order 4"))
        print(f"  {name} u_N: rel-L2 {l2_f32:.3e} vs the f32 sharded x4 order 4 run"
              f" (< {SHARD_TOL_BF16_F32})")
        if not l2_f32 < SHARD_TOL_BF16_F32:
            raise AssertionError(f"{name}: rel-L2 {l2_f32} vs the f32 sharded run")
        bitwise_without_sources(tt, dev, grid, cfg, m, mesh, name)
    del c
    times = [secs]
    for _ in range(2):
        t, state = timed_span(sim, lambda: sim.run(state, m_sh, terms, src[warm:], nsteps - warm))
        times.append(t)
    ms = float(np.median(times)) / (nsteps - warm) * 1e3
    print(f"  {name}: {ms:.4f} ms/step, the single-device run {want['ms']:.4f} ms/step"
          f" ({NO_SCALING}) [{smi}]; spans (s) {times}")
    sharded_breakdown(sim, state, m_sh, terms, src, name)
    return modes


def bitwise_without_sources(tt, dev, grid, cfg, m, mesh, name):
    """The sharded sweep against the single-device sweep on the same random
    zero-rim levels, without sources, BF16_BITWISE_STEPS steps: u_{N-1}
    and u_N bit for bit."""
    import torch
    from tpufdtd_torch.parallel import ShardedSimulator

    gen = torch.Generator(device=dev).manual_seed(13)
    mask = interior_mask(grid, dev)
    ua, ub = ((torch.randn(grid.padded_shape, generator=gen, device=dev) * mask).cpu().numpy()
              for _ in range(2))
    del mask
    nsteps = BF16_BITWISE_STEPS
    sim1 = tt.Simulator(grid, cfg, m, None, device=dev)
    one = sim1.extract_state(sim1.run(sim1.prepare_state(ua, ub), None, nsteps))
    del sim1
    sim = ShardedSimulator(grid, cfg, m, mesh)
    state, m_sh, terms = sim.prepare(ua, ub, m)
    if not isinstance(state, dict):
        raise AssertionError(f"{name} without sources: the per-step engine")
    got = sim.extract_state(sim.run(state, m_sh, terms, None, nsteps))
    same = all(np.array_equal(a, b) for a, b in zip(got, one))
    print(f"  {name} without sources, {nsteps} steps from random levels: u_N-1 and u_N"
          f" bitwise the single-device sweep's: {same}")
    if not same:
        raise AssertionError(f"{name} without sources differs from the single-device sweep")


def sharded_breakdown(sim, state, m_sh, terms, src, name):
    """ms per block (the sweep) or per step (per-step engine) of the parts
    of a sharded run, each timed alone with CUDA events over 20 repeats
    on the run's final state: every shard's kernel, the exchange copies,
    the source correction."""
    import torch
    from tpufdtd_torch.sources import inject

    if isinstance(state, dict):
        sw = sim.sweep
        states = state["sweep"]
        tab = torch.as_tensor(src[:sw.K], device=sim.mesh.devices[0])
        Us = [[st[0] for st in col] for col in states]
        shards = [(dx, dy) for dx in range(sw.ndx) for dy in range(sw.ndy)]
        parts = {
            "kernels": lambda: [sw._kern(*states[dx][dy], dx, dy, sw.K) for dx, dy in shards],
            "exchange": lambda: (sw._exchange_y(Us), sw._exchange_x(Us)),
            "correction": lambda: [sw._correct(states[dx][dy][1], sw.entries[dx][dy][sw.K], tab)
                                   for dx, dy in shards if sw.entries[dx][dy] is not None],
        }
        unit = f"block of K={sw.K}"
    else:
        P, C, T = state
        tab = torch.as_tensor(src[:1], device=sim.mesh.devices[0])
        parts = {
            "kernels": lambda: [sim._step(C[d], P[d], m_sh[d], T[d]) for d in range(sim.ndev)],
            "exchange": lambda: sim._exchange(C),
            "correction": lambda: [inject(T[d], terms[d], tab[0]) for d in range(sim.ndev)
                                   if terms[d] is not None],
        }
        unit = "step"
    out = {k: cuda_ms(fn, 20) for k, fn in parts.items()}
    print(f"  {name} per {unit}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))



# Phases 13-18: the modules ported last, on the main path's configuration
CKPT_STEP = 20  # phase 14: a multiple of the main path's K = 2
SHARDED_CKPT_STEP = 30  # phase 15: one checkpoint file per run (30 < 50 < 60)
SOURCED_RESUME_TOL = 1e-6  # phase 15: a resume on another mesh, with the source
TRACE_STEPS = 10  # phase 17


def main_config(tt, order=4, nsteps=50):
    """The bench's 512^3 configuration: grid, m = 1.5, the Ricker table, the
    default source coordinates and zero levels."""
    n = MAIN_N
    grid = tt.Grid3D(n, n, n, order=order)
    return (grid, np.full(grid.padded_shape, 1.5, np.float32), tt.ricker_table(nsteps, 1, 0.001),
            tt.default_source_coords(1, n, n, n), np.zeros(grid.padded_shape, np.float32))


def phase_kernel_cuda(tt, dev, smi):
    """The reference ABI (compat.kernel_cuda) at 512^3 x 50, order 4, one
    Ricker source, on the exact ring (kernel A): every exit slot bitwise
    simulate_ring and within the gate of the f64 truth. Returns the
    launches per mode."""
    from tpufdtd_torch.compat import Profiler, kernel_cuda

    n, nsteps = MAIN_N, 50
    grid, m, src, coords, z = main_config(tt)
    u = np.zeros((3,) + grid.padded_shape, np.float32)
    timers = Profiler()
    reset_counts()
    t0 = time.perf_counter()
    kernel_cuda(m, src, coords, u, n - 1, 0, n - 1, 0, n - 1, 0, 0.001, 0.1, 0.1, 0.1, 0.0, 0.0,
                0.0, 0, 0, nsteps - 1, 0, timers=timers, device=dev)
    wall = time.perf_counter() - t0
    modes = launches_by_mode()
    check_launches("kernel_cuda", modes, [r"A R=2 float32 scalar"], [r"A R=2 float32 scalar"])
    ring = tt.simulate_ring(z, z, m, grid, tt.SimConfig(nsteps=nsteps), src, coords, device=dev)
    truth = tt.truth_run_ring(z, z, m, grid, 0.001, nsteps, src, coords, device=dev)
    tm = nsteps - 1
    for slot, name, want, t in zip((tm % 3, (tm + 1) % 3, (tm + 2) % 3),
                                   ("u_N-1", "u_N", "u_N-2"), ring, truth):
        same, l2 = np.array_equal(u[slot], want), rel_l2(u[slot], t)
        print(f"  kernel_cuda slot {slot} ({name}): bitwise simulate_ring {same}, rel-L2"
              f" {l2:.3e} vs f64 truth")
        if not same or not l2 < GATE_TOL:
            raise AssertionError(f"kernel_cuda slot {slot}: bitwise {same}, rel-L2 {l2}")
    if not timers.section0 > 0:
        raise AssertionError(f"kernel_cuda: Profiler.section0 = {timers.section0}")
    print(f"  kernel_cuda {n}^3 x {nsteps}: launches {modes}; Profiler section0"
          f" {timers.section0 * 1e3:.3f} ms, section1 {timers.section1 * 1e3:.4f} ms over the 45"
          f" timed steps ({(timers.section0 + timers.section1) / 45 * 1e3:.4f} ms/step), call"
          f" {wall:.1f} s wall with the host copies [{smi}]")
    return modes, kernel_a_main(tt, dev)


def kernel_a_main(tt, dev):
    """Kernel A in kernel_cuda's mode and shape (order 4, f32, scalar m,
    512^3) against its plain version, then timed."""
    import torch
    from tpufdtd_torch.ops import stencil_step as A

    gen = torch.Generator(device=dev).manual_seed(19)
    grid = tt.Grid3D(MAIN_N, MAIN_N, MAIN_N)
    cur, prev, target = (torch.randn(grid.padded_shape, generator=gen, device=dev)
                         for _ in range(3))
    got = A.leapfrog_step(cur, prev, 1.5, target.clone(), grid=grid, dt=CHECK_DT)
    want = A.leapfrog_step_ref(cur, prev, 1.5, target.clone(), grid=grid, dt=CHECK_DT)
    torch.cuda.synchronize()
    err = compare(f"A {MAIN_N}^3 order 4 m scalar", got, want, 2 * cur - prev, target,
                  interior_mask(grid, dev))
    del got, want
    ms = cuda_ms(lambda: A.leapfrog_step(cur, prev, 1.5, target, grid=grid, dt=1e-3), 20)
    plain = cuda_ms(lambda: A.leapfrog_step_ref(cur, prev, 1.5, target, grid=grid, dt=1e-3), 3)
    bms, by = bound_a(grid, False)
    print(f"  A at {MAIN_N}^3 order 4 m scalar (kernel_cuda's mode): kernel {ms:.4f} ms/step,"
          f" plain {plain:.4f} ms/step, bound {bms:.4f} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by}


def phase_checkpoint(tt, dev):
    """The main path (fast ring, kernel B) checkpointed at step CKPT_STEP and
    resumed from the file on a fresh Simulator: u_N-1 and u_N bitwise the
    unbroken 50-step run. Returns the launches per mode of the checkpointed
    run and the resume."""
    from tpufdtd_torch import checkpoint as ck

    nsteps = 50
    grid, m, src, coords, u0 = main_config(tt)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps)
    sim = tt.Simulator(grid, cfg, m, coords, device=dev)
    ref = sim.extract_state(sim.run(sim.prepare_state(u0, u0), src, nsteps))
    with tempfile.TemporaryDirectory() as tmp:
        fmt = tmp + "/ckpt_{step:06d}.npz"
        reset_counts()
        t0 = time.perf_counter()
        ck.run_with_checkpoints(sim, u0, u0, nsteps, src, checkpoint_every=CKPT_STEP,
                                path_fmt=fmt)
        t1 = time.perf_counter()
        p, c = ck.resume(fmt.format(step=CKPT_STEP), cfg, m, nsteps, src, coords, device=dev)
        t2 = time.perf_counter()
        modes = launches_by_mode()
        path = fmt.format(step=CKPT_STEP)
        size = os.path.getsize(path)
        t3 = time.perf_counter()
        mid = ck.load(path)
        t4 = time.perf_counter()
        ck.save(tmp + "/again.npz", mid)
        t5 = time.perf_counter()
    check_launches("checkpoint", modes, [r"B R=2 K=\d float32 m"], [r"B R=2 K=2 float32 m"])
    same = np.array_equal(c, ref[1]) and np.array_equal(p, ref[0])
    print(f"  checkpoint at step {CKPT_STEP} of {nsteps} ({MAIN_N}^3, fast ring): resumed u_N-1,"
          f" u_N bitwise the unbroken run: {same}; launches {modes}; file {size / 2**20:.1f} MiB,"
          f" save {t5 - t4:.2f} s, load {t4 - t3:.2f} s; run with checkpoints {t1 - t0:.2f} s,"
          f" resume {t2 - t1:.2f} s (wall, host copies included)")
    if not same or mid.u_target is not None:
        raise AssertionError(f"checkpoint: bitwise {same}, u_target {mid.u_target is not None}")
    return modes


def box_ic(tt, grid, seed):
    """Zero levels with a random 96^3 box around the grid's centre, which
    straddles the shard cuts of the x4 and 2 x 2 meshes (mostly zero, so
    the npz files compress)."""
    rng = np.random.default_rng(seed)
    c, b = grid.halo + MAIN_N // 2, 48
    out = []
    for _ in range(2):
        a = np.zeros(grid.padded_shape, np.float32)
        a[c - b: c + b, c - b: c + b, c - b: c + b] = rng.standard_normal((2 * b,) * 3)
        out.append(a)
    return out


def phase_sharded_checkpoint(tt, dev):
    """x4 order 4 at 512^3 x 50 checkpointed at SHARDED_CKPT_STEP (gathered to
    the global layout), then resumed on a 2 x 2 mesh and on the single
    device, against the unbroken x4 run: bitwise without sources, within
    SOURCED_RESUME_TOL with the source. Returns the launches per mode."""
    from tpufdtd_torch import checkpoint as ck
    from tpufdtd_torch.parallel import ShardedSimulator, make_mesh

    nsteps = 50
    grid, m, src, coords, _ = main_config(tt)
    up, uc = box_ic(tt, grid, 17)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps)
    reset_counts()
    for sourced in (False, True):
        c_xy = coords if sourced else None
        s_tab = src if sourced else None
        x4 = make_mesh(devices=[dev] * 4)
        sim = ShardedSimulator(grid, cfg, m, x4, c_xy)
        st, ms, pk = sim.prepare(up, uc, m)
        if not isinstance(st, dict):
            raise AssertionError("sharded checkpoint: not the sharded sweep")
        p0, c0 = sim.extract_state(sim.run(st, ms, pk, s_tab, nsteps))
        with tempfile.TemporaryDirectory() as tmp:
            fmt = tmp + "/ck_{step:06d}.npz"
            pa, ca = ck.run_sharded_with_checkpoints(ShardedSimulator(grid, cfg, m, x4, c_xy), up,
                                                     uc, m, nsteps, s_tab,
                                                     checkpoint_every=SHARDED_CKPT_STEP,
                                                     path_fmt=fmt)
            path = fmt.format(step=SHARDED_CKPT_STEP)
            runs = {"x4 checkpointed": (pa, ca),
                    "2x2 resumed": ck.resume_sharded(path, cfg, m, make_mesh(shape=(2, 2),
                                                                             devices=[dev] * 4),
                                                     nsteps, s_tab, c_xy),
                    "single device resumed": ck.resume(path, cfg, m, nsteps, s_tab, c_xy,
                                                       device=dev)}
        for name, (p, c) in runs.items():
            same = np.array_equal(c, c0) and np.array_equal(p, p0)
            l2 = max(rel_l2(c, c0), rel_l2(p, p0))
            need_bitwise = not sourced or name == "x4 checkpointed"
            print(f"  sharded checkpoint {MAIN_N}^3, step {SHARDED_CKPT_STEP} of {nsteps},"
                  f" {'one source' if sourced else 'no sources'}: {name} vs the unbroken x4 run:"
                  f" bitwise {same}, rel-L2 {l2:.3e}")
            if not (same if need_bitwise else l2 <= SOURCED_RESUME_TOL):
                raise AssertionError(f"sharded checkpoint {name}: bitwise {same}, rel-L2 {l2}")
    modes = launches_by_mode()
    check_launches("sharded checkpoint", modes, [r"B R=2 K=\d float32 m"],
                   [r"B R=2 K=2 float32 m"])
    return modes


# phase 16: name -> (layered, storage, launches allowed and needed)
OVERLAP_PATHS = {"x4 order 4": (False, "float32", r"B R=2 K=\d float32 m"),
                 "x4 order 4 layered": (True, "float32", r"B R=2 K=\d float32 w"),
                 "x4 order 4 bf16": (False, "bfloat16", r"B R=2 K=\d bfloat16 m")}


def phase_overlap(tt, dev, smi, name, layered, storage, pattern):
    """The x4 order-4 sharded sweep at 512^3 x 50 with overlap "on" and
    "off": u_N-1 and u_N bitwise, and both ms/step (45 timed steps after 5
    warmup, median of 3 spans). Returns the launches per mode of the "on"
    run."""
    from tpufdtd_torch.harness import media
    from tpufdtd_torch.harness.perf_sharded import timed_span
    from tpufdtd_torch.parallel import ShardedSimulator, make_mesh

    nsteps, warm = 50, 5
    grid, m, src, coords, u0 = main_config(tt)
    if layered:
        m = media.layered(grid)
    out = {}
    for overlap in ("off", "on"):
        cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, storage_dtype=storage, overlap=overlap)
        sim = ShardedSimulator(grid, cfg, m, make_mesh(devices=[dev] * 4), coords)
        if sim.sweep is None or sim.sweep.overlap != (overlap == "on"):
            raise AssertionError(f"overlap {name}: {overlap} did not select its schedule")
        state, m_sh, terms = sim.prepare(u0, u0, m)
        reset_counts()
        state = sim.run(state, m_sh, terms, src[:warm], warm)
        secs, state = timed_span(sim, lambda: sim.run(state, m_sh, terms, src[warm:],
                                                      nsteps - warm))
        modes = launches_by_mode()
        check_launches(f"overlap {name} {overlap}", modes, [pattern], [pattern])
        levels = sim.extract_state(state)
        times = [secs]
        for _ in range(2):
            t, state = timed_span(sim, lambda: sim.run(state, m_sh, terms, src[warm:],
                                                       nsteps - warm))
            times.append(t)
        out[overlap] = (levels, float(np.median(times)) / (nsteps - warm) * 1e3, modes)
        if overlap == "on" and not layered and storage == "float32":
            overlap_breakdown(sim, state)
    same = all(np.array_equal(a, b) for a, b in zip(out["on"][0], out["off"][0]))
    print(f"  overlap {name} {MAIN_N}^3 x {nsteps}, four shards on the card: on bitwise off:"
          f" {same}; on {out['on'][1]:.4f} ms/step, off {out['off'][1]:.4f} ms/step"
          f" (on / off {out['on'][1] / out['off'][1]:.3f}); launches on {out['on'][2]}, off"
          f" {out['off'][2]} [{smi}]")
    if not same:
        raise AssertionError(f"overlap {name}: on differs from off")
    return out["on"][2]


def overlap_breakdown(sim, state):
    """ms per K-block of the parts of an overlapped block, each timed alone
    with CUDA events over 20 repeats on the run's final state: the four
    interior slabs, the x exchange, the eight edge slabs, the band copies
    (save and put back), and the whole block (Sweep._block)."""
    sw = sim.sweep
    states = state["sweep"]
    Us = [[st[0] for st in col] for col in states]
    shards = [(dx, dy) for dx in range(sw.ndx) for dy in range(sw.ndy)]
    h, M, E, nxk = sw.h, sw.M, sw.E, sw.lgrid.nx
    bands = (slice(h + E, h + E + M), slice(h + nxk - E - M, h + nxk - E))

    def edges():
        for dx, dy in shards:
            sw._kern(*states[dx][dy], dx, dy, sw.K, "lo")
            sw._kern(*states[dx][dy], dx, dy, sw.K, "hi")

    def band_copies():
        for dx, dy in shards:
            spare = states[dx][dy][1]
            for b in bands:
                spare[:, b].copy_(spare[:, b].clone())

    parts = {
        "interior slabs": lambda: [sw._kern(*states[dx][dy], dx, dy, sw.K, "mid")
                                   for dx, dy in shards],
        "x exchange": lambda: sw._exchange_x(Us),
        "edge slabs": edges,
        "band copies": band_copies,
        "serial kernels": lambda: [sw._kern(*states[dx][dy], dx, dy, sw.K) for dx, dy in shards],
        "overlapped block": lambda: sw._block([list(col) for col in states], sw.K),
    }
    out = {k: cuda_ms(fn, 20) for k, fn in parts.items()}
    print(f"  overlap per block of K={sw.K}, each part alone: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))


def phase_trace(tt, dev, smi):
    """TRACE_STEPS main-path steps (512^3, fast ring, kernel B) under
    tracing.trace: the device's busy share of the window, the union of its
    kernel and copy intervals over the window's wall time (the profiler's
    own host cost included), and the device time by kernel. Returns the
    launches per mode. The profiler slows the host's launches, so the same
    number of steps just before the traced window is timed without it, and
    the traced busy time is also given as a share of that."""
    import torch

    from tpufdtd_torch.utils import tracing

    n0, n1 = 6, 6 + TRACE_STEPS
    grid, m, src, coords, u0 = main_config(tt, nsteps=n1 + TRACE_STEPS)
    sim = tt.Simulator(grid, tt.SimConfig(dt=0.001, nsteps=n1 + TRACE_STEPS), m, coords,
                       device=dev)
    state = sim.run(sim.prepare_state(u0, u0), src[:n0], n0)
    # the window before, without the profiler: CUDA events around it
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    tracing.sync(state)
    start.record()
    state = sim.run(state, src[n0:n1], TRACE_STEPS)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    reset_counts()
    with tempfile.TemporaryDirectory() as logdir:
        with tracing.trace(logdir) as prof:
            t0 = time.perf_counter()
            state = sim.run(state, src[n1:], TRACE_STEPS)
            tracing.sync(state)
            span_us = (time.perf_counter() - t0) * 1e6
        trace_mib = os.path.getsize(os.path.join(logdir, "trace.json")) / 2**20
    modes = launches_by_mode()
    check_launches("trace", modes, [r"B R=2 K=\d float32 m"], [r"B R=2 K=2 float32 m"])
    busy = tracing.device_busy_us(prof)
    by_name = sorted(((getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0.0), e.key)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)[:6]
    print(f"  trace of {TRACE_STEPS} main-path steps ({MAIN_N}^3, K={sim.engine.sweep_k}):"
          f" device busy {busy / 1e3:.3f} ms of a {span_us / 1e3:.3f} ms window,"
          f" busy share {busy / span_us:.4f}, idle share {1 - busy / span_us:.4f}; the same"
          f" {TRACE_STEPS} steps before it without the profiler {plain_ms:.3f} ms (CUDA events),"
          f" the traced busy time's share of that {busy / 1e3 / plain_ms:.4f}; device ms by"
          f" name: " + ", ".join(f"{k[:48]} {t / 1e3:.3f}" for t, k in by_name if t)
          + f"; Chrome trace {trace_mib:.1f} MiB; launches {modes} [{smi}]")
    if not busy > 0:
        raise AssertionError("trace: torch.profiler recorded no device time")
    return modes


def phase_bench(tt, dev):
    """The port's bench line (harness/bench.py): the 128^3 gate and 512^3 x 50
    on the default path. Returns the launches per mode."""
    from tpufdtd_torch.harness import bench

    reset_counts()
    line = bench.measure(dev)
    modes = launches_by_mode()
    check_launches("bench", modes, [r"A R=2 float32 scalar", r"B R=2 K=\d float32 m"],
                   [r"A R=2 float32 scalar", r"B R=2 K=2 float32 m"])
    print(f"[18 bench] {json.dumps(line)}")
    if not line["correctness_pass"]:
        raise AssertionError(f"bench: the gate failed, rel-L2 {line['rel_l2_vs_oracle_128']}")
    return modes


def print_tiles_a():
    """Kernel A's block shape per mode (ops/stencil_step.tile_for), with its
    blocks per SM, cells per thread and shared memory."""
    from tpufdtd_torch.ops import stencil_step as A

    for storage in A.STORAGE.values():
        for mkind in ("scalar", "per-point"):
            modes = []
            for r in A.RADII:
                tile = A.tile_for(r, storage, mkind)
                blocks = A.blocks_per_sm(r, tile)
                modes.append(f"R={r} {tile} {blocks}/SM {A.cells_per_thread(r, blocks)} cells"
                             f" {A.smem_bytes(r, tile, storage, mkind)} B")
            print(f"  A {storage} m {mkind}: " + "; ".join(modes))


def run_phases(tt, dev, smi):
    """Phases 3-18; returns the kernels line's entries."""
    from tpufdtd_torch.ops.stencil_sweep import DEEP_TILES, MODE_RADII
    from tpufdtd_torch.stepper import K_AUTO, MODE_K  # MODE_K: the w and bf16 modes' K

    def deep_ks(radius):  # the deep form's depths at a radius, each timed plain too
        return [k for r, k in sorted(DEEP_TILES) if r == radius]

    print("[2b kernel A block shapes (XC, TY, TZ) per mode]")
    print_tiles_a()
    print("[3 kernel A vs plain]")
    a4 = phase_kernel_a(tt, dev)
    print("[3b kernel A at order 12 vs plain]")
    a12 = phase_kernel_a_order12(tt, dev)
    print("[4 kernel B vs plain]")
    b = {2: phase_kernel_b(tt, dev, 2, sorted({K_AUTO[2], *deep_ks(2)}))}
    print("[4b kernel B at radius 1, 3 and 4 vs plain]")
    for radius, plain_ks in ((1, [K_AUTO[1]]), (3, [K_AUTO[3]]), (4, [1, 2, K_AUTO[4]])):
        b[radius] = phase_kernel_b(tt, dev, radius, sorted({*plain_ks, *deep_ks(radius)}))

    print("[5 correctness gate]")
    launches_a = phase_gate(tt, dev)
    print(f"[6 main path {MAIN_N}^3 x 50]")
    launches_b = phase_main(tt, dev, smi)
    print(f"[7 high-order paths {MAIN_N}^3 x 50]")
    paths = {order: phase_high_order(tt, dev, smi, order) for order in HIGH_ORDERS}
    paths["order 8 t_fuse 2"] = phase_path(tt, dev, smi, 8, *FUSED2_LAUNCHES, plain=False,
                                           t_fuse=2)[0]

    print("[8 kernel modes vs plain: B with w, in bf16 and in bf16 with w; A in bf16]")
    bm = {}
    for storage, medium in NEW_MODES:
        for radius in MODE_RADII:
            bm[storage, medium, radius] = phase_kernel_b(tt, dev, radius,
                                                         sorted({MODE_K, *deep_ks(radius)}),
                                                         storage, medium)
    a_bf16 = phase_kernel_a_bf16(tt, dev)
    print("[9 heterogeneous paths: the layered medium]")
    for order in (4, 6):
        phase_layered_gate(tt, dev, order)
    for order, (allowed, needed) in LAYERED_LAUNCHES.items():
        paths[f"order {order} layered"] = phase_path(tt, dev, smi, order, allowed, needed,
                                                     layered=True, plain=False,
                                                     keep="order 4 layered" if order == 4
                                                     else None)[0]
    print(f"[10 bf16 paths {MAIN_N}^3 x 50]")
    for name, (order, layered, launches) in BF16_PATHS.items():
        paths[f"{name} bf16"] = phase_path(tt, dev, smi, order, launches, launches,
                                           layered=layered, storage="bfloat16", tol=BF16_TOL,
                                           plain=False, f32_twin=True,
                                           keep="order 4 bf16" if name == "order 4" else None)[0]
    print(f"[10b explicit t_fuse at the deep form's depths {MAIN_N}^3 x 50]")
    paths.update(phase_deep_paths(tt, dev, smi))
    TRUTHS.clear()
    print("[11 kernel B with frozen margins vs plain]")
    frozen = phase_frozen_margins(tt, dev)
    print("[11b kernel A at a shard of the sharded per-step path vs plain]")
    a_shard, a4_shard = phase_kernel_a_shard(tt, dev)
    print(f"[12 sharded paths {MAIN_N}^3 x 50, four shards on one card: no scaling figure]")
    for name, spec in SHARDED_PATHS.items():
        paths[name] = phase_sharded(tt, dev, smi, name, *spec)
    SINGLE.clear()
    print(f"[13 kernel_cuda (the reference ABI) {MAIN_N}^3 x 50]")
    paths["kernel_cuda"], a4_main = phase_kernel_cuda(tt, dev, smi)
    print(f"[14 checkpoint and resume on the main path {MAIN_N}^3 x 50]")
    paths["checkpoint"] = phase_checkpoint(tt, dev)
    print(f"[15 sharded checkpoint {MAIN_N}^3 x 50: x4, resumed on 2 x 2 and one device]")
    paths["sharded checkpoint"] = phase_sharded_checkpoint(tt, dev)
    print(f"[16 sharded sweep overlap on against off {MAIN_N}^3 x 50, four shards on the card]")
    for name, spec in OVERLAP_PATHS.items():
        paths[f"overlap {name}"] = phase_overlap(tt, dev, smi, name, *spec)
    print(f"[17 trace of {TRACE_STEPS} main-path steps]")
    paths["trace"] = phase_trace(tt, dev, smi)
    print("[18 bench]")
    paths["bench"] = phase_bench(tt, dev)

    def launched(pattern):
        """Launches of the modes matching `pattern`, per path that ran any."""
        out = {}
        for path, modes in paths.items():
            n = sum(v for key, v in modes.items() if re.fullmatch(pattern, key))
            if n:
                out[f"order {path}" if isinstance(path, int) else path] = n
        return out

    def b_mode(radius, k):
        return {**b[radius][k], "max_abs_err": b[radius]["max_abs_err"]}

    def total(pattern):
        return sum(launched(pattern).values())

    def b_new(storage, medium, radius):
        res = bm[storage, medium, radius]
        return {**res[MODE_K], "max_abs_err": res["max_abs_err"], "library_ms": None,
                "launches": total(rf"B R={radius} K=\d {storage} {medium}")}

    def a_new(radius, storage, mkind, res):
        return {**res, "library_ms": None, "launches": total(rf"A R={radius} {storage} {mkind}")}

    sweep = "tpufdtd_torch/csrc/stencil_sweep.cuh"
    deep = "tpufdtd_torch/csrc/stencil_sweep_deep.cuh"
    step = "tpufdtd_torch/csrc/stencil_step.cu"
    sweep_paths = launched(r"B R=[123] K=\d .*")
    a_paths = launched(r"A R=[1234] .*")
    mode_names = {("float32", "w"): "w", ("bfloat16", "m"): "bf16", ("bfloat16", "w"): "bf16+w"}
    sweep_modes = {f"R={r},K={K_AUTO[r]}": {
        **b_mode(r, K_AUTO[r]), "library_ms": None,
        "source": deep if (r, K_AUTO[r]) in DEEP_TILES else sweep,
        "launches": total(rf"B R={r} K=\d float32 m")} for r in (1, 3)}
    for (storage, medium), tag in mode_names.items():
        for r in MODE_RADII:
            sweep_modes[f"{tag} R={r},K={MODE_K}"] = b_new(storage, medium, r)
    # the deep form (csrc/stencil_sweep_deep.cuh), per mode and depth
    for r, k in sorted(DEEP_TILES):
        for (storage, medium), tag in {("float32", "m"): "f32", **mode_names}.items():
            res = b[r] if (storage, medium) == ("float32", "m") else bm[storage, medium, r]
            sweep_modes[f"deep {tag} R={r},K={k}"] = {
                **res[k], "max_abs_err": res["max_abs_err"], "library_ms": None,
                "source": deep, "launches": total(rf"B R={r} K={k} {storage} {medium}"),
                "path_launches": launched(rf"B R={r} K={k} {storage} {medium}")}
    a_mode = {f"R={r}, {s}, {mk} m, {MAIN_N}^3": a_new(r, s, mk, v)
              for (r, s, mk), v in a_bf16.items()}
    a_mode[f"R=4, float32, scalar m, a {a_shard} shard"] = a_new(4, "float32", "scalar",
                                                                 a4_shard)
    a_mode[f"R=2, float32, scalar m, {MAIN_N}^3"] = {
        **a4_main, "library_ms": None, "launches": paths["kernel_cuda"]["A R=2 float32 scalar"]}
    kernels = [
        {"name": "leapfrog_step_zsplit", "route": "cuda", "source": step,
         "replaces": "tpufdtd/ops/stencil_pallas_z.py:148", "mode": f"R=2, scalar m, {GATE_N}^3",
         "launches": launches_a + sum(a_paths.values()),
         "path_launches": {"gate": launches_a, **a_paths}, **a4,
         "modes": {k: v for k, v in a_mode.items() if not k.startswith("R=6")}},
        {"name": "sweep_fused", "route": "cuda", "source": sweep,
         "replaces": "tpufdtd/ops/stencil_sweep.py:1556",
         "mode": f"R=2,K={K_AUTO[2]} (order 4 main path)",
         "launches": sum(sweep_paths.values()) + launches_b,
         "path_launches": {"order 4": launches_b, **sweep_paths},
         **b_mode(2, K_AUTO[2]),
         "max_abs_err": max([b[r]["max_abs_err"] for r in (1, 2, 3)]
                            + [v["max_abs_err"] for v in bm.values()] + [frozen["max_abs_err"]]),
         "modes": {**sweep_modes, FROZEN_MODE: {
             **{k: v for k, v in frozen.items() if k != "max_abs_err"},
             "max_abs_err": frozen["max_abs_err"], "library_ms": None,
             "launches": sum(FROZEN_LAUNCHES.values()),
             "path_launches": dict(FROZEN_LAUNCHES)}}},
        {"name": "packed_step", "route": "cuda", "source": sweep,
         "replaces": "tpufdtd/ops/stencil_pallas_z.py:405", "mode": "R=4,K=1",
         "launches": total(r"B R=4 K=1 float32 m"),
         "path_launches": launched(r"B R=4 K=1 float32 m"), **b_mode(4, 1)},
        {"name": "packed_fused2", "route": "cuda", "source": sweep,
         "replaces": "tpufdtd/ops/stencil_pallas_z.py:542", "mode": "R=4,K=2",
         "launches": total(r"B R=4 K=2 float32 m"),
         "path_launches": launched(r"B R=4 K=2 float32 m"), **b_mode(4, 2)},
        {"name": "leapfrog_step_pallas", "route": "cuda", "source": step,
         "replaces": "tpufdtd/ops/stencil_pallas.py:185", "mode": "R=6, scalar m",
         "launches": total(r"A R=6 .* scalar"),
         "path_launches": launched(r"A R=6 .*"), **a12["scalar"],
         "max_abs_err": max(v["max_abs_err"] for v in a12.values()),
         "modes": {"R=6, per-point m": a_new(6, "float32", "per-point", a12["per-point"]),
                   **{k: v for k, v in a_mode.items() if k.startswith("R=6")}}},
    ]
    for entry in kernels:
        entry["library_ms"] = None  # no single PyTorch call computes a leapfrog step
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    import tpufdtd_torch as tt
    from tpufdtd_torch.ops import _build
    from tpufdtd_torch.utils.peaks import smi_line

    dev = torch.device("cuda", 0)
    smi = smi_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[1 card] {torch.cuda.get_device_name(0)} | {smi} | python {sys.version.split()[0]}"
          f" | torch {torch.__version__} | torch CUDA {torch.version.cuda} | nvcc {nvcc}")

    t0 = time.perf_counter()
    _build.library()
    print(f"[2 build] kernels built from tpufdtd_torch/csrc in {time.perf_counter() - t0:.1f} s"
          " (one nvcc per source, in parallel); ptxas per kernel:")
    log = _build.build_log()
    for line in log.splitlines():
        if line.startswith("nvcc "):
            print("  " + line)
    kernels = ptxas_summary(log)
    for name, regs, stack, spill_st, spill_ld in kernels:
        print(f"  {name}: {regs} registers, stack {stack} B, spills {spill_st}/{spill_ld} B")
    spilled = [k[0] for k in kernels if k[3] or k[4]]
    if not kernels or spilled:
        raise AssertionError(f"ptxas: {len(kernels)} kernels, spills in {spilled}")

    print(json.dumps({"kernels": run_phases(tt, dev, smi)}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())

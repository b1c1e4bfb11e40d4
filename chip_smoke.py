#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpufdtd_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:
  1. card: name, power limit, torch / CUDA / nvcc versions;
  2. build: both kernels from tpufdtd_torch/csrc, with nvcc's -Xptxas -v lines;
  3. kernel A (single step) against its plain version, rims bitwise;
  4. kernel B (K fused steps) against K plain steps, for K = 1..K_max, at
     the main path's 512^3 among other shapes;
  5. correctness gate: simulate() at 128^3 x 50 through kernel A against
     the torch-f64 truth (rel-L2 < 1e-4), counting kernel A's launches;
  6. main path: Simulator at 512^3 x 50, one Ricker source, fast ring on
     kernel B, against the f64 truth, counting kernel B's launches;
     ms/step, Gcell/s and % of HBM peak; the same run on the plain
     "torch" backend.
Then one JSON line per kernel set, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Exits 1 without a CUDA device.
"""

import json
import subprocess
import sys

import numpy as np

# Kernel against plain version. The bound is relative to the largest
# stencil increment, want - (the same steps with the Laplacian left out),
# not to the field: at the main path's dt = 1e-3, h = 0.1 the stencil adds
# ~1e-4 of the field per step, and a field-relative bound would pass a
# wrong stencil. CHECK_DT = 0.03 (dt/h = 0.3, stable at order 4) makes the
# increment as large as the field; nvcc contracts a*b+c into FMAs and the
# plain version does not, which costs ~1e-6 of the increment over K <= 4
# steps, while a 1e-3 error in the radius-2 weight alone shows as ~3e-5.
KERNEL_RTOL = 1e-5
CHECK_DT = 0.03
GATE_TOL = 1e-4  # rel-L2 against the f64 truth (harness/correctness.py)
GATE_N = 128  # correctness gate grid (bench.py:43)
MAIN_N = 512  # main-path grid (bench.py:60)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def compare(name, got, want, base, untouched, mask) -> float:
    """Max abs error of `got` against `want`, bounded by KERNEL_RTOL times
    the largest interior stencil increment |want - base|; the rim must
    equal `untouched` bit for bit."""
    import torch

    rim = ~mask
    if not torch.equal(got[..., rim], untouched[..., rim]):
        raise AssertionError(f"{name}: a rim cell changed")
    err = float((got - want).abs().max())
    scale = float((want - base)[..., mask].abs().max())
    if not np.isfinite(err) or not scale > 0 or err > KERNEL_RTOL * scale:
        raise AssertionError(f"{name}: max abs err {err:.3e} > {KERNEL_RTOL} * {scale:.3e}")
    print(f"  {name}: max_abs_err {err:.3e} (stencil increment max {scale:.3e}),"
          " rims bitwise unchanged")
    return err


def phase_kernel_a(tt, dev):
    import torch
    from tpufdtd_torch.ops import stencil_step as A

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [((GATE_N,) * 3, 4, "scalar"), ((GATE_N,) * 3, 4, "per-point"),
             ((17, 13, 11), 4, "scalar"), ((17, 13, 11), 4, "per-point")]
    cases += [((17, 13, 11), order, "per-point") for order in (2, 6, 8, 10, 12)]
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
    print(f"  A at {GATE_N}^3: kernel {ms:.4f} ms/step, plain {plain:.4f} ms/step")
    return worst, ms, plain


def _fast_pair(grid, gen, dev):
    """U = [u_{n-1}, u_n] with one shared random rim (the fast ring's
    contract), and the second buffer holding the same rims."""
    import torch

    U = torch.randn((2,) + grid.padded_shape, generator=gen, device=dev)
    mask = interior_mask(grid, dev)
    U[0][~mask] = U[1][~mask]
    return U, U.clone(), mask


def _lap_free(U, k):
    """[u_{n+K-1}, u_{n+K}] of K leapfrog steps with no Laplacian: the
    linear extrapolation u_n + j (u_n - u_{n-1})."""
    import torch

    d = U[1] - U[0]
    return torch.stack([U[1] + (k - 1) * d, U[1] + k * d])


def check_b(B, grid, U, out, mask, k):
    got = B.sweep_fused(U, out.clone(), grid=grid, dt=CHECK_DT, m_val=1.5, k_fuse=k)
    want = B.sweep_fused_ref(U, grid=grid, dt=CHECK_DT, m_val=1.5, k_fuse=k)
    name = f"B {grid.nx}x{grid.ny}x{grid.nz} h=({grid.hx},{grid.hy},{grid.hz}) K={k}"
    return compare(name, got, want, _lap_free(U, k), out, mask)


def phase_kernel_b(tt, dev):
    import torch
    from tpufdtd_torch.ops import stencil_sweep as B
    from tpufdtd_torch.stepper import K_AUTO

    gen = torch.Generator(device=dev).manual_seed(2)
    kmax = B.k_max()
    worst = 0.0
    # 1100 x-planes span several x-chunks of a block at every K
    # (stencil_sweep.TILES), as 512^3 does at K = 1
    grids = [tt.Grid3D(GATE_N, GATE_N, GATE_N), tt.Grid3D(17, 13, 11),
             tt.Grid3D(17, 13, 11, hx=0.1, hy=0.05, hz=0.2), tt.Grid3D(1100, 12, 20)]
    for grid in grids:
        U, out, mask = _fast_pair(grid, gen, dev)
        for k in range(1, kmax + 1):
            worst = max(worst, check_b(B, grid, U, out, mask, k))
    # the main path's shape: checked, then timed
    grid = tt.Grid3D(MAIN_N, MAIN_N, MAIN_N)
    U, out, mask = _fast_pair(grid, gen, dev)
    per_k = {}
    for k in range(1, kmax + 1):
        worst = max(worst, check_b(B, grid, U, out, mask, k))
        ms = cuda_ms(lambda: B.sweep_fused(U, out, grid=grid, dt=1e-3, m_val=1.5, k_fuse=k), 10)
        per_k[k] = ms
        print(f"  B at {MAIN_N}^3 K={k}: {ms:.4f} ms/call, {ms / k:.4f} ms/step")
    plain = cuda_ms(lambda: B.sweep_fused_ref(U, grid=grid, dt=1e-3, m_val=1.5,
                                              k_fuse=K_AUTO), 3)
    print(f"  B plain at {MAIN_N}^3 K={K_AUTO}: {plain:.4f} ms/call, {plain / K_AUTO:.4f} ms/step")
    return worst, per_k[K_AUTO], plain


def launch_counts():
    """Launches since the last reset: kernel A, kernel B, plain versions."""
    from tpufdtd_torch.ops import stencil_step as A, stencil_sweep as B

    return A.counts["kernel"], B.counts["kernel"], A.counts["plain"] + B.counts["plain"]


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


def run_main(tt, dev, backend):
    n, nsteps = MAIN_N, 50
    grid = tt.Grid3D(n, n, n)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, warmup_steps=5, backend=backend)
    m = np.full(grid.padded_shape, 1.5, np.float32)
    src = tt.ricker_table(nsteps, 1, cfg.dt)
    coords = tt.default_source_coords(1, n, n, n)
    u0 = np.zeros(grid.padded_shape, np.float32)
    sim = tt.Simulator(grid, cfg, m, coords, device=dev)
    state = sim.prepare_state(u0, u0)
    state, secs, clock = sim.run_timed(state, src)
    assert clock == "cuda_event"
    return sim, state, secs, (u0, m, src, coords)


def phase_main(tt, dev, smi):
    """The main path's perf half; returns kernel B's launches in it."""
    from tpufdtd_torch.utils import metrics
    from tpufdtd_torch.utils.peaks import detect_peaks

    n, nsteps, timed = MAIN_N, 50, 45
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
    _, c_true, _ = tt.truth_run_ring(u0, u0, m, sim.grid, 0.001, nsteps, src, coords, device=dev)
    l2 = rel_l2(c, c_true)
    print(f"  {n}^3 x 50 u_N: rel-L2 {l2:.3e} vs f64 truth, max |u| {mx:.4e}")
    if not l2 < GATE_TOL:
        raise AssertionError(f"main-path rel-L2 {l2} >= {GATE_TOL}")
    del c, c_true

    peaks = detect_peaks(dev)
    times = [secs]
    for seed in range(3):
        st = sim.prepare_state_random(seed)
        _, s, _ = sim.run_timed(st, src)
        times.append(s)
        del st
    t = float(np.median(times))
    del sim
    _, state_t, secs_t, _ = run_main(tt, dev, "torch")
    del state_t
    for name, tt_s in (("cuda", t), ("torch", secs_t)):
        ms_step = tt_s / timed * 1e3
        gcell = n**3 * timed / tt_s / 1e9
        # the reference convention (main.cpp:429-431): 50 steps over the
        # 45-step timed span, as the 28.3 % CUDA_Optimized yardstick uses
        hbm_ref = metrics.gbps_model(n, n, n, nsteps, tt_s, metrics.BYTES_OPTIMIZED) / peaks.hbm_gbps * 100
        hbm_step = n**3 * metrics.BYTES_OPTIMIZED / (ms_step * 1e-3) / 1e9 / peaks.hbm_gbps * 100
        print(f"  {n}^3 {name}: {ms_step:.4f} ms/step, {gcell:.3f} Gcell/s, "
              f"{hbm_step:.2f} % of HBM peak (12 B/pt per timed step), "
              f"{hbm_ref:.2f} % (reference convention) [{smi}]")
    print(f"  {n}^3 cuda timed spans (s): {times}")
    return b


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    import tpufdtd_torch as tt
    from tpufdtd_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = smi_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[1 card] {torch.cuda.get_device_name(0)} | {smi} | python {sys.version.split()[0]}"
          f" | torch {torch.__version__} | torch CUDA {torch.version.cuda} | nvcc {nvcc}")

    _build.library()
    print("[2 build] kernels built from tpufdtd_torch/csrc:")
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())

    print("[3 kernel A vs plain]")
    err_a, ms_a, plain_a = phase_kernel_a(tt, dev)
    print("[4 kernel B vs plain]")
    err_b, ms_b, plain_b = phase_kernel_b(tt, dev)

    print("[5 correctness gate]")
    launches_a = phase_gate(tt, dev)
    print(f"[6 main path {MAIN_N}^3 x 50]")
    launches_b = phase_main(tt, dev, smi)

    kernels = [
        {"name": "leapfrog_step", "route": "cuda",
         "source": "tpufdtd_torch/csrc/stencil_step.cu",
         "replaces": "tpufdtd/ops/stencil_pallas_z.py:148", "launches": launches_a,
         "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a},
        {"name": "sweep_fused", "route": "cuda",
         "source": "tpufdtd_torch/csrc/stencil_sweep.cu",
         "replaces": "tpufdtd/ops/stencil_sweep.py:1556", "launches": launches_b,
         "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

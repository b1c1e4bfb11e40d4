"""Correctness phase: differential testing against the f64 truth.

The reference's correctness phase (main.cpp:511-685): per size, 50 steps,
no sources, IC u = sin(i*0.001)*10+100 over the flat padded volume on ring
levels 0 and 1 (level 2 starts zeroed), m = 1.5, dt = 1e-3, h = 1.0;
max-abs / max-rel / relative-L2 / NaN / Inf over all three ring levels.

Gate: relative L2 < 1e-4 and no NaN/Inf, against the torch-f64 truth
(oracle.truth_run_ring) run on the same device. The reference's code gates
max-abs < 1e-4 (main.cpp:603), which holds only between backends built from
one source with identical FMA contraction; its README documents L2 < 1e-4
(README.md:33).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List

import numpy as np

from ..config import Grid3D, SimConfig
from ..oracle import truth_run_ring
from ..stepper import simulate_ring

DEFAULT_SIZES = (32, 64, 128, 256, 512)
TOLERANCE = 1e-4


@dataclasses.dataclass
class ErrorReport:
    method: str
    size: int
    max_abs: float
    max_rel: float
    rel_l2: float
    nan_count: int
    inf_count: int

    @property
    def passed(self) -> bool:
        return self.rel_l2 < TOLERANCE and self.nan_count == 0 and self.inf_count == 0


def error_scan(test: np.ndarray, ref: np.ndarray):
    """max-abs, max-rel (|ref| > 1e-10), relative L2, NaN and Inf counts
    (main.cpp:577-592)."""
    t = np.asarray(test, np.float64).ravel()
    r = np.asarray(ref, np.float64).ravel()
    nan_count = int(np.isnan(t).sum())
    inf_count = int(np.isinf(t).sum())
    ok = np.isfinite(t)
    diff = np.abs(t[ok] - r[ok])
    absr = np.abs(r[ok])
    max_abs = float(diff.max()) if diff.size else 0.0
    denom_ok = absr > 1e-10
    max_rel = float((diff[denom_ok] / absr[denom_ok]).max()) if denom_ok.any() else 0.0
    l2 = float(np.sqrt((diff**2).sum() / ((r[ok] ** 2).sum() + 1e-30)))
    return max_abs, max_rel, l2, nan_count, inf_count


def make_ic(grid: Grid3D):
    """sin(i*0.001)*10+100 over the flat padded volume (main.cpp:528)."""
    volp = int(np.prod(grid.padded_shape))
    idx = np.arange(volp, dtype=np.float32).reshape(grid.padded_shape)
    u_cur = np.sin(idx * np.float32(0.001)) * np.float32(10.0) + np.float32(100.0)
    u_prev = np.zeros_like(u_cur)
    m = np.full(grid.padded_shape, 1.5, dtype=np.float32)
    return u_prev, u_cur, m


def run_correctness_single(size: int, nsteps: int = 50,
                           backends: Iterable[str] = ("torch", "cuda"),
                           verbose: bool = True, *, device) -> List[ErrorReport]:
    grid = Grid3D(size, size, size, hx=1.0, hy=1.0, hz=1.0)
    up0, uc0, m = make_ic(grid)
    if verbose:
        print(f"\nTest configuration: {size}x{size}x{size} grid, {nsteps} timesteps")
        print("Running f64 truth...")
    truth = np.stack(truth_run_ring(up0, uc0, m, grid, 0.001, nsteps, device=device))

    reports = []
    for backend in backends:
        if verbose:
            print(f"Running {backend}...")
        cfg = SimConfig(dt=0.001, nsteps=nsteps, backend=backend)
        ring = simulate_ring(up0, uc0, m, grid, cfg, device=device)
        got = np.stack([np.asarray(x, np.float64) for x in ring])
        max_abs, max_rel, l2, nans, infs = error_scan(got, truth)
        rep = ErrorReport(backend, size, max_abs, max_rel, l2, nans, infs)
        reports.append(rep)
        if verbose:
            print(f"  {backend} vs truth:")
            print(f"    Max absolute difference: {max_abs:.2e}")
            print(f"    Max relative difference: {max_rel:.2e}")
            print(f"    L2 norm error: {l2:.2e}")
            print(f"    NaN count: {nans}  Inf count: {infs}")
            print(f"  Result: {'PASS' if rep.passed else 'FAIL'}")
    return reports


def run_correctness(sizes: Iterable[int] = DEFAULT_SIZES, nsteps: int = 50,
                    backends: Iterable[str] = ("torch", "cuda"),
                    verbose: bool = True, *, device) -> List[ErrorReport]:
    """Correctness ladder over the reference's sizes 32^3-512^3 (main.cpp:679)."""
    out: List[ErrorReport] = []
    for s in sizes:
        out.extend(run_correctness_single(s, nsteps, backends, verbose, device=device))
    if verbose:
        ok = all(r.passed for r in out)
        print(f"\nOverall correctness: {'PASS' if ok else 'FAIL'} "
              f"({sum(r.passed for r in out)}/{len(out)})")
    return out

"""Benchmark CLI, the reference's main() flow (main.cpp:767-835): detect the
card -> Step 1 correctness -> Step 2 performance sweep over the backends
(fresh CSV) -> Step 3 echo the CSV.

Usage:
  python -m tpufdtd_torch.harness.cli                      # full run
  python -m tpufdtd_torch.harness.cli --sizes 32 64 --grids 128 256
  python -m tpufdtd_torch.harness.cli --skip-correctness --backends cuda
"""

from __future__ import annotations

import argparse
import os
import sys

from ..utils.peaks import detect_peaks
from .correctness import run_correctness
from .perf import DEFAULT_GRIDS, run_benchmark


def main(argv=None):
    p = argparse.ArgumentParser(description="3D acoustic FDTD benchmark (PyTorch / CUDA)")
    p.add_argument("--sizes", type=int, nargs="*", default=[32, 64, 128, 256, 512],
                   help="correctness grid sizes (the reference ladder, main.cpp:679)")
    p.add_argument("--grids", type=int, nargs="*", default=list(DEFAULT_GRIDS),
                   help="performance grid sizes")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--sources", type=int, default=1)
    p.add_argument("--backends", nargs="*", default=["torch", "cuda"])
    p.add_argument("--csv", default="benchmark.csv")
    p.add_argument("--device", default="cuda")
    p.add_argument("--order", type=int, default=4)
    p.add_argument("--hbm-frac", type=float, default=0.8,
                   help="fraction of device memory the working-set guard may use")
    p.add_argument("--skip-correctness", action="store_true")
    p.add_argument("--skip-perf", action="store_true")
    p.add_argument("--append-csv", action="store_true",
                   help="append to an existing CSV instead of replacing it")
    args = p.parse_args(argv)

    peaks = detect_peaks(args.device)
    print("==========================================")
    print(" 3D acoustic FDTD benchmark (PyTorch / CUDA)")
    print("==========================================")
    print(f"Device: {peaks.name}")
    print(f"Peak HBM BW: {peaks.hbm_gbps:.0f} GB/s | f32: {peaks.fp32_gflops:.0f} GFLOP/s"
          f" | memory: {peaks.hbm_gib:.0f} GiB")

    ok = True
    if not args.skip_correctness:
        print("\n=== Step 1: Correctness ===")
        reports = run_correctness(args.sizes, args.steps, args.backends, device=args.device)
        ok = all(r.passed for r in reports)

    if not args.skip_perf:
        print("\n=== Step 2: Performance ===")
        if args.csv and os.path.exists(args.csv) and not args.append_csv:
            os.remove(args.csv)
        for backend in args.backends:
            run_benchmark(method=backend, grids=args.grids, timesteps=args.steps,
                          nsrc=args.sources, reps=args.reps, csv_path=args.csv,
                          peaks=peaks, hbm_budget_frac=args.hbm_frac,
                          order=args.order, device=args.device)
        if args.csv and os.path.exists(args.csv):
            print(f"\n=== Step 3: Results ({args.csv}) ===")
            with open(args.csv) as f:
                sys.stdout.write(f.read())
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Benchmark CLI, the reference's main() flow (main.cpp:767-835): detect the
card -> Step 1 correctness -> Step 2 performance sweep over the backends
(fresh CSV) -> Step 3 echo the CSV.

Usage:
  python -m tpufdtd_torch.harness.cli                      # full run
  python -m tpufdtd_torch.harness.cli --sizes 32 64 --grids 128 256
  python -m tpufdtd_torch.harness.cli --skip-correctness --backends cuda
  python -m tpufdtd_torch.harness.cli --storage bfloat16 --medium layered
  python -m tpufdtd_torch.harness.cli --sharded 4 --grids 512   # rows appended to
                                                                # benchmark_sharded_torch.csv
  TORCHFDTD_STORAGE=bfloat16 python -m tpufdtd_torch.harness.cli --grids 1024

The TORCHFDTD_* knobs (utils/envcfg.py) set the storage dtype, the fusion
depth and the backends besides "torch", as the JAX CLI reads TPUFDTD_*;
--storage, --t-fuse and --backends override them.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..utils.envcfg import runtime_config
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
    p.add_argument("--backends", nargs="*", default=None,
                   help="default: torch and TORCHFDTD_BACKEND (cuda)")
    p.add_argument("--csv", default="benchmark.csv")
    p.add_argument("--device", default="cuda")
    p.add_argument("--order", type=int, default=4,
                   help="stencil order 2-12, for the correctness ladder and the perf sweep")
    p.add_argument("--storage", choices=("float32", "bfloat16"), default=None,
                   help="storage dtype of the levels (compute is f32); default"
                        " TORCHFDTD_STORAGE (float32)")
    p.add_argument("--t-fuse", type=int, default=None,
                   help="steps per kernel-B call in the perf sweep; default TORCHFDTD_TFUSE"
                        " (0: stepper.K_AUTO)")
    p.add_argument("--medium", choices=("uniform", "layered"), default="uniform",
                   help="m = 1.5, or the layered medium of harness/media.py (perf sweep)")
    p.add_argument("--hbm-frac", type=float, default=0.8,
                   help="fraction of device memory the working-set guard may use")
    p.add_argument("--skip-correctness", action="store_true")
    p.add_argument("--skip-perf", action="store_true")
    p.add_argument("--append-csv", action="store_true",
                   help="append to an existing CSV instead of replacing it")
    p.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="benchmark the sharded engines over N shards of a 1-D mesh, one"
                        " card each while there are cards, then round robin over them (rows"
                        " tagged @<cards>card); rows in --sharded-csv with Devices and a blank"
                        " Scaling_Eff column")
    p.add_argument("--sharded-csv", default="benchmark_sharded_torch.csv",
                   help="CSV the --sharded rows are appended to")
    args = p.parse_args(argv)
    rc = runtime_config()
    storage = args.storage or rc.storage
    t_fuse = rc.t_fuse if args.t_fuse is None else args.t_fuse
    backends = args.backends or list(dict.fromkeys(["torch", rc.backend]))

    if args.sharded:
        import torch

        from .perf_sharded import run_sharded_benchmark

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            raise RuntimeError("--sharded times CUDA cards; none is visible")
        devices = [f"cuda:{i % cards}" for i in range(args.sharded)]
        path = args.sharded_csv
        run_sharded_benchmark(args.sharded, grids=args.grids, timesteps=args.steps,
                              nsrc=args.sources, reps=args.reps, csv_path=path,
                              devices=devices, order=args.order)
        print(f"\n=== Sharded results ({path}) ===")
        with open(path) as f:
            sys.stdout.write(f.read())
        return 0

    peaks = detect_peaks(args.device)
    print("==========================================")
    print(" 3D acoustic FDTD benchmark (PyTorch / CUDA)")
    print("==========================================")
    print(f"Device: {peaks.name}")
    print(f"Peak HBM BW: {peaks.hbm_gbps:.0f} GB/s | f32: {peaks.fp32_gflops:.0f} GFLOP/s"
          f" | memory: {peaks.hbm_gib:.0f} GiB")
    print(f"Runtime config: backends={','.join(backends)} storage={storage} t_fuse={t_fuse}"
          f" pair={rc.pair}")

    ok = True
    if not args.skip_correctness:
        print("\n=== Step 1: Correctness ===")
        reports = run_correctness(args.sizes, args.steps, backends, order=args.order,
                                  storage_dtype=storage, device=args.device)
        ok = all(r.passed for r in reports)

    if not args.skip_perf:
        print("\n=== Step 2: Performance ===")
        if args.csv and os.path.exists(args.csv) and not args.append_csv:
            os.remove(args.csv)
        for backend in backends:
            run_benchmark(method=backend, grids=args.grids, timesteps=args.steps,
                          nsrc=args.sources, reps=args.reps, csv_path=args.csv,
                          peaks=peaks, hbm_budget_frac=args.hbm_frac, t_fuse=t_fuse,
                          order=args.order, storage_dtype=storage,
                          medium=args.medium, device=args.device)
        if args.csv and os.path.exists(args.csv):
            print(f"\n=== Step 3: Results ({args.csv}) ===")
            with open(args.csv) as f:
                sys.stdout.write(f.read())
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

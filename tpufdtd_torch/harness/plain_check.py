"""The main path's u_N on the kernels against the plain "torch" backend, at
one grid size on a CUDA card: the check beside a ladder run at sizes whose
f64 truth does not fit beside them (1024^3).

    python3 -m tpufdtd_torch.harness.plain_check --grid 1024 [--storage bfloat16]

Both runs take the bench's configuration (N^3 x 50, h = 0.1, dt = 1e-3, one
Ricker source at the reference's default coordinates, zero ICs, m = 1.5,
ring "auto"): "cuda" takes the fast ring on kernel B, "torch" the exact
ring on the eager step, both in the storage dtype. Prints one line with the
rel-L2 of u_N between them and the card's name and power limit; exits 1
when it is not below the gate (1e-4 in f32, where fused and step-by-step
f32 runs differ by association only; 5e-2 in bf16, where the fused run
rounds the levels once per K-block and the exact ring every step).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import Grid3D, SimConfig
from ..stepper import Simulator
from ..utils.peaks import smi_line
from ..wavelets import default_source_coords, ricker_table
from .correctness import error_scan

GATE = {"float32": 1e-4, "bfloat16": 5e-2}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--grid", type=int, default=1024)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--storage", choices=tuple(GATE), default="float32")
    args = p.parse_args(argv)
    n = args.grid
    grid = Grid3D(n, n, n)
    m = np.full(grid.padded_shape, 1.5, np.float32)
    u0 = np.zeros(grid.padded_shape, np.float32)
    src = ricker_table(args.steps, 1, 0.001)
    coords = default_source_coords(1, n, n, n)
    out = {}
    for backend in ("cuda", "torch"):
        cfg = SimConfig(dt=0.001, nsteps=args.steps, backend=backend, storage_dtype=args.storage)
        sim = Simulator(grid, cfg, m, coords, device="cuda")
        state = sim.run(sim.prepare_state(u0, u0), src, args.steps)
        out[backend] = sim.extract_state(state)[1]
        del sim, state
        torch.cuda.empty_cache()
    a, b = out["cuda"], out["torch"]
    _, _, l2, nans, infs = error_scan(a, b)
    ok = bool(nans == 0 and infs == 0 and l2 < GATE[args.storage])
    print(f"plain_check {n}^3 x {args.steps} {args.storage}: u_N cuda vs torch rel-L2 {l2:.3e}"
          f" (< {GATE[args.storage]}: {ok}), max |u| cuda {np.abs(a).max():.4e} torch"
          f" {np.abs(b).max():.4e} [{smi_line()}]")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Headline benchmark of the port: 512^3 x 50 steps on one card.

    python3 -m tpufdtd_torch.harness.bench

Prints ONE JSON line with the keys of the repo's bench.py (which imports
JAX and stays as it is), plus the card's power limit:
  {"metric": ..., "value": N, "unit": "%", "vs_baseline": N, ...}

  * correctness gate: 128^3 x 50, the reference's sin IC, h = 1, on the
    default path against the torch-f64 truth on the card (bench.py:43-57);
  * performance: 512^3 x 50 (h = 0.1, dt = 1e-3, one Ricker source, m = 1.5)
    on the default path (TORCHFDTD_BACKEND, TORCHFDTD_STORAGE,
    TORCHFDTD_TFUSE; utils/envcfg.py) from a random state made
    on the card; REPS reps chain on the card (each rep's final state is the
    next rep's start), each timed with CUDA events around its 45 steps after
    the 5 warmup steps (Simulator.run_timed), and the device time is the
    median over the reps after the first.
The headline is the reference's model percent: 12 B/pt/step in f32 (6 in
bf16) over the device time, 50 steps' bytes over the 45-step time
(main.cpp:429-431), against the card's published HBM peak; the baseline is
the reference's CUDA_Optimized at 28.3 % of H100 peak. Raises without a card.
"""

from __future__ import annotations

import json

import numpy as np

from ..config import Grid3D, SimConfig
from ..oracle import truth_run_ring
from ..stepper import Simulator, resolve_device, simulate
from ..utils import metrics
from ..utils.envcfg import runtime_config
from ..utils.peaks import detect_peaks, smi_line
from ..wavelets import default_source_coords, ricker_table
from .correctness import BF16_TOLERANCE, TOLERANCE, error_scan, make_ic

GATE_N, MAIN_N, NSTEPS, WARMUP, REPS = 128, 512, 50, 5, 7
BASELINE_PCT = 28.3


def measure(device="cuda") -> dict:
    """The bench line's fields, measured on `device` (a CUDA card)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the bench times a CUDA card; got {device!r}")
    rc = runtime_config()
    peaks = detect_peaks(dev)

    g_c = Grid3D(GATE_N, GATE_N, GATE_N, hx=1.0, hy=1.0, hz=1.0)
    up0, uc0, m_c = make_ic(g_c)
    _, uc_t, _ = truth_run_ring(up0, uc0, m_c, g_c, 0.001, NSTEPS, device=dev)
    cfg_c = SimConfig(dt=0.001, nsteps=NSTEPS, backend=rc.backend, storage_dtype=rc.storage,
                      t_fuse=rc.t_fuse)
    _, uc = simulate(up0, uc0, m_c, g_c, cfg_c, device=dev)
    _, _, l2, nans, infs = error_scan(uc, uc_t)
    tol = BF16_TOLERANCE if rc.storage == "bfloat16" else TOLERANCE

    n = MAIN_N
    grid = Grid3D(n, n, n)
    cfg = SimConfig(dt=0.001, nsteps=NSTEPS, warmup_steps=WARMUP, backend=rc.backend,
                    storage_dtype=rc.storage, t_fuse=rc.t_fuse)
    sim = Simulator(grid, cfg, np.full(grid.padded_shape, 1.5, np.float32),
                    default_source_coords(1, n, n, n), device=dev)
    src = ricker_table(NSTEPS, 1, cfg.dt)
    state = sim.prepare_state_random(0)
    times = []
    for _ in range(REPS):
        state, secs = sim.run_timed(state, src)
        times.append(secs)
    device_time = float(np.median(times[1:]))

    bytes_pt = metrics.optimized_bytes(rc.storage, getattr(sim.engine, "field_reads_per_step",
                                                           0.0))
    gbps = metrics.gbps_model(n, n, n, NSTEPS, device_time, bytes_pt)
    mem_eff = gbps / peaks.hbm_gbps * 100.0
    return {
        "metric": f"{n}^3x{NSTEPS} HBM efficiency ({bytes_pt:g}B/pt model) vs chip peak",
        "value": round(mem_eff, 2),
        "unit": "%",
        "vs_baseline": round(mem_eff / BASELINE_PCT, 3),
        "gcells_per_s": round(n**3 * NSTEPS / device_time / 1e9, 2),
        "gflops_model": round(metrics.gflops_model(n, n, n, NSTEPS, device_time, grid.order), 1),
        "device_time_ms": round(device_time * 1e3, 2),
        "rel_l2_vs_oracle_128": l2,
        "correctness_pass": bool(l2 < tol and nans == 0 and infs == 0),
        "device": peaks.name,
        "chip_peak_gbps": peaks.hbm_gbps,
        "baseline": f"CUDA_Optimized {BASELINE_PCT}% of H100 peak (STABILITY_FIX_LOG.md:153)",
        "power_limit": smi_line(dev.index or 0).split(",")[-1].strip(),
    }


def main() -> int:
    line = measure()
    print(json.dumps(line))
    return 0 if line["correctness_pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

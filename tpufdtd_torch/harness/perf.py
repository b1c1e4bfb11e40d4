"""Performance phase: grid sweep with stats, models and CSV.

The reference's perf phase (main.cpp:258-508): grid sweep x 50 steps x 1
Ricker source x 5 reps; grids whose state exceeds device memory are
skipped; m = 1.5, h = 0.1, dt = 1e-3; 5 warmup steps untimed; the
reference's FLOP and byte models; efficiency against the card's published
peaks; a CSV row per grid.

Times are CUDA-event times of the post-warmup span (Simulator.run_timed);
this path raises on any device that is not CUDA. Each rep starts from a
random state made on the device. The section split is measured by
default: the same span is timed once more without sources, and section1 =
full - that; measure_split=False gives the JAX package's work-share
estimate instead (section1 = 8 nsrc / (cells + 8 nsrc) of the time).

storage_dtype "bfloat16" stores the levels in bf16 (f32 compute); medium
"layered" replaces m = 1.5 by the layered medium of harness/media.py (a
per-point w stream on kernel B, a per-point m on kernel A). The byte model
follows both (metrics.optimized_bytes).
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..config import Grid3D, SimConfig
from ..stepper import Simulator, resolve_device
from ..utils import metrics
from ..utils.csvio import append_row
from ..utils.peaks import DevicePeaks, detect_peaks
from ..utils.stats import compute_stats
from ..wavelets import default_source_coords, ricker_table
from .media import layered

DEFAULT_GRIDS = (32, 64, 96, 128, 192, 256, 384, 512, 640, 768, 896, 1024)


def state_bytes(grid: Grid3D, method: str, t_fuse: int = 0, storage_dtype: str = "float32",
                *, medium: str = "uniform") -> int:
    """Working-set estimate for the skip check (the reference's guard,
    main.cpp:337-341), over levels of the padded shape (halo = order, so
    536^3 per level at order 12), at 4 B per level element in f32 and 2 B in
    bf16: the fast ring holds two 2-level buffers (the exact ring of "cuda",
    three levels, fits the same guard), plus the f32 m and w of a layered
    medium; the eager exact ring holds three levels, the f32 m and about six
    f32 interior-sized temporaries. As in the JAX package, every method but
    the eager one ("torch", or the JAX package's "jnp") takes the first
    estimate, its "pallas" included. `t_fuse` is the JAX package's argument
    and changes nothing here: there t_fuse 1 and 2 select packed engines of
    four levels, while in the port every depth runs on kernel B's fast
    ring, whose two buffers this estimate counts."""
    del t_fuse
    volp = int(np.prod(grid.padded_shape))
    esz = 2 if storage_dtype == "bfloat16" else 4
    if method not in ("torch", "jnp"):
        return volp * (4 * esz + (8 if medium == "layered" else 0)) + (256 << 20)
    return volp * (3 * esz + 7 * 4) + (256 << 20)


def run_benchmark(
    method: str = "cuda",
    grids: Iterable[int] = DEFAULT_GRIDS,
    timesteps: int = 50,
    nsrc: int = 1,
    reps: int = 5,
    csv_path: Optional[str] = "benchmark.csv",
    storage_dtype: str = "float32",
    peaks: Optional[DevicePeaks] = None,
    verbose: bool = True,
    hbm_budget_frac: float = 0.8,
    t_fuse: int = 0,
    pair: str = "auto",
    measure_split: bool = True,
    order: int = 4,
    timing_repeat: Optional[int] = None,
    *,
    medium: str = "uniform",
    device="cuda",
):
    """The JAX package's run_benchmark, positional order included; `pair`
    selects no code (SimConfig.pair); `timing_repeat` goes to
    Simulator.run_timed, None meaning 1 (the JAX package's automatic stretch
    evens out its remote device's dispatch jitter, which CUDA events around
    the span do not see). Returns one dict per grid run."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the perf phase times CUDA devices only; got {device!r}")
    if medium not in ("uniform", "layered"):
        raise ValueError(f"medium must be 'uniform' or 'layered'; got {medium!r}")
    peaks = peaks or detect_peaks(dev)
    results = []

    for gs in grids:
        grid = Grid3D(gs, gs, gs, order=order)
        need = state_bytes(grid, method, t_fuse, storage_dtype, medium=medium)
        if need > peaks.hbm_gib * (1 << 30) * hbm_budget_frac:
            if verbose:
                print(f"Skipping {gs}^3 grid (requires {need / 2**30:.1f} GB)")
            continue
        m = layered(grid) if medium == "layered" else np.full(grid.padded_shape, 1.5, np.float32)
        src = ricker_table(timesteps, nsrc, 0.001) if nsrc > 0 else None
        coords = default_source_coords(nsrc, gs, gs, gs) if nsrc > 0 else None
        cfg = SimConfig(dt=0.001, nsteps=timesteps, backend=method, t_fuse=t_fuse,
                        storage_dtype=storage_dtype, pair=pair)
        sim = Simulator(grid, cfg, m, coords, device=dev)
        bytes_pt = metrics.BYTES_NAIVE
        if method == "cuda":
            bytes_pt = metrics.optimized_bytes(storage_dtype, sim.engine.field_reads_per_step)
        ai = metrics.arithmetic_intensity(order, bytes_pt)
        if verbose:
            print(f"Running {method} FDTD (order {grid.order})...\n"
                  f"Grid: {gs}x{gs}x{gs} | Steps: {timesteps} | Sources: {nsrc}"
                  f" | AI: {ai:.4g} FLOPs/byte | {storage_dtype}, {medium} m")

        def timed(seed, table):
            t0 = time.perf_counter()
            state = sim.prepare_state_random(seed)
            _, secs = sim.run_timed(state, table, timing_repeat or 1)
            torch.cuda.synchronize(dev)
            return secs, time.perf_counter() - t0

        timed(0, src)  # warm: first launches load the kernel library
        runs = [timed(1 + rep, src) for rep in range(reps)]
        device_times = [r[0] for r in runs]
        total_times = [r[1] for r in runs]
        split_mode = "measured"
        if nsrc > 0 and measure_split:
            s0_meas = min(timed(100, None)[0], min(device_times))
            s1_meas = max(0.0, float(np.mean(device_times)) - s0_meas)
            s0_times = [t - s1_meas for t in device_times]
            s1_times = [s1_meas for _ in device_times]
        elif nsrc > 0:
            split_mode = "estimated"
            s1_share = (8.0 * nsrc) / (grid.interior_cells + 8.0 * nsrc)
            s0_times = [t * (1 - s1_share) for t in device_times]
            s1_times = [t * s1_share for t in device_times]
        else:
            s0_times = list(device_times)
            s1_times = [0.0 for _ in device_times]
        overheads = [max(0.0, t - d) for t, d in zip(total_times, device_times)]

        dstats = compute_stats(device_times)
        tstats = compute_stats(total_times)
        s0stats = compute_stats(s0_times)
        s1stats = compute_stats(s1_times)
        ostats = compute_stats(overheads)
        gfstats = compute_stats([
            metrics.gflops_model(gs, gs, gs, timesteps, d, grid.order) for d in device_times
        ])
        gbstats = compute_stats([
            metrics.gbps_model(gs, gs, gs, timesteps, d, bytes_pt) for d in device_times
        ])
        compute_eff = gfstats.mean / peaks.fp32_gflops * 100.0
        memory_eff = gbstats.mean / peaks.hbm_gbps * 100.0

        if verbose:
            print(f"Total time:   {tstats.mean*1e3:.3f} ± {tstats.stddev*1e3:.3f} ms\n"
                  f"Device time:  {dstats.mean*1e3:.3f} ± {dstats.stddev*1e3:.3f} ms"
                  f"  (section0={s0stats.mean*1e3:.3f}, section1={s1stats.mean*1e3:.3f} ms,"
                  f" split {split_mode})\n"
                  f"Perf:         {gfstats.mean:.1f} GFLOP/s, {gbstats.mean:.1f} GB/s\n"
                  f"{peaks.name}: {compute_eff:.1f}% compute, "
                  f"{memory_eff:.1f}% memory BW efficiency")

        if csv_path:
            append_row(
                csv_path, method,
                tstats.mean, tstats.stddev, s0stats.mean, s0stats.stddev,
                s1stats.mean, s1stats.stddev, dstats.mean, dstats.stddev,
                ostats.mean, ostats.stddev, gfstats.mean, gfstats.stddev,
                gbstats.mean, gbstats.stddev, compute_eff, memory_eff, ai,
                gs, gs, gs, timesteps, nsrc, grid.order,
            )

        # invariant checks (main.cpp:475-486) on a zero-IC run
        state = sim.prepare_state_random(0, scale=0.0)
        state = sim.run(state, src, timesteps)
        max_val, has_nan = sim.state_field_stats(state)
        if verbose:
            if has_nan:
                print("NaN detected")
            print(f"Max field value: {max_val:g}\n")
        if nsrc == 0 and max_val > 1e-7:
            print(f"[FAIL] Non-zero field with nsrc==0: {max_val}")

        results.append({
            "method": method,
            "size": gs,
            "device_time_s": dstats.mean,
            "gflops": gfstats.mean,
            "gbps": gbstats.mean,
            "memory_eff_pct": memory_eff,
            "gcells_per_s": gs**3 * timesteps / dstats.mean / 1e9,
            "nan": has_nan,
        })
        del sim, state
    return results

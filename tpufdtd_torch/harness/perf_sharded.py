"""Benchmark rows for sharded runs (parallel/).

Counterpart of tpufdtd/harness/perf_sharded.py. The reference has no
multi-GPU mode (grids over one device's memory are skipped,
main.cpp:337-341); these rows report the sharded engines. They use the
reference's 24-column CSV schema (utils/csvio.py) extended with Devices and
Scaling_Eff(%):

  * cells/s for the whole mesh and per shard,
  * Scaling_Eff(%), left blank: the JAX package fills it from a one-device
    run of the same grid, which needs a card per shard; the port has run
    only on one card (ROADMAP Queue 1 item 6).

When shards share a card (`devices=["cuda:0"] * 4`), the same program,
exchanges and freeze cases run on that card, and the row's method carries
the tag "@<n>card": shards on one card give no scaling figure. Times are
CUDA-event times of the span after the warmup steps, on every card of the
mesh (the longest).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..config import Grid3D, SimConfig
from ..utils import metrics
from ..utils.csvio import HEADER
from ..utils.peaks import detect_peaks
from ..utils.stats import compute_stats
from ..wavelets import default_source_coords, ricker_table

SHARDED_HEADER = HEADER + ",Devices,Scaling_Eff(%)"
NO_SCALING = "shards on one card: no scaling figure"


def append_sharded_row(path: str, fields) -> None:
    """One row of SHARDED_HEADER's 26 columns; None leaves a cell blank."""
    if len(fields) != SHARDED_HEADER.count(",") + 1:
        raise ValueError(f"{len(fields)} fields for {SHARDED_HEADER.count(',') + 1} columns")
    exists = os.path.exists(path)
    with open(path, "a") as f:
        if not exists:
            f.write(SHARDED_HEADER + "\n")
        out = []
        for v in fields:
            if isinstance(v, str):
                out.append(v)
            elif isinstance(v, int):
                out.append(str(v))
            elif v is None:
                out.append("")
            else:
                out.append(f"{float(v):g}")
        f.write(",".join(out) + "\n")


def _zero_rims(a, h):
    a[:h] = 0
    a[-h:] = 0
    a[:, :h] = 0
    a[:, -h:] = 0
    a[..., :h] = 0
    a[..., -h:] = 0
    return a


def timed_span(sim, fn):
    """(seconds, fn()): CUDA events before and after fn() on each card of
    the mesh, after all cards are idle; the longest span."""
    cards = sorted(set(sim.mesh.devices), key=str)
    if any(dv.type != "cuda" for dv in cards):
        raise RuntimeError(f"sharded timing needs CUDA devices; the mesh has {cards}")
    sim.synchronize()
    events = []
    for dv in cards:
        with torch.cuda.device(dv):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            events.append((dv, start, end))
    out = fn()
    for dv, _start, end in events:
        with torch.cuda.device(dv):
            end.record()
    sim.synchronize()
    return max(start.elapsed_time(end) for _dv, start, end in events) / 1e3, out


def timed_run(sim, grid: Grid3D, cfg: SimConfig, src, seed: int, m: np.ndarray) -> float:
    """One rep: random zero-rim ICs, cfg.warmup_steps untimed steps, the
    rest timed (the single-device run_timed convention)."""
    h = grid.halo
    rng = np.random.default_rng(seed)
    shape = grid.padded_shape
    ua = _zero_rims(rng.standard_normal(shape).astype(np.float32), h)
    ub = _zero_rims(rng.standard_normal(shape).astype(np.float32), h)
    state, m_sh, terms = sim.prepare(ua, ub, m)
    w = min(cfg.warmup_steps, cfg.nsteps)
    state = sim.run(state, m_sh, terms, None if src is None else src[:w], w)
    secs, _ = timed_span(sim, lambda: sim.run(state, m_sh, terms,
                                              None if src is None else src[w:cfg.nsteps],
                                              cfg.nsteps - w))
    return secs


def run_sharded_benchmark(
    n_shards: int,
    grids: Iterable[int] = (128, 256),
    timesteps: int = 50,
    nsrc: int = 1,
    reps: int = 3,
    csv_path: Optional[str] = "benchmark_sharded_torch.csv",
    devices: Optional[Sequence] = None,
    order: int = 4,
):
    """Benchmark the sharded engines over n_shards shards of a 1-D mesh;
    returns row dicts. `devices` places the shards (default: one card
    each, raising when there are fewer)."""
    from ..parallel import ShardedSimulator, make_mesh

    mesh = make_mesh(n_shards, devices=devices)
    shared = mesh.cards < mesh.size
    tag = f"@{mesh.cards}card" if shared else ""
    peaks = detect_peaks(mesh.devices[0])
    results = []
    for gs in grids:
        grid = Grid3D(gs, gs, gs, order=order)
        if gs % n_shards:
            print(f"Skipping {gs}^3 (nx % {n_shards} != 0)")
            continue
        cfg = SimConfig(dt=0.001, nsteps=timesteps, backend="cuda")
        src = ricker_table(timesteps, nsrc, cfg.dt) if nsrc else None
        coords = default_source_coords(nsrc, gs, gs, gs) if nsrc else None
        m = np.full(grid.padded_shape, 1.5, np.float32)
        sim = ShardedSimulator(grid, cfg, m, mesh, src_coords=coords)
        engine = f"sweep K={sim.sweep.K}" if sim.sweep is not None else "per-step"
        print(f"Sharded {gs}^3 x {timesteps}, order {order}, {n_shards} shards on"
              f" {mesh.cards} card(s) [{engine} engine]" + (f": {NO_SCALING}" if shared else ""))
        times = [timed_run(sim, grid, cfg, src, rep, m) for rep in range(reps + 1)][1:]
        dstats = compute_stats(times)
        gcells = gs**3 * timesteps / dstats.mean / 1e9
        gflops = metrics.gflops_model(gs, gs, gs, timesteps, dstats.mean, grid.order)
        gbps = metrics.gbps_model(gs, gs, gs, timesteps, dstats.mean, metrics.BYTES_OPTIMIZED)
        compute_eff = gflops / (peaks.fp32_gflops * mesh.cards) * 100.0
        memory_eff = gbps / (peaks.hbm_gbps * mesh.cards) * 100.0
        print(f"  device time {dstats.mean * 1e3:.3f} ± {dstats.stddev * 1e3:.3f} ms |"
              f" {dstats.mean / (timesteps - min(cfg.warmup_steps, timesteps)) * 1e3:.4f}"
              f" ms/step | {gcells:.2f} Gcell/s ({gcells / n_shards:.2f}/shard) |"
              f" mem eff {memory_eff:.1f}% | {peaks.name}")
        if csv_path:
            s1_share = (8.0 * nsrc) / (grid.interior_cells + 8.0 * nsrc)
            append_sharded_row(csv_path, [
                f"cuda-sharded{tag}",
                dstats.mean * 1e3, dstats.stddev * 1e3,
                dstats.mean * (1 - s1_share) * 1e3, 0.0,
                dstats.mean * s1_share * 1e3, 0.0,
                dstats.mean * 1e3, dstats.stddev * 1e3,
                0.0, 0.0,
                gflops, 0.0, gbps, 0.0,
                compute_eff, memory_eff,
                metrics.arithmetic_intensity(grid.order, metrics.BYTES_OPTIMIZED),
                gs, gs, gs, timesteps, nsrc, grid.order,
                n_shards, None,
            ])
        results.append({
            "size": gs, "shards": n_shards, "cards": mesh.cards, "engine": engine,
            "device_time_s": dstats.mean, "gcells_per_s": gcells,
            "gcells_per_s_per_shard": gcells / n_shards, "memory_eff_pct": memory_eff,
        })
        del sim
    return results

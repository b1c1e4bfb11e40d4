"""ms/step of the single-device and sharded 512^3 x 50 paths and of the grid ladder, on the card.

    PYTHONPATH=. python3 tpufdtd_torch/harness/span_times.py [--paths NAME ...]
        [--ladder 128 256 512 1024] [--sharded [NAME ...]] [--spans 4] [--eager]

Each path is the bench's run (h = 0.1, dt = 1e-3, one Ricker source at the
default coordinates, ring "auto", 50 steps) on a random state made on the
device, timed as Simulator.run_timed times it: 5 warmup steps, then CUDA
events around the other 45; the median of --spans spans, each on a new
state. With --eager the engine's eager loop (engine.run_scan, the loop a
Simulator captures) is timed the same way on the same states, beside it.
The ladder is the order-4 path at each grid size.

A sharded path (--sharded; all five without names) is chip_smoke.py's
phase 12 run: four shards on cuda:0, zero ICs and the Ricker source, 5
warmup steps through ShardedSimulator.run, then --spans spans of the other
45 steps, each continuing the state, timed with CUDA events on the card
(perf_sharded.timed_span) around a span made beforehand (`_span`: its graph
captured and its rows staged first; a checkout without it runs `run`, its
eager loop); with --eager each span is followed by one through the eager
loop (`_eager_span`).

The script imports `tpufdtd_torch` by name, so `PYTHONPATH=<checkout>`
times that checkout's package; a checkout whose engines predate the
m_args argument is timed without --eager. One JSON line per path, with
the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

N, NSTEPS = 512, 50
# name -> (order, layered medium, storage dtype, t_fuse): the single-device
# paths of chip_smoke.py's phases 6, 7, 9, 10 and 10b
PATHS = {
    "order 2": (2, False, "float32", 0),
    "order 4": (4, False, "float32", 0),
    "order 6": (6, False, "float32", 0),
    "order 8": (8, False, "float32", 0),
    "order 8 t_fuse 2": (8, False, "float32", 2),
    "order 12": (12, False, "float32", 0),
    "order 4 layered": (4, True, "float32", 0),
    "order 6 layered": (6, True, "float32", 0),
    "order 8 layered": (8, True, "float32", 0),
    "order 4 bf16": (4, False, "bfloat16", 0),
    "order 6 bf16": (6, False, "bfloat16", 0),
    "order 4 layered bf16": (4, True, "bfloat16", 0),
    "order 6 layered bf16": (6, True, "bfloat16", 0),
    "order 12 bf16": (12, False, "bfloat16", 0),
    "order 2 t_fuse 6": (2, False, "float32", 6),
    "order 4 t_fuse 5": (4, False, "float32", 5),
    "order 4 t_fuse 6": (4, False, "float32", 6),
    "order 6 t_fuse 3": (6, False, "float32", 3),
    "order 6 t_fuse 4": (6, False, "float32", 4),
    "order 4 layered t_fuse 6": (4, True, "float32", 6),
    "order 6 layered t_fuse 4": (6, True, "float32", 4),
    "order 4 bf16 t_fuse 6": (4, False, "bfloat16", 6),
    "order 6 bf16 t_fuse 4": (6, False, "bfloat16", 4),
    "order 4 layered bf16 t_fuse 6": (4, True, "bfloat16", 6),
    "order 6 layered bf16 t_fuse 4": (6, True, "bfloat16", 4),
}


# name -> (order, 2-D mesh shape or None, layered medium, storage dtype): the
# sharded paths of chip_smoke.py's phase 12
SHARDED = {
    "sharded x4 order 4": (4, None, False, "float32"),
    "sharded 2x2 order 4": (4, (2, 2), False, "float32"),
    "sharded x4 order 4 layered": (4, None, True, "float32"),
    "sharded x4 order 4 bf16": (4, None, False, "bfloat16"),
    "sharded x4 order 8 per-step": (8, None, False, "float32"),
}


def time_sharded(tt, order: int, shape, layered: bool, storage: str, spans: int,
                 eager: bool) -> dict:
    """Median ms/step of a sharded path over `spans` spans through `run`'s
    route (its graphs, where the checkout has them) and, with `eager`,
    through the eager loop; each span's ms/step too."""
    from tpufdtd_torch.harness import media
    from tpufdtd_torch.harness.perf_sharded import timed_span
    from tpufdtd_torch.parallel import ShardedSimulator, make_mesh

    grid = tt.Grid3D(N, N, N, order=order)
    m = media.layered(grid) if layered else np.full(grid.padded_shape, 1.5, np.float32)
    cfg = tt.SimConfig(dt=0.001, nsteps=NSTEPS, warmup_steps=5, storage_dtype=storage)
    src = tt.ricker_table(NSTEPS, 1, cfg.dt)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(shape=shape, devices=[dev] * 4) if shape else make_mesh(devices=[dev] * 4)
    sim = ShardedSimulator(grid, cfg, m, mesh, tt.default_source_coords(1, N, N, N))
    u0 = np.zeros(grid.padded_shape, np.float32)
    state, m_sh, terms = sim.prepare(u0, u0, m)
    w = cfg.warmup_steps
    state = sim.run(state, m_sh, terms, src[:w], w)
    span = getattr(sim, "_span", None)
    out = {"ms_step": [], "eager_ms_step": []}
    for _ in range(spans):
        go = (span(state, m_sh, terms, src[w:], NSTEPS - w) if span is not None
              else lambda st=state: sim.run(st, m_sh, terms, src[w:], NSTEPS - w))
        secs, state = timed_span(sim, go)
        out["ms_step"].append(secs / (NSTEPS - w) * 1e3)
        if eager:
            secs, state = timed_span(sim, sim._eager_span(state, m_sh, terms, src[w:],
                                                          NSTEPS - w))
            out["eager_ms_step"].append(secs / (NSTEPS - w) * 1e3)
    k = sim.sweep.K if isinstance(state, dict) else 0
    return {"K": k, "graphs": None if getattr(sim, "graphs", None) is None else len(sim.graphs),
            "median_ms_step": float(np.median(out["ms_step"])),
            "eager_median_ms_step": float(np.median(out["eager_ms_step"])) if eager else None,
            **out}


def make_sim(tt, n: int, order: int, layered: bool, storage: str, t_fuse: int):
    from tpufdtd_torch.harness import media

    grid = tt.Grid3D(n, n, n, order=order)
    m = media.layered(grid) if layered else np.full(grid.padded_shape, 1.5, np.float32)
    cfg = tt.SimConfig(dt=0.001, nsteps=NSTEPS, warmup_steps=5, storage_dtype=storage,
                       t_fuse=t_fuse)
    sim = tt.Simulator(grid, cfg, m, tt.default_source_coords(1, n, n, n), device="cuda")
    return sim, tt.ricker_table(NSTEPS, 1, cfg.dt)


def eager_span(sim, state, src, t0: int, n: int):
    """A callable that advances `state` n steps through the engine's eager
    loop (engine.run_scan, the loop a Simulator captures), source row t0 + t
    feeding step t, and returns the new state; the rows are copied to the
    card here, outside the call."""
    eng = sim.engine
    table = (torch.as_tensor(np.asarray(src[t0:t0 + n], np.float32), device=sim.device)
             if src is not None and eng.has_sources else None)
    return lambda: eng.run_scan(state, eng.m_args, table, n)


def eager_run(sim, state, src, spans):
    """`state` advanced through the eager loop in spans of the given step
    counts, source row t feeding step t."""
    t = 0
    for n in spans:
        state = eager_span(sim, state, src, t, n)()
        t += n
    return state


def eager_timed(sim, state, src) -> float:
    """Seconds of the post-warmup steps through the engine's eager loop,
    with run_timed's spans and clock."""
    cfg = sim.cfg
    w = min(cfg.warmup_steps, cfg.nsteps)
    state = eager_span(sim, state, src, 0, w)()
    go = eager_span(sim, state, src, w, cfg.nsteps - w)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    go()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def time_path(sim, src, spans: int, eager: bool) -> dict:
    """Median ms/step over `spans` random states through run_timed and, with
    `eager`, through the eager loop; each span's ms/step too."""
    timed = NSTEPS - min(sim.cfg.warmup_steps, NSTEPS)
    out = {"ms_step": [], "eager_ms_step": []}
    for seed in range(spans):
        state = sim.prepare_state_random(seed)
        _, secs = sim.run_timed(state, src)
        del state
        out["ms_step"].append(secs / timed * 1e3)
        if eager:
            state = sim.prepare_state_random(seed)
            out["eager_ms_step"].append(eager_timed(sim, state, src) / timed * 1e3)
            del state
    return {"median_ms_step": float(np.median(out["ms_step"])),
            "eager_median_ms_step": float(np.median(out["eager_ms_step"])) if eager else None,
            **out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--paths", nargs="*", default=None,
                   help="names of PATHS to time (default: all; none with --paths alone)")
    p.add_argument("--ladder", type=int, nargs="*", default=[],
                   help="grid sizes of the order-4 path")
    p.add_argument("--sharded", nargs="*", default=None,
                   help="names of SHARDED paths to time (all without names)")
    p.add_argument("--spans", type=int, default=4)
    p.add_argument("--eager", action="store_true",
                   help="also time the engine's eager loop on the same states")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("span_times times a CUDA card; none is visible")
    import tpufdtd_torch as tt
    from tpufdtd_torch.utils.peaks import smi_line

    card = smi_line()
    names = list(PATHS) if args.paths is None else args.paths
    runs = [(name, N, *PATHS[name]) for name in names]
    runs += [(f"ladder {n}", n, 4, False, "float32", 0) for n in args.ladder]
    for name, n, order, layered, storage, t_fuse in runs:
        sim, src = make_sim(tt, n, order, layered, storage, t_fuse)
        res = time_path(sim, src, args.spans, args.eager)
        print(json.dumps({"path": name, "grid": n, "K": getattr(sim.engine, "sweep_k", 0),
                          **res, "card": card}), flush=True)
        del sim
        torch.cuda.empty_cache()
    for name in (SHARDED if args.sharded == [] else args.sharded or []):
        res = time_sharded(tt, *SHARDED[name], args.spans, args.eager)
        print(json.dumps({"path": name, "grid": N, **res, "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

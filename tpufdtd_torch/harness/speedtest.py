"""Head-to-head speed test, the counterpart of the JAX package's
run_speed_test (the reference's legacy run_speed_test, main.cpp:688-765):
two backends on the same configuration, their times and the speedup."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from ..config import Grid3D, SimConfig
from ..stepper import Simulator
from ..wavelets import default_source_coords, ricker_table


def run_speed_test(sizes: Iterable[int] = (64, 128), timesteps: int = 100,
                   backends: Tuple[str, str] = ("torch", "cuda"), verbose: bool = True, *,
                   device="cuda"):
    """Returns [(size, t_a_seconds, t_b_seconds, speedup_b_over_a), ...];
    times are Simulator.run_timed's (CUDA events on a card, wall time on
    the CPU) over the steps after the warmup, from the same random ICs."""
    out = []
    for gs in sizes:
        grid = Grid3D(gs, gs, gs)
        shape = grid.padded_shape
        m = np.full(shape, 1.5, np.float32)
        src = ricker_table(timesteps, 1, 0.001)
        coords = default_source_coords(1, gs, gs, gs)
        h = grid.halo
        ua = np.zeros(shape, np.float32)
        ua[h:-h, h:-h, h:-h] = np.random.default_rng(0).standard_normal((gs, gs, gs))
        times = []
        for backend in backends:
            cfg = SimConfig(dt=0.001, nsteps=timesteps, backend=backend)
            sim = Simulator(grid, cfg, m, coords, device=device)
            _, secs = sim.run_timed(sim.prepare_state(ua, ua), src)
            times.append(secs)
            del sim
        speedup = times[0] / times[1] if times[1] > 0 else float("inf")
        out.append((gs, times[0], times[1], speedup))
        if verbose:
            print(f"{gs}^3 x {timesteps}: {backends[0]}={times[0] * 1e3:.2f} ms, "
                  f"{backends[1]}={times[1] * 1e3:.2f} ms -> {backends[1]} is {speedup:.2f}x")
    return out

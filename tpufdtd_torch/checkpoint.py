"""Checkpoint and resume, single device and sharded.

The reference keeps its whole state in the host `u` array between kernel
calls and leaves checkpoints to the caller (SURVEY.md §5). Here the state
is the ring of reference-layout levels plus the step counter, saved and
restored as an npz file in the JAX package's format (tpufdtd/checkpoint.py),
key for key and dtype for dtype:

  step      int64 scalar, steps already taken
  u_prev    float32 [nx+2H, ny+2H, nz+2H], u_{step-1}
  u_cur     float32, u_step
  u_target  float32, the exact ring's next write buffer; zeros(0) on the
            fast ring, which has two levels
  grid      int64 [nx, ny, nz, order]
  geom      float64 [hx, hy, hz, ox, oy, oz, dt]

So a checkpoint written by one package resumes in the other. The levels
are saved as `extract_state` returns them, host float32, also in bf16
storage (whose levels widen to f32 exactly). A resumed run reproduces the
unbroken one: the ring carries all the state a leapfrog step needs, and
source rows are consumed by absolute step index. The sharded drivers
gather to the global layout at each checkpoint, so a file from one mesh
resumes on another or on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .config import Grid3D, SimConfig


@dataclasses.dataclass
class Checkpoint:
    step: int  # steps already taken
    u_prev: np.ndarray  # u_{step-1}, reference layout
    u_cur: np.ndarray  # u_step
    u_target: Optional[np.ndarray]  # the exact ring's next write buffer
    grid: Grid3D
    dt: float


def save(path: str, ckpt: Checkpoint) -> None:
    g = ckpt.grid
    np.savez_compressed(
        path,
        step=ckpt.step,
        u_prev=ckpt.u_prev,
        u_cur=ckpt.u_cur,
        u_target=ckpt.u_target if ckpt.u_target is not None else np.zeros(0, np.float32),
        grid=np.array([g.nx, g.ny, g.nz, g.order], dtype=np.int64),
        geom=np.array([g.hx, g.hy, g.hz, g.ox, g.oy, g.oz, ckpt.dt], np.float64),
    )


def load(path: str) -> Checkpoint:
    with np.load(path) as z:
        nx, ny, nz, order = (int(v) for v in z["grid"])
        hx, hy, hz, ox, oy, oz, dt = (float(v) for v in z["geom"])
        ut = z["u_target"]
        return Checkpoint(
            step=int(z["step"]),
            u_prev=z["u_prev"],
            u_cur=z["u_cur"],
            u_target=None if ut.size == 0 else ut,
            grid=Grid3D(nx, ny, nz, hx, hy, hz, ox, oy, oz, order),
            dt=dt,
        )


def _checkpoint_of(sim, levels, step: int) -> Checkpoint:
    return Checkpoint(step=step, u_prev=levels[0], u_cur=levels[1],
                      u_target=levels[2] if len(levels) > 2 else None,
                      grid=sim.grid, dt=sim.cfg.dt)


def _spans(run, state, nsteps: int, src, checkpoint_every, checkpoint):
    """Advance `state` by nsteps in spans of checkpoint_every steps (all at
    once without), calling checkpoint(state, done) between spans; src
    rows are taken by absolute step."""
    done = 0
    span = checkpoint_every or nsteps
    while done < nsteps:
        n = min(span, nsteps - done)
        state = run(state, src[done: done + n] if src is not None else None, n)
        done += n
        if checkpoint_every and done < nsteps:
            checkpoint(state, done)
    return state


def run_with_checkpoints(sim, u_prev: np.ndarray, u_cur: np.ndarray, nsteps: int,
                         src: Optional[np.ndarray] = None,
                         checkpoint_every: Optional[int] = None,
                         path_fmt: str = "ckpt_{step:06d}.npz") -> Tuple[np.ndarray, np.ndarray]:
    """Drive a Simulator in checkpointed spans; returns the final
    (u_prev, u_cur)."""
    state = _spans(
        sim.run, sim.prepare_state(u_prev, u_cur), nsteps, src, checkpoint_every,
        lambda st, done: save(path_fmt.format(step=done),
                              _checkpoint_of(sim, sim.extract_state(st), done)))
    levels = sim.extract_state(state)
    return levels[0], levels[1]


def resume(path: str, cfg: SimConfig, m: np.ndarray, nsteps_total: int,
           src: Optional[np.ndarray] = None, src_coords=None, *,
           device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Resume a checkpointed run to nsteps_total on one device; returns
    (u_prev, u_cur)."""
    from .stepper import Simulator

    ckpt = load(path)
    sim = Simulator(ckpt.grid, cfg, m, src_coords, device=device)
    state = sim.prepare_state(ckpt.u_prev, ckpt.u_cur, ckpt.u_target)
    rest = nsteps_total - ckpt.step
    chunk = src[ckpt.step: ckpt.step + rest] if src is not None else None
    levels = sim.extract_state(sim.run(state, chunk, rest))
    return levels[0], levels[1]


def run_sharded_with_checkpoints(sim, u_prev: np.ndarray, u_cur: np.ndarray, m: np.ndarray,
                                 nsteps: int, src: Optional[np.ndarray] = None,
                                 checkpoint_every: Optional[int] = None,
                                 path_fmt: str = "ckpt_sharded_{step:06d}.npz"
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Drive a ShardedSimulator in checkpointed spans; each checkpoint
    gathers the shards to the global layout (mesh-independent on disk)."""
    state, m_sh, terms = sim.prepare(u_prev, u_cur, m)
    state = _spans(
        lambda st, chunk, n: sim.run(st, m_sh, terms, chunk, n), state, nsteps, src,
        checkpoint_every,
        lambda st, done: save(path_fmt.format(step=done),
                              _checkpoint_of(sim, sim.extract_state(st), done)))
    levels = sim.extract_state(state)
    return levels[0], levels[1]


def resume_sharded(path: str, cfg: SimConfig, m: np.ndarray, mesh, nsteps_total: int,
                   src: Optional[np.ndarray] = None,
                   src_coords=None) -> Tuple[np.ndarray, np.ndarray]:
    """Resume a checkpoint, sharded or single-device, over `mesh`: load the
    global ring, cut it into shards (prepare) and run the remaining steps;
    returns (u_prev, u_cur)."""
    from .parallel import ShardedSimulator

    ckpt = load(path)
    sim = ShardedSimulator(ckpt.grid, cfg, m, mesh, src_coords=src_coords)
    state, m_sh, terms = sim.prepare(ckpt.u_prev, ckpt.u_cur, m, ckpt.u_target)
    rest = nsteps_total - ckpt.step
    chunk = src[ckpt.step: ckpt.step + rest] if src is not None else None
    levels = sim.extract_state(sim.run(state, m_sh, terms, chunk, rest))
    return levels[0], levels[1]

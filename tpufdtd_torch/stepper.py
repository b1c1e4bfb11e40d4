"""Host stepper: the time loop, the two rings and the engines.

Host-facing arrays (ICs, medium, results) are NumPy arrays in the reference
layout [n+2H]^3 (main.cpp:360-363); the engines keep the state on
`device` as torch tensors.

Rings:
  * exact: three levels (P, C, T) = (u_{n-1}, u_n, write target); each step
    writes T's interior and rotates to (C, u_new, P), the dataflow of the
    reference's %3 ring, per-level frozen rims included.
  * fast: two levels U = [u_{n-1}, u_n], advanced K steps per kernel-B
    call, sources added exactly after each block by superposition
    (sources.injection_cubes_upto). Legal when all levels share identical
    rims and no source deposits in a rim; kernel B writes into a second
    buffer, so the state holds U and a spare with the same rims.

Engines:
  * TorchEngine ("torch"): the exact ring on the plain eager step.
  * CudaEngine ("cuda"): the exact ring on kernel A, the fast ring on
    kernel B.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Grid3D, SimConfig
from .ops import stencil_step, stencil_sweep, stencil_torch
from .sources import (
    DeviceSourceTerm,
    build_source_term,
    cubes_fit_core,
    inject,
    injection_cubes_upto,
)

# Fusion depth of the fast ring when SimConfig.t_fuse == 0 (PERF.md).
K_AUTO = 2


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device when there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested, but torch.cuda.is_available() is False"
        )
    return dev


def _rims_identical(arrs, h: int) -> bool:
    def rims(a):
        return (a[:h], a[-h:], a[:, :h], a[:, -h:], a[..., :h], a[..., -h:])

    r0 = rims(arrs[0])
    return all(
        all(np.array_equal(x, y) for x, y in zip(rims(a), r0)) for a in arrs[1:]
    )


class _Engine:
    """The exact 3-level ring; subclasses supply `step`."""

    def __init__(self, grid: Grid3D, cfg: SimConfig, m_ref, coords, device):
        if cfg.storage_dtype != "float32":
            raise NotImplementedError(
                "bfloat16 storage is not ported yet; use storage_dtype='float32'"
            )
        self.grid, self.cfg, self.device = grid, cfg, device
        self.m_ref = np.asarray(m_ref, np.float32)
        self.term = build_source_term(grid, coords, self.m_ref)
        self.dterm = DeviceSourceTerm.of(self.term, device)

    @property
    def has_sources(self) -> bool:
        return not self.term.empty

    def level(self, u_ref) -> torch.Tensor:
        return torch.tensor(np.asarray(u_ref, np.float32), device=self.device)

    def prepare_state(self, u_prev, u_cur, u_target):
        return (self.level(u_prev), self.level(u_cur), self.level(u_target))

    def extract_state(self, state):
        return tuple(x.cpu().numpy() for x in state)

    def run_scan(self, state, src_table, nsteps: int):
        return run_scan(state, src_table, engine=self, nsteps=nsteps)


class TorchEngine(_Engine):
    """Plain eager engine, the counterpart of the JAX package's JnpEngine."""

    def __init__(self, grid, cfg, m_ref, coords, device):
        super().__init__(grid, cfg, m_ref, coords, device)
        self.m = self.level(self.m_ref)

    def step(self, C, P, T):
        return stencil_torch.leapfrog_step(C, P, self.m, T, grid=self.grid, dt=self.cfg.dt)


class CudaEngine(_Engine):
    """Hand-written kernels, the counterpart of the JAX package's
    ZSplitEngine: kernel A on the exact ring, kernel B on the fast ring."""

    def __init__(self, grid, cfg, m_ref, coords, device):
        super().__init__(grid, cfg, m_ref, coords, device)
        uniform = cfg.assume_uniform_m
        if uniform is None:
            uniform = bool(np.all(self.m_ref == self.m_ref.flat[0]))
        self.m_val = float(self.m_ref.flat[0]) if uniform else None
        self.m = None if uniform else self.level(self.m_ref)
        self.sweep_k = 0
        self.cubes = {}
        if cfg.ring != "exact":
            self._init_sweep()

    def _init_sweep(self):
        grid, cfg = self.grid, self.cfg
        if self.m_val is None:
            raise NotImplementedError(
                "a heterogeneous medium on the fused sweep kernel is not ported"
                " yet; use ring='exact'"
            )
        if not stencil_sweep.supported(grid):
            if cfg.ring == "fast":
                raise NotImplementedError(
                    f"the fast ring runs order {2 * stencil_sweep.RADIUS} only;"
                    f" order {grid.order} needs ring='exact' in this port"
                )
            return
        if self.term.touches_rim(grid):
            if cfg.ring == "fast" or cfg.t_fuse:
                raise ValueError(
                    "the fast ring needs sources clear of the rims (a trilinear"
                    " corner lands outside the interior)"
                )
            return
        kmax = stencil_sweep.k_max()
        explicit = cfg.t_fuse > 0
        if explicit and cfg.t_fuse > kmax:
            raise ValueError(f"t_fuse={cfg.t_fuse} exceeds the sweep kernel's depth 1..{kmax}")
        # auto mode degrades K while the correction cubes do not fit the
        # interior (deeper K spreads each deposit R*(K-1)+1 cells); no K >= 2
        # leaves the exact ring
        ks = [cfg.t_fuse] if explicit else range(min(K_AUTO, kmax), 1, -1)
        h = grid.halo
        for k in ks:
            cubes = injection_cubes_upto(grid, self.term, self.m_val, cfg.dt, kmax=k)
            flat = [c for j in cubes for c in cubes[j]]
            if cubes_fit_core(flat, grid.padded_shape, h, h, grid.nz, z0=h):
                self.sweep_k = k
                self.cubes = {
                    j: [(sl, torch.as_tensor(cb, device=self.device), p) for sl, cb, p in cubes[j]]
                    for j in cubes
                }
                return
        if explicit or cfg.ring == "fast":
            raise ValueError(
                "the fast ring at this depth needs sources further inside the"
                f" interior (radius*(K-1)+2 cells; tried K={list(ks)})"
            )

    def step(self, C, P, T):
        m = self.m if self.m is not None else self.m_val
        return stencil_step.leapfrog_step(C, P, m, T, grid=self.grid, dt=self.cfg.dt)

    def prepare_state(self, u_prev, u_cur, u_target):
        if self.sweep_k and _rims_identical([u_prev, u_cur, u_target], self.grid.halo):
            U = torch.stack([self.level(u_prev), self.level(u_cur)])
            return {"sweep": (U, U.clone())}
        if self.cfg.ring == "fast":
            raise ValueError("ring='fast' requires identical rims across all ring levels")
        return super().prepare_state(u_prev, u_cur, u_target)

    def extract_state(self, state):
        if isinstance(state, dict):
            U, _spare = state["sweep"]
            return (U[0].cpu().numpy(), U[1].cpu().numpy())
        return super().extract_state(state)

    def _correct(self, U, s, kk: int):
        """Exact source correction after a kk-step block (level 0 =
        u_{n+kk-1}, level 1 = u_{n+kk}); the algebra is in
        sources.injection_cubes_upto."""
        if kk >= 2:
            inject(U[0], self.dterm, s[kk - 2])
        inject(U[1], self.dterm, s[kk - 1])
        for j in range(2, kk + 1):
            for sl, cube, p in self.cubes[j]:
                U[(1,) + sl] += s[kk - j, p] * cube
                if kk - 1 - j >= 0:
                    U[(0,) + sl] += s[kk - 1 - j, p] * cube

    def run_scan(self, state, src_table, nsteps: int):
        if not isinstance(state, dict):
            return super().run_scan(state, src_table, nsteps)
        U, spare = state["sweep"]
        have_src = src_table is not None and self.has_sources
        done = 0
        while done < nsteps:
            kk = min(self.sweep_k, nsteps - done)
            stencil_sweep.sweep_fused(
                U, spare, grid=self.grid, dt=self.cfg.dt, m_val=self.m_val, k_fuse=kk
            )
            U, spare = spare, U
            if have_src:
                self._correct(U, src_table[done : done + kk], kk)
            done += kk
        return {"sweep": (U, spare)}


def make_engine(grid: Grid3D, cfg: SimConfig, m_ref, coords=None, *, device):
    if cfg.backend == "torch":
        return TorchEngine(grid, cfg, m_ref, coords, device)
    if cfg.backend == "cuda":
        return CudaEngine(grid, cfg, m_ref, coords, device)
    raise ValueError(f"unknown backend {cfg.backend!r}; expected 'torch' or 'cuda'")


@torch.no_grad()
def run_scan(state, src_table, *, engine, nsteps: int):
    """nsteps exact-ring steps; returns the (u_{N-1}, u_N, u_{N-2}) levels."""
    P, C, T = state
    have_src = src_table is not None and engine.has_sources
    for t in range(nsteps):
        un = engine.step(C, P, T)
        if have_src:
            inject(un, engine.dterm, src_table[t])
        P, C, T = C, un, P
    return (P, C, T)


class Simulator:
    """One (grid, config, sources, device) combination.

    Host-facing arrays (ICs, medium, results) use the reference layout
    [n+2H]^3 (main.cpp:360-363); the engine owns the device state.
    `device` is required: a CUDA device that is not there raises.
    """

    def __init__(self, grid: Grid3D, cfg: SimConfig, m: np.ndarray,
                 src_coords: Optional[np.ndarray] = None, *, device):
        self.grid = grid
        self.cfg = cfg
        self.device = resolve_device(device)
        self.engine = make_engine(grid, cfg, m, src_coords, device=self.device)

    def prepare_state(self, u_prev, u_cur, u_target=None):
        """Device state from host ICs; the third level defaults to a copy of
        u_cur, which reproduces both reference IC setups."""
        ut = u_cur if u_target is None else u_target
        return self.engine.prepare_state(np.asarray(u_prev), np.asarray(u_cur), np.asarray(ut))

    def prepare_state_random(self, seed: int, scale: float = 0.1):
        """Random state made on the device, for timing runs (the kernels
        are branch-free over field values). Fast-ring layout when the
        engine has a fast ring, else three levels."""
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=self.device) * scale

        shape = self.grid.padded_shape
        if getattr(self.engine, "sweep_k", 0):
            U = rnd(2, *shape)
            return {"sweep": (U, U.clone())}
        return (rnd(*shape), rnd(*shape), rnd(*shape))

    @staticmethod
    def _leaves(state):
        return state["sweep"][:1] if isinstance(state, dict) else state

    def state_field_stats(self, state) -> Tuple[float, bool]:
        """(max_abs, has_nan) of the state, computed on the device."""
        mx, nan = 0.0, False
        for leaf in self._leaves(state):
            mx = max(mx, float(leaf.abs().max()))
            nan = nan or bool(torch.isnan(leaf).any())
        return mx, nan

    def extract_state(self, state):
        """Host reference-layout arrays: (u_{N-1}, u_N, u_{N-2}) on the
        exact ring, (u_{N-1}, u_N) on the fast ring."""
        return self.engine.extract_state(state)

    def _src_slice(self, src, t0: int, t1: int):
        if src is None or not self.engine.has_sources:
            return None
        return torch.as_tensor(np.asarray(src[t0:t1], np.float32), device=self.device)

    def run(self, state, src: Optional[np.ndarray] = None, nsteps: Optional[int] = None):
        """Advance the state by nsteps (default cfg.nsteps); src row t feeds
        step t of this span."""
        n = self.cfg.nsteps if nsteps is None else nsteps
        if n == 0:
            return state
        return self.engine.run_scan(state, self._src_slice(src, 0, n), n)

    def run_timed(self, state, src: Optional[np.ndarray] = None):
        """The reference timing convention: cfg.warmup_steps untimed steps,
        then the rest timed (cuda.cu:232). Returns (state, seconds, clock):
        on a CUDA device the time is taken with CUDA events around the timed
        span (clock "cuda_event"); elsewhere it is host wall time (clock
        "host"), which is no device time."""
        w = min(self.cfg.warmup_steps, self.cfg.nsteps)
        rest = self.cfg.nsteps - w
        state = self.engine.run_scan(state, self._src_slice(src, 0, w), w)
        main_src = self._src_slice(src, w, self.cfg.nsteps)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(self.device)
            start.record()
            state = self.engine.run_scan(state, main_src, rest)
            end.record()
            torch.cuda.synchronize(self.device)
            return state, start.elapsed_time(end) / 1e3, "cuda_event"
        t0 = time.perf_counter()
        state = self.engine.run_scan(state, main_src, rest)
        return state, time.perf_counter() - t0, "host"


def simulate_ring(u_prev, u_cur, m, grid: Grid3D, cfg: SimConfig, src=None,
                  src_coords=None, u_target=None, *, device):
    """One-shot run on the exact ring; returns host (u_{N-1}, u_N, u_{N-2})."""
    if cfg.ring == "auto":
        cfg = dataclasses.replace(cfg, ring="exact")
    sim = Simulator(grid, cfg, m, src_coords, device=device)
    state = sim.prepare_state(u_prev, u_cur, u_target)
    state = sim.run(state, src, cfg.nsteps)
    return sim.extract_state(state)


def simulate(u_prev, u_cur, m, grid: Grid3D, cfg: SimConfig, src=None,
             src_coords=None, *, device):
    """One-shot run; returns host (u_{N-1}, u_N)."""
    P, C, _ = simulate_ring(u_prev, u_cur, m, grid, cfg, src, src_coords, device=device)
    return P, C

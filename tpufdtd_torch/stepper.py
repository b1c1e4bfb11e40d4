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
    rims and no source deposits in a rim (any face: the JAX package checks
    only the z rim); kernel B writes into a second buffer, so the state
    holds U and a spare with the same rims.

Routing of the "cuda" backend (the JAX package's "pallas" choices):
  * f32, uniform m, orders 2-8: the fast ring. K is K_AUTO[radius],
    degraded while the correction cubes do not fit the interior, down to
    K = 1, which needs no cube (the role of the JAX package's packed_step).
    An explicit t_fuse up to k_max(radius), the JAX package's cap (6 at
    orders 2-4, 4 at order 6, 2 at order 8), must fit its cubes at that
    depth, as in the JAX package, and runs its blocks at that depth.
  * a heterogeneous m (w mode) or bf16 storage at orders 2-6, t_fuse 0 or
    >= 3: the fast ring on kernel B in that mode at K = MODE_K = 2, the
    cubes propagated through the local medium; the JAX package's sweep
    runs these modes at K >= 2 and has no K = 1 form of them, so where
    K = 2 does not fit it takes the exact ring, as here.
  * otherwise the exact ring on kernel A (per-point m at order 8 with a
    heterogeneous medium; bf16 at orders 8-12, or where the fast ring is
    not legal, as the JAX package's JnpEngine).
bf16 levels are stored in bf16 and computed in f32; host-facing arrays stay
f32 both ways.

Engines:
  * TorchEngine ("torch"): the exact ring on the plain eager step.
  * CudaEngine ("cuda"): the exact ring on kernel A, the fast ring on
    kernel B.
"""

from __future__ import annotations

import dataclasses
import functools
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

# Fusion depth of the fast ring per radius when SimConfig.t_fuse == 0: the
# fastest K per step of kernel B's f32 scalar-m mode at 512^3 on an H100
# (harness/tile_probe.py; PERF.md): its deep form at radius 1 and 3, the
# register form at radius 2 (K = 5 about level with K = 2) and 4. The w and
# bf16 modes take MODE_K, their fastest K >= 2 at every radius (the JAX
# package's sweep has no K = 1 form of them).
K_AUTO = {1: 6, 2: 2, 3: 3, 4: 1}
MODE_K = 2


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
        self.grid, self.cfg, self.device = grid, cfg, device
        self.dtype = getattr(torch, cfg.storage_dtype)
        self.m_ref = np.asarray(m_ref, np.float32)
        self.term = build_source_term(grid, coords, self.m_ref)
        self.dterm = DeviceSourceTerm.of(self.term, device)

    @property
    def has_sources(self) -> bool:
        return not self.term.empty

    def field(self, a) -> torch.Tensor:
        """An f32 host array on the device (the medium, w)."""
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def level(self, u_ref) -> torch.Tensor:
        """A host level on the device in the storage dtype."""
        return torch.tensor(np.asarray(u_ref, np.float32)).to(self.dtype).to(self.device)

    def prepare_state(self, u_prev, u_cur, u_target):
        return (self.level(u_prev), self.level(u_cur), self.level(u_target))

    def extract_state(self, state):
        return tuple(x.float().cpu().numpy() for x in state)

    def run_scan(self, state, src_table, nsteps: int):
        return run_scan(state, src_table, engine=self, nsteps=nsteps)


class TorchEngine(_Engine):
    """Plain eager engine, the counterpart of the JAX package's JnpEngine."""

    def __init__(self, grid, cfg, m_ref, coords, device):
        super().__init__(grid, cfg, m_ref, coords, device)
        self.m = self.field(self.m_ref)

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
        self.m = None if uniform else self.field(self.m_ref)
        self.w = None  # kernel B's per-point w stream, when the fast ring has one
        self.sweep_k = 0
        self.cubes = {}
        if cfg.ring != "exact":
            self._init_sweep()
        if not self.sweep_k and cfg.t_fuse >= 3 and self.mode != ("float32", "m"):
            raise ValueError(
                f"t_fuse={cfg.t_fuse} in this mode ({self.mode[0]} storage, medium"
                f" {self.mode[1]!r}) needs the fused sweep: order <= 6, ring 'auto' or"
                " 'fast', and sources inside the interior"
            )

    @property
    def mode(self) -> Tuple[str, str]:
        """Kernel B's mode on the fast ring: (storage dtype, "m" or "w")."""
        return self.cfg.storage_dtype, "m" if self.m_val is not None else "w"

    def _init_sweep(self):
        grid, cfg = self.grid, self.cfg
        R = grid.radius
        plain_mode = self.mode == ("float32", "m")
        if not stencil_sweep.supported(grid):
            if cfg.ring == "fast" and self.dtype == torch.float32:
                raise NotImplementedError(
                    f"the fast ring runs orders 2-8; order {grid.order} needs"
                    " ring='exact'"
                )
            return
        if not plain_mode:
            if R not in stencil_sweep.MODE_RADII:
                # as in the JAX package: radius 4 with a heterogeneous m or
                # bf16 storage takes the exact ring
                if cfg.ring == "fast" and self.dtype == torch.float32:
                    raise NotImplementedError(
                        "the fast ring with a heterogeneous medium runs orders 2-6;"
                        f" order {grid.order} needs ring='exact'"
                    )
                return
            if cfg.t_fuse in (1, 2):
                # the JAX package runs its w and bf16 sweeps at t_fuse 0 or
                # >= 3 only (tpufdtd/stepper.py:172), else the exact ring
                return
        if self.term.touches_rim(grid):
            # bf16 then takes the exact ring, as the JAX package's JnpEngine
            # does whatever the ring asked for
            if cfg.t_fuse or (cfg.ring == "fast" and self.dtype == torch.float32):
                raise ValueError(
                    "the fast ring needs sources clear of the rims (a trilinear"
                    " corner lands outside the interior)"
                )
            return
        kmax = stencil_sweep.k_max(R)
        explicit = cfg.t_fuse > 0
        if explicit and cfg.t_fuse > kmax:
            # the JAX package's cap (tpufdtd/ops/stencil_sweep.py:max_k_fuse)
            raise ValueError(
                f"t_fuse={cfg.t_fuse} is beyond the fused sweep at order {grid.order}: depths"
                f" 1..{kmax} (t_fuse >= 3 needs order <= 6)"
            )
        # auto mode degrades K while the correction cubes do not fit the
        # interior (deeper K spreads each deposit R*(K-1)+1 cells), down to
        # K = 1, which has no cube; the w and bf16 modes stop at K = 2. An
        # explicit t_fuse must fit its cubes at the depth asked for, as in
        # the JAX package, and runs at that depth
        k_auto = K_AUTO[R] if plain_mode else MODE_K
        ks = [cfg.t_fuse] if explicit else range(min(k_auto, kmax), 0 if plain_mode else 1, -1)
        h = grid.halo
        m_core = None if self.m_val is not None else self.m_ref
        for k in ks:
            cubes = injection_cubes_upto(grid, self.term, self.m_val, cfg.dt, kmax=k,
                                         m_core=m_core)
            flat = [c for j in cubes for c in cubes[j]]
            if cubes_fit_core(flat, grid.padded_shape, h, h, grid.nz, z0=h):
                self.sweep_k = k
                self.cubes = {
                    j: [(sl, torch.as_tensor(cb, device=self.device), p) for sl, cb, p in cubes[j]]
                    for j in cubes
                }
                if m_core is not None:
                    self.w = self.field(stencil_sweep.w_stream(grid, cfg.dt, self.m_ref))
                return
        if explicit or (cfg.ring == "fast" and self.dtype == torch.float32):
            raise ValueError(
                "the fast ring at this depth needs sources further inside the"
                f" interior (radius*(K-1)+2 cells; tried K={list(ks)})"
            )

    @property
    def field_reads_per_step(self) -> float:
        """f32 medium fields the kernels read per step, for the byte model
        (utils/metrics.optimized_bytes): the w stream once per K-block call
        on the fast ring, a per-point m every step on the exact ring."""
        if self.sweep_k:
            return 0.0 if self.w is None else 1.0 / self.sweep_k
        return float(self.m is not None)

    def step(self, C, P, T):
        m = self.m if self.m is not None else self.m_val
        return stencil_step.leapfrog_step(C, P, m, T, grid=self.grid, dt=self.cfg.dt)

    def prepare_state(self, u_prev, u_cur, u_target):
        if self.sweep_k and _rims_identical([u_prev, u_cur, u_target], self.grid.halo):
            U = torch.stack([self.level(u_prev), self.level(u_cur)])
            return {"sweep": (U, U.clone())}
        if self.sweep_k and self.dtype == torch.bfloat16:
            raise ValueError(
                "bfloat16 storage on the fast ring needs identical rims across all"
                " ring levels (standard ICs satisfy this); use ring='exact' or"
                " backend='torch' for bf16 with differing rims"
            )
        if self.cfg.ring == "fast":
            raise ValueError("ring='fast' requires identical rims across all ring levels")
        return super().prepare_state(u_prev, u_cur, u_target)

    def extract_state(self, state):
        if isinstance(state, dict):
            U, _spare = state["sweep"]
            return (U[0].float().cpu().numpy(), U[1].float().cpu().numpy())
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
                U[(1,) + sl] += (s[kk - j, p] * cube).to(U.dtype)
                if kk - 1 - j >= 0:
                    U[(0,) + sl] += (s[kk - 1 - j, p] * cube).to(U.dtype)

    def run_scan(self, state, src_table, nsteps: int):
        if not isinstance(state, dict):
            return super().run_scan(state, src_table, nsteps)
        U, spare = state["sweep"]
        have_src = src_table is not None and self.has_sources
        done = 0
        while done < nsteps:
            kk = min(self.sweep_k, nsteps - done)
            stencil_sweep.sweep_fused(
                U, spare, grid=self.grid, dt=self.cfg.dt, m_val=self.m_val, k_fuse=kk,
                w=self.w,
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
    `device` defaults to the card; a CUDA device that is not there raises,
    and device="cpu" runs the plain versions of the kernels.
    """

    def __init__(self, grid: Grid3D, cfg: SimConfig, m: np.ndarray,
                 src_coords: Optional[np.ndarray] = None, *, device="cuda"):
        self.grid = grid
        self.cfg = cfg
        self.device = resolve_device(device)
        self.engine = make_engine(grid, cfg, m, src_coords, device=self.device)
        self.last_clock = None  # run_timed's clock: "cuda_event" or "host"

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
            u = torch.randn(shape, generator=gen, device=self.device) * scale
            return u.to(self.engine.dtype)

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

    @staticmethod
    def _copy(state):
        """A copy of a state on the device, for a timing run that must not
        advance the physics."""
        if isinstance(state, dict):
            return {"sweep": tuple(x.clone() for x in state["sweep"])}
        return tuple(x.clone() for x in state)

    def run_timed(self, state, src: Optional[np.ndarray] = None, timing_repeat: int = 1):
        """The reference timing convention: cfg.warmup_steps untimed steps,
        then the rest timed (cuda.cu:232). Returns (state, seconds), as the
        JAX package's run_timed does; `last_clock` names the clock of the
        last call: "cuda_event" on a CUDA device (events around the timed
        span), else "host" (wall time, no device time).

        timing_repeat = q > 1 times q * rest steps on a throwaway copy of
        the state, the source rows tiled, and returns that time / q; the
        state then advances the real rest steps untimed, so the physics
        does not depend on q."""
        w = min(self.cfg.warmup_steps, self.cfg.nsteps)
        rest = self.cfg.nsteps - w
        q = max(1, int(timing_repeat))
        state = self.engine.run_scan(state, self._src_slice(src, 0, w), w)
        main_src = self._src_slice(src, w, self.cfg.nsteps)
        timed = self._copy(state) if q > 1 else state
        timed_src = main_src if main_src is None or q == 1 else main_src.repeat(q, 1)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(self.device)
            start.record()
            timed = self.engine.run_scan(timed, timed_src, rest * q)
            end.record()
            torch.cuda.synchronize(self.device)
            secs, self.last_clock = start.elapsed_time(end) / 1e3, "cuda_event"
        else:
            t0 = time.perf_counter()
            timed = self.engine.run_scan(timed, timed_src, rest * q)
            secs, self.last_clock = time.perf_counter() - t0, "host"
        if q == 1:
            return timed, secs
        del timed
        return self.engine.run_scan(state, main_src, rest), secs / q


def simulate_ring(u_prev, u_cur, m, grid: Grid3D, cfg: SimConfig, src=None,
                  src_coords=None, u_target=None, *, device="cuda"):
    """One-shot run on the exact ring; returns host (u_{N-1}, u_N, u_{N-2})."""
    if cfg.ring == "auto":
        cfg = dataclasses.replace(cfg, ring="exact")
    sim = Simulator(grid, cfg, m, src_coords, device=device)
    state = sim.prepare_state(u_prev, u_cur, u_target)
    state = sim.run(state, src, cfg.nsteps)
    return sim.extract_state(state)


def simulate(u_prev, u_cur, m, grid: Grid3D, cfg: SimConfig, src=None,
             src_coords=None, *, device="cuda"):
    """One-shot run; returns host (u_{N-1}, u_N)."""
    P, C, _ = simulate_ring(u_prev, u_cur, m, grid, cfg, src, src_coords, device=device)
    return P, C


def get_step_fn(grid: Grid3D, dt: float, backend: str):
    """step(u_cur, u_prev, m, target) -> target with u_{n+1} in its
    interior, for tensors of the padded shape and m a padded f32 tensor or
    a scalar: kernel A on "cuda" (its plain version for CPU tensors), the
    eager step on "torch". The counterpart of the JAX package's
    get_step_fn (its "pallas" and "jnp")."""
    if backend == "cuda":
        return functools.partial(stencil_step.leapfrog_step, grid=grid, dt=dt)
    if backend == "torch":
        return functools.partial(stencil_torch.leapfrog_step, grid=grid, dt=dt)
    raise ValueError(f"unknown backend {backend!r}; expected 'torch' or 'cuda'")

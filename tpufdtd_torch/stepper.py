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
On a CUDA device a level crosses the host boundary through the engine's
`Staging` slots, in chunks, so that host copies overlap the transfers;
elsewhere it is one host copy and one `.to` or `.cpu()`.
An engine's run_scan is the eager time loop, the counterpart of the JAX
package's un-jitted run_scan and _run_sweep. On a CUDA device the "cuda"
backend's Simulator runs that loop as one captured CUDA graph per span (the
counterpart of the JAX package's jitted _run): the loop is captured once
per (ring, nsteps, state buffers, source-table shape) and each later span
on those buffers is one replay (graphs.py, which the sharded engines share).
The "torch" backend and CPU devices stay eager.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from . import graphs
from .config import Grid3D, SimConfig
from .ops import stencil_step, stencil_sweep, stencil_torch
from .sources import (
    DeviceSourceTerm,
    build_source_term,
    cubes_fit_core,
    inject,
    injection_cubes_upto,
)
from .utils import tracing

# Fusion depth of the fast ring per radius when SimConfig.t_fuse == 0: the
# fastest K per step of kernel B's f32 scalar-m mode at 512^3 on an H100
# (harness/tile_probe.py; PERF.md): its deep form at radius 1 and 3, the
# register form at radius 2 (K = 5 about level with K = 2) and 4. The w and
# bf16 modes take MODE_K, their fastest K >= 2 at every radius (the JAX
# package's sweep has no K = 1 form of them).
K_AUTO = {1: 6, 2: 2, 3: 3, 4: 1}
MODE_K = 2

# Host staging of the levels that cross to and from a card (Staging): the
# slots per engine and the bytes of each, one chunk of a level; among the
# fastest both ways for 512^3 f32 levels on an H100, 128 MiB pinned
# (harness/staging_probe.py; PERF.md).
STAGING_SLOTS = 4
STAGING_SLOT_BYTES = 32 << 20


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device when there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested, but torch.cuda.is_available() is False"
        )
    return dev


class Staging:
    """Host staging slots through which levels cross between host f32
    arrays and `device`, one chunk of a slot at a time, so that the host
    copy of a chunk overlaps the transfer of the chunks before it. The slots
    hold the storage dtype (the cast to bf16 and the widening back are host
    copies) and are reused from call to call, round the ring. On a CUDA
    device they are pinned, each transfer is asynchronous on the device's
    current stream (the stream a graph replays on) and each slot's event
    marks the end of its last one: the host waits on it before it touches
    the slot again. Elsewhere the slots are plain and every copy
    synchronous. tracing.counts gets `staged_bytes`, the bytes moved through
    the slots both ways, and `staging_waits`, the times the host found a
    slot's transfer unfinished."""

    def __init__(self, device, dtype: torch.dtype, slots: int = STAGING_SLOTS,
                 slot_bytes: int = STAGING_SLOT_BYTES):
        self.device, self.dtype = torch.device(device), dtype
        cuda = self.device.type == "cuda"
        self.chunk = slot_bytes // dtype.itemsize  # elements of a slot
        self.slots = [torch.empty(self.chunk, dtype=dtype, pin_memory=cuda)
                      for _ in range(slots)]
        self.events = [torch.cuda.Event() if cuda else None for _ in range(slots)]
        self._next = 0  # the slot the next chunk takes

    def _wait(self, i: int) -> None:
        ev = self.events[i]
        if ev is not None and not ev.query():
            tracing.counts["staging_waits"] += 1
            ev.synchronize()

    def _take(self) -> int:
        """The next slot of the ring, once its last transfer has ended."""
        i = self._next
        self._next = (i + 1) % len(self.slots)
        self._wait(i)
        return i

    def _sent(self, i: int) -> None:
        if self.events[i] is not None:
            self.events[i].record(torch.cuda.current_stream(self.device))

    def _chunks(self, numel: int):
        return ((a, min(self.chunk, numel - a)) for a in range(0, numel, self.chunk))

    def to_device(self, src, dst: torch.Tensor) -> None:
        """dst, a contiguous tensor on the device in the slots' dtype, <- the
        host array src of its shape. Returns once every chunk is enqueued,
        when src is no longer read."""
        if tuple(np.shape(src)) != tuple(dst.shape) or dst.dtype != self.dtype:
            raise ValueError(f"a host level of shape {np.shape(src)} into a {self.dtype} level"
                             f" of {tuple(dst.shape)} in {dst.dtype}")
        host = np.ascontiguousarray(src, np.float32)  # src itself where it is one
        with warnings.catch_warnings():  # a read-only src: nothing writes to it
            warnings.filterwarnings("ignore", "The given NumPy array is not writable")
            flat_src = torch.from_numpy(host).view(-1)
        flat_dst = dst.view(-1)
        for a, n in self._chunks(flat_dst.numel()):
            i = self._take()
            slot = self.slots[i][:n]
            slot.copy_(flat_src[a:a + n])
            flat_dst[a:a + n].copy_(slot, non_blocking=True)
            self._sent(i)
        tracing.counts["staged_bytes"] += dst.nbytes

    def to_host(self, src: torch.Tensor) -> np.ndarray:
        """The level src, on the device in the slots' dtype, as a fresh host
        f32 array the caller owns: it views no slot."""
        if src.dtype != self.dtype:
            raise ValueError(f"a {src.dtype} level through {self.dtype} slots")
        out = np.empty(src.shape, np.float32)
        flat_src, flat_out = src.reshape(-1), torch.from_numpy(out).view(-1)
        pending = collections.deque()  # (slot, start, length) of the chunks in flight

        def drain():
            i, a, n = pending.popleft()
            self._wait(i)
            flat_out[a:a + n].copy_(self.slots[i][:n])

        for a, n in self._chunks(flat_src.numel()):
            if len(pending) == len(self.slots):
                drain()
            i = self._take()
            self.slots[i][:n].copy_(flat_src[a:a + n], non_blocking=True)
            self._sent(i)
            pending.append((i, a, n))
        while pending:
            drain()
        tracing.counts["staged_bytes"] += src.nbytes
        return out


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

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    @functools.cached_property
    def staging(self) -> Staging:
        """The card's staging slots, made at the first transfer."""
        return Staging(self.device, self.dtype)

    def load_level(self, u_ref, dst: torch.Tensor) -> None:
        """dst, a level on the card in the storage dtype, <- the host level
        u_ref through the staging slots (`h2d`, the host copies included)."""
        with tracing.span("h2d", dst.nbytes):
            self.staging.to_device(u_ref, dst)

    def level(self, u_ref) -> torch.Tensor:
        """A host level on the device in the storage dtype: on a card through
        the staging slots (load_level); elsewhere a host copy in that dtype
        (`stage`), then its transfer (`h2d`)."""
        if self.on_card:
            dst = torch.empty(np.shape(u_ref), dtype=self.dtype, device=self.device)
            self.load_level(u_ref, dst)
            return dst
        with tracing.span("stage"):
            host = torch.tensor(np.asarray(u_ref, np.float32)).to(self.dtype)
        with tracing.span("h2d", 0):
            return host.to(self.device)

    def to_host(self, x: torch.Tensor) -> np.ndarray:
        """A level as a host f32 array: from a card through the staging
        slots, an array the caller owns (`d2h`, the host copies included);
        elsewhere `.cpu()`."""
        if self.on_card:
            with tracing.span("d2h", x.nbytes):
                return self.staging.to_host(x)
        x = x.float()
        with tracing.span("d2h", 0):
            return x.cpu().numpy()

    def prepare_state(self, u_prev, u_cur, u_target):
        return (self.level(u_prev), self.level(u_cur), self.level(u_target))

    def extract_state(self, state):
        return tuple(self.to_host(x) for x in state)

    @property
    def m_args(self) -> tuple:
        """The medium as the step takes it, the JAX package's m_args:
        (m,), m a padded f32 tensor or a scalar."""
        return (self.m,)

    def run_scan(self, state, m_args, src_table, nsteps: int):
        return run_scan(state, m_args, src_table, engine=self, nsteps=nsteps)


class TorchEngine(_Engine):
    """Plain eager engine, the counterpart of the JAX package's JnpEngine."""

    def __init__(self, grid, cfg, m_ref, coords, device):
        super().__init__(grid, cfg, m_ref, coords, device)
        self.m = self.field(self.m_ref)

    def step(self, C, P, T, m_args):
        return stencil_torch.leapfrog_step(C, P, m_args[0], T, grid=self.grid, dt=self.cfg.dt)


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

    @property
    def m_args(self) -> tuple:
        return (self.m if self.m is not None else self.m_val,)

    def step(self, C, P, T, m_args):
        return stencil_step.leapfrog_step(C, P, m_args[0], T, grid=self.grid, dt=self.cfg.dt)

    def prepare_state(self, u_prev, u_cur, u_target):
        if self.sweep_k:
            with tracing.span("rims"):
                fast = _rims_identical([u_prev, u_cur, u_target], self.grid.halo)
            if fast:
                if self.on_card:
                    # each level straight into its half of U: no level apart from U
                    U = torch.empty((2, *np.shape(u_prev)), dtype=self.dtype, device=self.device)
                    for u, half in zip((u_prev, u_cur), U):
                        self.load_level(u, half)
                    with tracing.span("assemble"):
                        return {"sweep": (U, U.clone())}
                levels = [self.level(u_prev), self.level(u_cur)]
                with tracing.span("assemble"):
                    U = torch.stack(levels)
                    del levels  # the levels go before the spare is allocated: no third copy at the peak
                    return {"sweep": (U, U.clone())}
            if self.dtype == torch.bfloat16:
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
            return (self.to_host(U[0]), self.to_host(U[1]))
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

    def run_scan(self, state, m_args, src_table, nsteps: int):
        """nsteps steps of the state's ring, eagerly; the fast ring's
        medium is the engine's own (m_val or w), so m_args serves the exact
        ring only."""
        if not isinstance(state, dict):
            return super().run_scan(state, m_args, src_table, nsteps)
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
def run_scan(state, m_args, src_table, *, engine, nsteps: int):
    """nsteps exact-ring steps, eagerly; returns the (u_{N-1}, u_N, u_{N-2})
    levels. m_args is the engine's medium (engine.m_args)."""
    P, C, T = state
    have_src = src_table is not None and engine.has_sources
    for t in range(nsteps):
        un = engine.step(C, P, T, m_args)
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

    On a CUDA device the "cuda" backend runs each span as a CUDA graph
    (`graphs`, at most graphs.GRAPH_CACHE of them): the first span on a set of
    state buffers captures the engine's loop, which records and runs
    nothing, and every span replays it. Like the JAX package's donated
    state, the state passed to run or run_timed is advanced in place: use
    the state returned, and do not resize or re-stride its tensors between
    runs (a graph writes to the addresses it was captured on). A capture
    or replay that fails raises; nothing retries eagerly.
    """

    def __init__(self, grid: Grid3D, cfg: SimConfig, m: np.ndarray,
                 src_coords: Optional[np.ndarray] = None, *, device="cuda"):
        self.grid = grid
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.engine = make_engine(grid, cfg, m, src_coords, device=self.device)
        self.last_clock = None  # run_timed's clock: "cuda_event" or "host"
        # key (ring, nsteps, source-table shape, buffers) -> graphs.Graph; None: eager
        self.graphs = (graphs.Graphs(self.device)
                       if self.device.type == "cuda" and cfg.backend == "cuda" else None)

    def prepare_state(self, u_prev, u_cur, u_target=None):
        """Device state from host ICs; the third level defaults to a copy of
        u_cur, which reproduces both reference IC setups. On a card the last
        chunks may still be on their way when it returns, on the device's
        current stream, which `run` replays on; the arrays passed are no
        longer read by then."""
        ut = u_cur if u_target is None else u_target
        with tracing.span("prepare_state"):
            return self.engine.prepare_state(np.asarray(u_prev), np.asarray(u_cur),
                                             np.asarray(ut))

    def state_spec(self):
        """The state prepare_state returns for standard ICs (identical rims),
        as tensors on the "meta" device: {"sweep": (U, spare)} on the fast
        ring, three levels on the exact ring. The JAX package's state_spec."""
        shape = self.grid.padded_shape
        dtype = self.engine.dtype

        def leaf(*s):
            return torch.empty(s, dtype=dtype, device="meta")

        if getattr(self.engine, "sweep_k", 0):
            return {"sweep": (leaf(2, *shape), leaf(2, *shape))}
        return (leaf(*shape), leaf(*shape), leaf(*shape))

    def prepare_state_random(self, seed: int, scale: float = 0.1):
        """Random state made on the device, for timing runs (the kernels
        are branch-free over field values), of state_spec's structure,
        shapes and dtypes; the fast ring's spare is a copy of U."""
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def rnd(like):
            u = torch.randn(like.shape, generator=gen, device=self.device) * scale
            return u.to(like.dtype)

        spec = self.state_spec()
        if isinstance(spec, dict):
            U = rnd(spec["sweep"][0])
            return {"sweep": (U, U.clone())}
        return tuple(rnd(like) for like in spec)

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
        with tracing.span("extract_state"):
            return self.engine.extract_state(state)

    def _src_rows(self, src, t0: int, t1: int):
        """Rows t0..t1 of the source table as a contiguous f32 host array;
        None without sources."""
        if src is None or not self.engine.has_sources:
            return None
        return np.ascontiguousarray(np.asarray(src[t0:t1], np.float32))

    def _span(self, state, rows, n: int):
        """A callable that advances `state` by n steps, source row t (of
        `rows`, None without sources) feeding step t, and returns the new
        state. Everything but the run happens here: the source rows' copy to
        the device and, on the card, the capture."""
        if n == 0:
            return lambda: state
        if self.graphs is None:
            table = None if rows is None else torch.as_tensor(rows, device=self.device)
            return lambda: self.engine.run_scan(state, self.engine.m_args, table, n)
        key = graphs.span_key(isinstance(state, dict), n, rows, state)
        return self.graphs.span(key, state, rows,
                                lambda src: self.engine.run_scan(state, self.engine.m_args, src, n))

    def run(self, state, src: Optional[np.ndarray] = None, nsteps: Optional[int] = None):
        """Advance the state by nsteps (default cfg.nsteps); src row t feeds
        step t of this span."""
        n = self.cfg.nsteps if nsteps is None else nsteps
        with tracing.span("run"):
            return self._span(state, self._src_rows(src, 0, n), n)()

    @staticmethod
    def _copy(state):
        """A copy of a state on the device, for a timing run that must not
        advance the physics."""
        return graphs.copy_state(state)

    def run_timed(self, state, src: Optional[np.ndarray] = None, timing_repeat: int = 1):
        """The reference timing convention: cfg.warmup_steps untimed steps,
        then the rest timed (cuda.cu:232). Returns (state, seconds), as the
        JAX package's run_timed does; `last_clock` names the clock of the
        last call: "cuda_event" on a CUDA device (events around the timed
        span, which holds the span's run alone: its graph is captured and
        its source rows copied before the first event), else "host" (wall
        time, no device time).

        timing_repeat = q > 1 times q * rest steps on a throwaway copy of
        the state, the source rows tiled, and returns that time / q; the
        state then advances the real rest steps untimed, so the physics
        does not depend on q."""
        w = min(self.cfg.warmup_steps, self.cfg.nsteps)
        rest = self.cfg.nsteps - w
        q = max(1, int(timing_repeat))
        state = self._span(state, self._src_rows(src, 0, w), w)()
        main_rows = self._src_rows(src, w, self.cfg.nsteps)
        timed = self._copy(state) if q > 1 else state
        timed_rows = main_rows if main_rows is None or q == 1 else np.tile(main_rows, (q, 1))
        go = self._span(timed, timed_rows, rest * q)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream(self.device)  # the stream the span runs on
            torch.cuda.synchronize(self.device)
            start.record(stream)
            timed = go()
            end.record(stream)
            torch.cuda.synchronize(self.device)
            secs, self.last_clock = start.elapsed_time(end) / 1e3, "cuda_event"
        else:
            t0 = time.perf_counter()
            timed = go()
            secs, self.last_clock = time.perf_counter() - t0, "host"
        if q == 1:
            return timed, secs
        del timed
        return self._span(state, main_rows, rest)(), secs / q


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


def get_step_fn(grid: Grid3D, dt: float, backend: str, layout=None):
    """step(u_cur, u_prev, m, target) -> target with u_{n+1} in its
    interior, for tensors of the padded shape and m a padded f32 tensor or
    a scalar: kernel A on "cuda" (its plain version for CPU tensors), the
    eager step on "torch". The counterpart of the JAX package's
    get_step_fn (its "pallas" and "jnp"). `layout` is None or the
    reference layout of `grid` (Layout.reference), the port's only one."""
    if layout is not None and not (getattr(layout, "is_reference", False)
                                   and tuple(layout.padded_shape) == tuple(grid.padded_shape)):
        raise ValueError(f"layout {layout!r}: the port has only the reference layout"
                         " (Layout.reference(grid), or None)")
    if backend == "cuda":
        return functools.partial(stencil_step.leapfrog_step, grid=grid, dt=dt)
    if backend == "torch":
        return functools.partial(stencil_torch.leapfrog_step, grid=grid, dt=dt)
    raise ValueError(f"unknown backend {backend!r}; expected 'torch' or 'cuda'")

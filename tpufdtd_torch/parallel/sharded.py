"""Sharded FDTD: the grid split along x over a list of devices, one shard each.

Counterpart of tpufdtd/parallel/sharded.py, for the capability the
reference lacks (it skips any grid over one GPU's memory,
main.cpp:337-341). The global x axis is split over `mesh.ndx` shards; each
shard owns [H + nx/ndx + H, nyp, nzp], its x halo slots included. Every
step:

  1. each shard's outermost R interior planes are copied (`copy_`) into
     its neighbours' halo slots, both directions; the edge shards keep
     their frozen global rim (`_exchange`);
  2. each shard runs the single-device leapfrog step on its block, writing
     only the local interior of the target level: kernel A
     (ops/stencil_step.py) on the "cuda" backend, in f32 or bf16 storage
     and with a scalar or per-point m, or the plain eager step on "torch".

Ring and rim semantics are the single-device exact ring's; a source corner
is added by the shard whose interior holds it. When the fast ring is legal
and the sweep is eligible, the fused sharded sweep (sharded_sweep.py) runs
instead, one K-block per exchange; a 2-D mesh runs only that.

Shards may share a device (`make_mesh(devices=["cuda:0"] * 4)`): every
exchange and freeze case then runs on one card, which tests them and gives
no scaling figure. There is one host process; a multi-process
torch.distributed form for hosts with several cards is not here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Grid3D, SimConfig
from ..ops import stencil_step, stencil_torch
from ..sources import DeviceSourceTerm, SourceTerm, build_source_term, inject
from ..stepper import _rims_identical, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """ndx x ndy shards; shard (dx, dy) lives on devices[dx * ndy + dy].
    `two_d`: made with an explicit (ndx, ndy) shape, the JAX package's 2-D
    mesh, which runs the sharded sweep only."""

    ndx: int
    ndy: int
    devices: Tuple[torch.device, ...]
    two_d: bool = False

    @property
    def size(self) -> int:
        return self.ndx * self.ndy

    def device(self, dx: int, dy: int = 0) -> torch.device:
        return self.devices[dx * self.ndy + dy]

    @property
    def cards(self) -> int:
        """Distinct devices the shards use."""
        return len(set(self.devices))


def make_mesh(n_devices: Optional[int] = None, shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh of n_devices shards (default: one per visible card), or a
    2-D (ndx, ndy) mesh when `shape` is given. Without `devices`, shard i
    takes cuda:i, and too few cards raise. An explicit `devices` list, one
    entry per shard, may repeat a device ("cpu" included)."""
    if shape is not None:
        ndx, ndy = (int(v) for v in shape)
        if n_devices is not None and n_devices != ndx * ndy:
            raise ValueError(f"n_devices={n_devices} does not match shape {shape}")
    else:
        if n_devices is None:
            n_devices = len(devices) if devices is not None else (
                torch.cuda.device_count() if torch.cuda.is_available() else 0)
        ndx, ndy = int(n_devices), 1
    n = ndx * ndy
    if n < 1:
        raise RuntimeError("a mesh needs at least one shard; no CUDA card is visible")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"{n} shards need {n} CUDA cards, {have} visible; pass devices= to place"
                " several shards on one device"
            )
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devs = tuple(resolve_device(d) for d in devices)
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for {n} shards")
    return Mesh(ndx, ndy, devs, two_d=shape is not None)


def _local_grid(grid: Grid3D, ndev: int) -> Grid3D:
    if grid.nx % ndev:
        raise ValueError(f"nx={grid.nx} is not a multiple of the {ndev} shards")
    return dataclasses.replace(grid, nx=grid.nx // ndev)


def shards_from_global(grid: Grid3D, ndev: int, arr: np.ndarray) -> np.ndarray:
    """Reference-layout global array [nx+2H, nyp, nzp] -> stacked local
    blocks [ndev*(lnx+2H), nyp, nzp]; each block's halo slots hold the
    neighbour planes or the global rim."""
    h = grid.halo
    lnx = grid.nx // ndev
    return np.concatenate([arr[d * lnx: d * lnx + lnx + 2 * h] for d in range(ndev)], axis=0)


def global_from_shards(grid: Grid3D, ndev: int, stacked: np.ndarray) -> np.ndarray:
    """Inverse of shards_from_global: the halo slots of inner cuts are
    dropped, the global rim comes from the edge shards."""
    h = grid.halo
    lnx = grid.nx // ndev
    lxp = lnx + 2 * h
    parts = [np.asarray(stacked[0:h])]
    for d in range(ndev):
        parts.append(np.asarray(stacked[d * lxp + h: d * lxp + h + lnx]))
    parts.append(np.asarray(stacked[-h:]))
    return np.concatenate(parts, axis=0)


def _pad_terms(terms):
    """Per-shard SourceTerms -> uniform arrays [ndev, n] (ix, iy, iz, scale,
    src_idx); padding corners have scale 0. None when no shard has one."""
    n = max((t.ix.shape[0] for t in terms), default=0)
    if n == 0:
        return None
    out = [np.zeros((len(terms), n), dt) for dt in (np.int32,) * 3 + (np.float32, np.int32)]
    for d, t in enumerate(terms):
        k = t.ix.shape[0]
        for a, v in zip(out, (t.ix, t.iy, t.iz, t.scale, t.src_idx)):
            a[d, :k] = v
    return tuple(out)


class ShardedSimulator:
    """An N-step sharded simulation over `mesh`.

    Host-facing arrays are global reference-layout arrays; `prepare` cuts
    them into shards on their devices and `extract_state` gathers them.
    """

    def __init__(self, grid: Grid3D, cfg: SimConfig, m: np.ndarray, mesh: Mesh,
                 src_coords: Optional[np.ndarray] = None):
        from .sharded_sweep import SweepShard

        self.grid, self.cfg, self.mesh = grid, cfg, mesh
        self.ndev = mesh.size
        self.mesh_2d = mesh.two_d
        self.h, self.R = grid.halo, grid.radius
        self.sweep = SweepShard.try_build(grid, cfg, m, mesh, src_coords)
        if self.mesh_2d:
            # a 2-D mesh runs only the sharded sweep (the per-step engine
            # splits x alone)
            if self.sweep is None:
                raise ValueError(
                    "a 2-D mesh needs the sharded sweep: backend='cuda', order <= 4,"
                    " nx % ndx == 0, ny % ndy == 0, per-shard nx and ny >= K*radius, and"
                    " sources (if any) with their correction cubes inside the global"
                    " interior"
                )
            return
        self.lgrid = _local_grid(grid, self.ndev)
        self.lnx = self.lgrid.nx
        if self.ndev > 1 and self.lnx < self.R:
            raise ValueError(f"{self.lnx} planes per shard; the exchange needs >= {self.R}")
        self.dtype = getattr(torch, cfg.storage_dtype)
        m_np = np.asarray(m, np.float32)
        uniform = cfg.assume_uniform_m
        if uniform is None:
            uniform = bool(np.all(m_np == m_np.flat[0]))
        # kernel A takes a scalar m for a uniform medium; the eager step
        # reads the field, as the single-device TorchEngine does
        self.m_val = float(m_np.flat[0]) if uniform and cfg.backend == "cuda" else None
        h, lnx = self.h, self.lnx
        self.m_slabs = [m_np[d * lnx: d * lnx + lnx + 2 * h] for d in range(self.ndev)]

        # per-shard source terms: the global term's corners, each kept by the
        # shard whose interior holds its x (corners in the one-cell slack
        # beyond the interior by the edge shards), in local coordinates; the
        # weights are the global term's, so a shard cut changes no bit
        term = build_source_term(grid, src_coords, m_np)
        owner = np.clip((term.ix.astype(np.int64) - h) // lnx, 0, self.ndev - 1)
        terms = []
        for d in range(self.ndev):
            keep = owner == d
            terms.append(dataclasses.replace(
                term, ix=(term.ix[keep] - d * lnx).astype(np.int32), iy=term.iy[keep],
                iz=term.iz[keep], scale=term.scale[keep], src_idx=term.src_idx[keep]))
        self.packed_terms = _pad_terms(terms)
        self.nsrc = term.nsrc

    def _step(self, C, P, m, T):
        if self.cfg.backend == "cuda":
            return stencil_step.leapfrog_step(C, P, m, T, grid=self.lgrid, dt=self.cfg.dt)
        return stencil_torch.leapfrog_step(C, P, m, T, grid=self.lgrid, dt=self.cfg.dt)

    def _exchange(self, u):
        """Fill the shards' x halo slots of level u (a list of per-shard
        tensors) with the neighbours' outermost R interior planes."""
        h, R, lnx = self.h, self.R, self.lnx
        for d in range(self.ndev - 1):
            left, right = u[d], u[d + 1]
            right[h - R: h].copy_(left[h + lnx - R: h + lnx])
            left[h + lnx: h + lnx + R].copy_(right[h: h + R])

    # ---- host API ----------------------------------------------------------

    def _shard(self, arr: np.ndarray, dtype) -> list:
        stacked = shards_from_global(self.grid, self.ndev, np.asarray(arr, np.float32))
        lxp = self.lnx + 2 * self.h
        return [torch.tensor(stacked[d * lxp: (d + 1) * lxp]).to(dtype).to(self.mesh.devices[d])
                for d in range(self.ndev)]

    def prepare(self, u_prev, u_cur, m=None, u_target=None):
        """(state, m_shards, terms) from global host levels: the sharded
        sweep's state (a dict) when it is built and the rims of all levels
        are identical, else the per-step engine's three levels. `m` is
        accepted for the JAX package's signature; the medium was given to
        the constructor."""
        up, uc = np.asarray(u_prev), np.asarray(u_cur)
        ut = uc if u_target is None else np.asarray(u_target)
        if self.sweep is not None and _rims_identical([up, uc, ut], self.h):
            return {"sweep": self.sweep.prepare(up, uc)}, None, None
        if self.mesh_2d:
            raise ValueError(
                "the 2-D-mesh sharded sweep needs identical rims across all ring levels"
                " (standard ICs satisfy this); differing rims need the exact ring, which"
                " runs on a 1-D mesh only"
            )
        state = tuple(self._shard(a, self.dtype) for a in (up, uc, ut))
        devs = self.mesh.devices
        if self.m_val is not None:
            m_sh = [self.m_val] * self.ndev
        else:
            m_sh = [torch.tensor(s).to(dv) for s, dv in zip(self.m_slabs, devs)]
        terms = None
        if self.packed_terms is not None:
            # a shard whose corners all carry 0 (the padding) injects nothing
            terms = [DeviceSourceTerm.of(SourceTerm(*(a[d] for a in self.packed_terms),
                                                    nsrc=self.nsrc), dv)
                     if np.any(self.packed_terms[3][d]) else None
                     for d, dv in enumerate(devs)]
        return state, m_sh, terms

    @torch.no_grad()
    def run(self, state, m_sh, terms, src: Optional[np.ndarray], nsteps: int):
        """Advance by nsteps; src row t feeds step t of this span."""
        if isinstance(state, dict):
            return {"sweep": self.sweep.run(state["sweep"], src, nsteps)}
        have_src = src is not None and terms is not None
        tables = {}
        if have_src:
            for dv in set(self.mesh.devices):
                tables[dv] = torch.as_tensor(np.asarray(src[:nsteps], np.float32), device=dv)
        P, C, T = (list(x) for x in state)
        for t in range(nsteps):
            self._exchange(C)
            for d in range(self.ndev):
                un = self._step(C[d], P[d], m_sh[d], T[d])
                if have_src and terms[d] is not None:
                    inject(un, terms[d], tables[self.mesh.devices[d]][t])
            P, C, T = C, T, P
        return tuple(P), tuple(C), tuple(T)

    def synchronize(self) -> None:
        """Wait for every CUDA device of the mesh."""
        for dv in set(self.mesh.devices):
            if dv.type == "cuda":
                torch.cuda.synchronize(dv)

    def extract_state(self, state):
        """Global reference-layout host levels: (u_{N-1}, u_N, u_{N-2}) from
        the per-step engine, (u_{N-1}, u_N) from the sharded sweep."""
        if isinstance(state, dict):
            return self.sweep.extract(state["sweep"])
        return tuple(
            global_from_shards(self.grid, self.ndev,
                               np.concatenate([t.float().cpu().numpy() for t in level]))
            for level in state
        )


def simulate_sharded(u_prev: np.ndarray, u_cur: np.ndarray, m: np.ndarray, grid: Grid3D,
                     cfg: SimConfig, mesh: Mesh, src: Optional[np.ndarray] = None,
                     src_coords: Optional[np.ndarray] = None):
    """One-shot sharded run; returns global (u_{N-1}, u_N, u_{N-2}) from the
    per-step engine, (u_{N-1}, u_N) from the sharded sweep."""
    sim = ShardedSimulator(grid, cfg, m, mesh, src_coords)
    state, m_sh, terms = sim.prepare(u_prev, u_cur, m)
    state = sim.run(state, m_sh, terms, src, cfg.nsteps)
    return sim.extract_state(state)

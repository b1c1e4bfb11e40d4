"""Sharded fused sweep: kernel B per shard, with a deep halo exchanged once
per K-step block, over a 1-D (x) or 2-D (x, y) mesh.

Counterpart of tpufdtd/parallel/sharded_sweep.py:

  * The global x axis is split over the mesh's ndx shards; each shard's
    block is its nx/ndx interior planes extended by M = (K-1)*R planes per
    side, in the reference layout of that extended grid (H pad planes).
  * Once per K-step block, D = K*R planes of both levels go to each
    neighbour (`copy_` between the shards' tensors): a shard's first and
    last D true-interior planes fill the neighbour's R pad planes and M
    margin planes.
  * Each shard runs kernel B on its extended block. A margin value is
    wrong R cells deeper after each stage, but never deeper than M planes,
    so the true interior is exact, and the next exchange overwrites the
    margins.
  * An edge shard's margin overlays the global frozen rim; updating it
    would poison the stages near the true interior, so kernel B freezes it
    (frozen_lo / frozen_hi): (M, 0) on the low edge, (0, M) on the high
    edge, both on a one-shard axis.
  * 2-D mesh: y splits over ndy shards by the same margin calculus with My
    = M rows, and y-edge shards freeze their margin rows (frozen_ylo /
    frozen_yhi). The y exchange runs before the x exchange, so the planes
    sent along x carry refreshed rows: diagonal data arrives in two hops.
  * Sources are exact at any position, a shard cut included: the corner
    deposits and the correction cubes (sources.injection_cubes_upto) are
    flattened on the host into (x, y, z, value, j, p) entries, each given to
    the shard whose true interior holds it, and added after each block by
    one scatter-add (`index_put_(accumulate=True)`) over both levels with
    step rows kk - j (level 1) and kk - 1 - j (level 0): the single-device
    correction's algebra. Each entry's increment is rounded to the level's
    dtype before the scatter-add, as in the JAX package's `correct`; the
    single device adds the corners and then each cube, each add rounded,
    so in bf16 the two round differently (ROADMAP Queue 2 B5).
  * Heterogeneous media: each shard reads its slab of the w stream; the
    slab cut fills the margins from the global medium, and w never changes,
    so it is never exchanged.

M <= H: an edge shard's frozen margin is global rim, which is H deep. So the
depth is capped at K <= H/R + 1 = 3 at orders 2-4.

Exchange/compute overlap (the JAX package's `kern_overlap`,
tpufdtd/parallel/sharded_sweep.py:487-593). The x exchange rewrites the
extended planes [-R, M) and [nxk - M, nxk - M + D), and K stages carry a
value at most D planes, so planes [E, nxk - E) with E = 2D - R of a block's
result do not depend on this block's x exchange. A full block (kk = K)
then runs in three x-slabs, each with an Mb = M plane discard margin:
  * the interior slab, true region [E, nxk - E), computed from the array
    before the x exchange on the compute stream, while the exchange's
    `copy_`s run on a side stream of each device after the y exchange (CUDA
    events order them). Its results read the extended planes [M, nxk - M)
    only, which the exchange does not write; its view also holds pad
    planes beyond those, which the exchange may be rewriting meanwhile, and
    kernel B carries them through without reading them into a result;
  * after the exchange has landed (the compute stream waits on its event),
    the two edge slabs [0, E) and [nxk - E, nxk), with (M, 0) and (0, M)
    frozen margins on the global low and high edge shards.
Kernel B writes its whole slab, discard margins included, so the interior
slab's result in the Mb planes next to each edge slab's true region is
saved before the edge slabs run and put back after. Every true-region value
comes from the same inputs through the same arithmetic as in the serial
order, so the block is bitwise the serial one, sources included. Eligible
as in the JAX package: overlap != "off", more than one x-shard, K >= 2 and
nxk - 2E >= 8. "on" runs it whenever eligible; "auto" runs it where every
shard has a device of its own and keeps the serial order where shards share
a device (ROADMAP Queue 3, "Deliberate: the overlap on one card").
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Grid3D, SimConfig
from ..ops import stencil_sweep
from ..sources import build_source_term, injection_cubes_upto
from ..stepper import K_AUTO, MODE_K

# Deepest block of the sharded sweep: M = (K-1) R <= H at radius 1-2.
K_SHARDED_MAX = 3


def _cubes_fit_global(cubes_by_j, grid: Grid3D) -> bool:
    """Every correction cube lies inside the global interior: a cube in the
    frozen rim would encode an open-grid propagation that is wrong there."""
    h = grid.halo
    n = (grid.nx, grid.ny, grid.nz)
    return all(sl[ax].start >= h and sl[ax].stop <= h + n[ax]
               for lst in cubes_by_j.values() for sl, _cube, _p in lst for ax in range(3))


class SweepShard:
    """The sharded sweep for one (grid, cfg, mesh, sources) combination;
    `try_build` returns None where it is not eligible."""

    @staticmethod
    def try_build(grid: Grid3D, cfg: SimConfig, m_ref: np.ndarray, mesh,
                  src_coords: Optional[np.ndarray]) -> Optional["SweepShard"]:
        if cfg.backend != "cuda" or cfg.t_fuse in (1, 2) or cfg.ring not in ("auto", "fast"):
            return None
        m_np = np.asarray(m_ref, np.float32)
        uniform = cfg.assume_uniform_m
        if uniform is None:
            uniform = bool(np.all(m_np == m_np.flat[0]))
        ndx, ndy = mesh.ndx, mesh.ndy
        if grid.nx % ndx or grid.ny % ndy:
            return None
        nxl, nyl = grid.nx // ndx, grid.ny // ndy
        R, h = grid.radius, grid.halo
        if R > 2:
            return None
        # auto: the single-device depth of the mode (stepper.K_AUTO for f32
        # with a scalar m, MODE_K for the w and bf16 modes); explicit
        # t_fuse >= 3 asks for min(t_fuse, 3); both capped at M <= H
        plain = uniform and cfg.storage_dtype == "float32"
        want = (K_AUTO[R] if plain else MODE_K) if cfg.t_fuse == 0 else cfg.t_fuse
        k_sel = 0
        for k in range(min(want, K_SHARDED_MAX, stencil_sweep.k_max(R)), 1, -1):
            if (k - 1) * R > h or nxl < k * R or (ndy > 1 and nyl < k * R):
                continue
            k_sel = k
            break
        if k_sel < 2:
            return None
        m_val = float(m_np.flat[0]) if uniform else None
        entries = None
        if src_coords is not None and np.asarray(src_coords).size:
            ref_term = build_source_term(grid, src_coords, m_np)
            cubes = injection_cubes_upto(grid, ref_term, m_val, cfg.dt, kmax=k_sel,
                                         m_core=None if uniform else m_np)
            if not _cubes_fit_global(cubes, grid):
                return None
            entries = SweepShard._flatten_entries(ref_term, cubes)
        return SweepShard(grid, cfg, mesh, k_sel, m_val, entries,
                          m_ref=None if uniform else m_np)

    @staticmethod
    def _flatten_entries(ref_term, cubes_by_j):
        """(gx, gy, gz, value, j, p) rows in global padded coordinates: the
        corner deposits as j = 1, each cube cell at its fusion power j."""
        rows = []
        for c in range(ref_term.ix.shape[0]):
            if ref_term.scale[c] != 0:
                rows.append((int(ref_term.ix[c]), int(ref_term.iy[c]), int(ref_term.iz[c]),
                             float(ref_term.scale[c]), 1, int(ref_term.src_idx[c])))
        for j, lst in cubes_by_j.items():
            for sl, cube, p in lst:
                for a, b, c in zip(*np.nonzero(cube)):
                    rows.append((sl[0].start + int(a), sl[1].start + int(b),
                                 sl[2].start + int(c), float(cube[a, b, c]), int(j), int(p)))
        return rows

    def __init__(self, grid: Grid3D, cfg: SimConfig, mesh, K: int, m_val, entries,
                 m_ref=None):
        if cfg.overlap not in ("auto", "on", "off"):
            raise ValueError(f"overlap must be 'auto', 'on' or 'off'; got {cfg.overlap!r}")
        self.grid, self.cfg, self.mesh = grid, cfg, mesh
        self.ndx, self.ndy = mesh.ndx, mesh.ndy
        self.K, self.R, self.h = K, grid.radius, grid.halo
        self.M = (K - 1) * self.R
        self.My = self.M if self.ndy > 1 else 0
        self.nxl, self.nyl = grid.nx // self.ndx, grid.ny // self.ndy
        self.m_val = m_val
        self.dtype = getattr(torch, cfg.storage_dtype)
        self.lgrid = dataclasses.replace(grid, nx=self.nxl + 2 * self.M,
                                         ny=self.nyl + 2 * self.My)
        self.E = 2 * K * self.R - self.R
        self.overlap = (cfg.overlap != "off" and self.ndx > 1 and K >= 2
                        and self.lgrid.nx - 2 * self.E >= 8
                        and (cfg.overlap == "on" or mesh.cards == mesh.size))
        self._side = {}  # per CUDA device: the stream of the overlapped x exchange
        self.w = None
        if m_ref is not None:
            w_ref = stencil_sweep.w_stream(grid, cfg.dt, m_ref)
            self.w = [[torch.tensor(self._local_slab(w_ref, dx, dy), device=mesh.device(dx, dy))
                       for dy in range(self.ndy)] for dx in range(self.ndx)]
        self.entries = self._distribute_entries(entries)

    # ---- host-side data movement ---------------------------------------------

    def _distribute_entries(self, rows):
        """Global entry rows -> per shard {kk: (flat index, value, step row,
        source)} on the shard's device for a kk-step block, None for a shard
        without entries. Each entry adds value * src[row, source] at the flat
        index into [u_{n+kk-1}, u_{n+kk}] (both levels): row kk - j on level 1,
        kk - 1 - j on level 0, where that row exists."""
        if not rows:
            return None
        h, M, My = self.h, self.M, self.My
        per = [[[] for _ in range(self.ndy)] for _ in range(self.ndx)]
        for gx, gy, gz, val, j, p in rows:
            dx = min(max((gx - h) // self.nxl, 0), self.ndx - 1)
            dy = min(max((gy - h) // self.nyl, 0), self.ndy - 1)
            per[dx][dy].append((h + M + gx - h - dx * self.nxl,
                                h + My + gy - h - dy * self.nyl, gz, val, j, p))
        nxp, nyp, nzp = self.lgrid.padded_shape
        out = [[None] * self.ndy for _ in range(self.ndx)]
        for dx in range(self.ndx):
            for dy in range(self.ndy):
                if not per[dx][dy]:
                    continue
                a = np.array(per[dx][dy], np.float64)
                flat = (a[:, 0].astype(np.int64) * nyp + a[:, 1].astype(np.int64)) * nzp \
                    + a[:, 2].astype(np.int64)
                val, j, p = a[:, 3].astype(np.float32), a[:, 4].astype(np.int64), a[:, 5]
                dev = self.mesh.device(dx, dy)
                by_kk = {}
                for kk in range(1, self.K + 1):
                    # level 1: row kk - j; level 0: row kk - 1 - j; where >= 0
                    rows = {lvl: kk - (1 - lvl) - j for lvl in (1, 0)}
                    parts = [(flat[r >= 0] + lvl * nxp * nyp * nzp, val[r >= 0], r[r >= 0],
                              p[r >= 0].astype(np.int64)) for lvl, r in rows.items()]
                    by_kk[kk] = tuple(torch.as_tensor(np.concatenate(col), device=dev)
                                      for col in zip(*parts))
                out[dx][dy] = by_kk
        return out

    def _local_slab(self, arr_ref: np.ndarray, dx: int, dy: int) -> np.ndarray:
        """Global reference array -> one shard's extended block
        [nxl + 2M + 2H, nyl + 2My + 2H, nzp]; cells beyond the global array
        are 0 (no true-interior result reads them)."""
        arr_ref = np.asarray(arr_ref)
        h = self.h
        wx = self.nxl + 2 * self.M + 2 * h
        wy = self.nyl + 2 * self.My + 2 * h
        sx0, sy0 = dx * self.nxl - self.M, dy * self.nyl - self.My
        slab = np.zeros((wx, wy) + arr_ref.shape[2:], arr_ref.dtype)
        lox, hix = max(0, sx0), min(arr_ref.shape[0], sx0 + wx)
        loy, hiy = max(0, sy0), min(arr_ref.shape[1], sy0 + wy)
        slab[lox - sx0: hix - sx0, loy - sy0: hiy - sy0] = arr_ref[lox:hix, loy:hiy]
        return slab

    def prepare(self, u_prev: np.ndarray, u_cur: np.ndarray):
        """Per shard [[(U, spare)]] from global levels with identical rims:
        U = [u_{n-1}, u_n] of the extended block in the storage dtype on the
        shard's device, spare a second buffer with the same rims."""
        out = []
        for dx in range(self.ndx):
            col = []
            for dy in range(self.ndy):
                U = torch.tensor(np.stack([self._local_slab(u_prev, dx, dy),
                                           self._local_slab(u_cur, dx, dy)]), dtype=torch.float32)
                U = U.to(self.dtype).to(self.mesh.device(dx, dy))
                col.append((U, U.clone()))
            out.append(col)
        return out

    def extract(self, states):
        """Per-shard states -> global reference-layout host (u_{N-1}, u_N) in
        f32: each shard's true interior, and the global rims from the edge
        shards."""
        h, M, My, nxl, nyl = self.h, self.M, self.My, self.nxl, self.nyl
        g = self.grid
        outs = [np.zeros(g.padded_shape, np.float32) for _ in range(2)]
        for dx in range(self.ndx):
            for dy in range(self.ndy):
                U = states[dx][dy][0].float().cpu().numpy()
                sx0, sy0 = dx * nxl - M, dy * nyl - My
                x0 = M + h if dx else M
                x1 = M + h + nxl + (0 if dx < self.ndx - 1 else h)
                y0 = My + h if dy else My
                y1 = My + h + nyl + (0 if dy < self.ndy - 1 else h)
                for lvl in range(2):
                    outs[lvl][sx0 + x0: sx0 + x1, sy0 + y0: sy0 + y1] = U[lvl, x0:x1, y0:y1]
        return outs[0], outs[1]

    # ---- one K-block ---------------------------------------------------------

    def _exchange_x(self, Us):
        """D = K R planes each way: a shard's first and last D true-interior
        planes into its neighbours' R pad planes and M margin planes; edge
        shards keep their rim and margin."""
        h, M, R, D = self.h, self.M, self.R, self.K * self.R
        nxk = self.lgrid.nx
        for dy in range(self.ndy):
            for dx in range(self.ndx - 1):
                left, right = Us[dx][dy], Us[dx + 1][dy]
                right[:, h - R: h - R + D].copy_(left[:, h + nxk - M - D: h + nxk - M])
                left[:, h + nxk - M: h + nxk - M + D].copy_(right[:, h + M: h + M + D])

    def _exchange_y(self, Us):
        """The same along y, rows for planes; runs before _exchange_x."""
        if self.ndy == 1:
            return
        h, My, R, D = self.h, self.My, self.R, self.K * self.R
        nyk = self.lgrid.ny
        for dx in range(self.ndx):
            for dy in range(self.ndy - 1):
                lo, hi = Us[dx][dy], Us[dx][dy + 1]
                hi[:, :, h - R: h - R + D].copy_(lo[:, :, h + nyk - My - D: h + nyk - My])
                lo[:, :, h + nyk - My: h + nyk - My + D].copy_(hi[:, :, h + My: h + My + D])

    def frozen(self, dx: int, dy: int) -> tuple:
        """(frozen_lo, frozen_hi, frozen_ylo, frozen_yhi) of shard (dx, dy):
        interior shards freeze nothing, an edge freezes its margin, a
        one-shard x axis both ends (y has no margin then)."""
        M, My = self.M, self.My

        def case(d, n, m):
            if n == 1:
                return (m, m)
            return (m if d == 0 else 0, m if d == n - 1 else 0)

        return case(dx, self.ndx, M) + case(dy, self.ndy, My)

    def _kern(self, U, out, dx: int, dy: int, kk: int, part: str = "all"):
        """Kernel B on shard (dx, dy)'s block ("all"), or on one x-slab of it
        for the overlap (module docstring), in views of U and out: "mid"
        (true region [E, nxk - E)), "lo" ([0, E)) or "hi" ([nxk - E, nxk)),
        each with an M-plane discard margin on its inner sides, where it
        freezes nothing; an outer side keeps the block's frozen margin."""
        h, M, E, nxk = self.h, self.M, self.E, self.lgrid.nx
        a, b = {"all": (0, nxk + 2 * h), "mid": (E - M, nxk - E + M + 2 * h),
                "lo": (0, E + M + 2 * h), "hi": (nxk - E - M, nxk + 2 * h)}[part]
        flo, fhi, fylo, fyhi = self.frozen(dx, dy)
        if part in ("mid", "hi"):
            flo = 0
        if part in ("mid", "lo"):
            fhi = 0
        return stencil_sweep.sweep_fused(
            U[:, a:b], out[:, a:b], grid=dataclasses.replace(self.lgrid, nx=b - a - 2 * h),
            dt=self.cfg.dt, m_val=self.m_val, k_fuse=kk,
            w=None if self.w is None else self.w[dx][dy][a:b], frozen_lo=flo, frozen_hi=fhi,
            frozen_ylo=fylo, frozen_yhi=fyhi,
        )

    def _side_stream(self, dev) -> torch.cuda.Stream:
        if dev not in self._side:
            self._side[dev] = torch.cuda.Stream(device=dev)
        return self._side[dev]

    def _block(self, states, kk: int):
        """One kk-step block of every shard: [u_{n-1}, u_n] in each state's
        U -> [u_{n+kk-1}, u_{n+kk}] in its spare, serially (y exchange, x
        exchange, kernel B per shard) or, for a full block with the overlap
        on, in three slabs with the x exchange under the interior slab."""
        shards = [(dx, dy) for dx in range(self.ndx) for dy in range(self.ndy)]
        Us = [[states[dx][dy][0] for dy in range(self.ndy)] for dx in range(self.ndx)]
        self._exchange_y(Us)
        if not (self.overlap and kk == self.K):
            self._exchange_x(Us)
            for dx, dy in shards:
                self._kern(*states[dx][dy], dx, dy, kk)
            return
        cards = [d for d in dict.fromkeys(self.mesh.devices) if d.type == "cuda"]
        for d in cards:  # the side stream starts after the y exchange
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(d))
            self._side_stream(d).wait_event(ready)
        for dx, dy in shards:
            self._kern(*states[dx][dy], dx, dy, kk, "mid")
        with contextlib.ExitStack() as side:
            for d in cards:
                side.enter_context(torch.cuda.stream(self._side_stream(d)))
            self._exchange_x(Us)
            landed = {}
            for d in cards:
                landed[d] = torch.cuda.Event()
                landed[d].record(self._side_stream(d))
        for d in cards:
            torch.cuda.current_stream(d).wait_event(landed[d])
        h, M, E, nxk = self.h, self.M, self.E, self.lgrid.nx
        bands = (slice(h + E, h + E + M), slice(h + nxk - E - M, h + nxk - E))
        for dx, dy in shards:
            U, spare = states[dx][dy]
            saved = [spare[:, b].clone() for b in bands]
            self._kern(U, spare, dx, dy, kk, "lo")
            self._kern(U, spare, dx, dy, kk, "hi")
            for b, v in zip(bands, saved):
                spare[:, b].copy_(v)

    @staticmethod
    def _correct(U, ent, s_blk):
        """The source correction after a block (the single-device
        CudaEngine._correct's algebra) as one scatter-add of the block's
        entries (`ent`, _distribute_entries' for this block's kk) into both
        levels of U."""
        flat, val, row, src = ent
        vals = (val * s_blk[row, src]).to(U.dtype)
        U.view(-1).index_put_((flat,), vals, accumulate=True)

    @torch.no_grad()
    def run(self, states, src: Optional[np.ndarray], nsteps: int):
        """Advance per-shard states by nsteps in blocks of K (the last block
        shorter); src row t feeds step t of this span."""
        have_src = src is not None and self.entries is not None
        tables = {}
        if have_src:
            for dv in set(self.mesh.devices):
                tables[dv] = torch.as_tensor(np.asarray(src[:nsteps], np.float32), device=dv)
        states = [list(col) for col in states]
        done = 0
        while done < nsteps:
            kk = min(self.K, nsteps - done)
            self._block(states, kk)
            for dx in range(self.ndx):
                for dy in range(self.ndy):
                    U, spare = states[dx][dy]
                    ent = self.entries[dx][dy] if have_src else None
                    if ent is not None:
                        tab = tables[self.mesh.device(dx, dy)]
                        self._correct(spare, ent[kk], tab[done: done + kk])
                    states[dx][dy] = (spare, U)
            done += kk
        return states

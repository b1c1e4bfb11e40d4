"""The plain reference: the acoustic leapfrog of the FDTD reference code in
plain PyTorch, written from its equations and nothing else.

    m * d2u/dt2 = Lap(u) + source,  Lap by central differences of order 2R
    u_{n+1} = 2 u_n - u_{n-1} + dt^2 * Lap(u_n) / m     on the interior
    rims (H = order cells a side) keep each level's initial value

The ring is the reference's three levels (u_{n-1}, u_n, target): each step
writes the target's interior and rotates them, so after N steps the levels
are (u_{N-1}, u_N, u_{N-2}). After step t writes u_{t+1}, row t of the
source table is deposited into it: each source spreads its amplitude over
the 8 cells around its position with trilinear weights, scaled by 1e-2 and
divided by m at the lowest of the 8 cells; a corner counts while it lies at
most one cell outside the interior (the reference's cuda.cu:145-165).

The weights of the second difference come from their closed form, in
float64, and the arithmetic is in the levels' dtype (float32 as the
benchmark hands them). Nothing here imports the program.

`run_slabs` is the same leapfrog over x-slabs, one a device, for a grid no
one card holds: slab d holds the padded x planes [d L, d L + L + 2H) (L =
nx / slabs), its L interior planes with H planes a side, the global rims
on the edge slabs. Before each step every slab's inner side takes the R
planes next to it from its neighbour; each source corner is deposited by
the slab that owns its plane (`owned_planes`), with the weight and the m
value of `deposit`. Each cell goes through the arithmetic of `run`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SOURCE_SCALE = 1.0e-2  # the reference's amplitude prefactor


def fd_weights(order: int) -> list:
    """[w0, w1, .., wR] of the central second difference of order 2R:
    w_d = 2 (-1)^(d+1) (R!)^2 / (d^2 (R-d)! (R+d)!), w0 = -2 sum w_d."""
    R = order // 2
    w = [2.0 * (-1) ** (d + 1) * math.factorial(R) ** 2
         / (d * d * math.factorial(R - d) * math.factorial(R + d)) for d in range(1, R + 1)]
    return [-2.0 * sum(w)] + w


def deposit(coords, n, h: float, halo: int, m) -> tuple:
    """The trilinear deposit of point sources: (flat indices into the padded
    array, f32 weights, source of each corner), corners outside the
    one-cell slack left out. coords [nsrc, 3] physical positions (origin 0),
    n the interior extents, m the padded medium (array) or a scalar."""
    coords = np.asarray(coords, np.float32)
    n = np.asarray(n, np.int64)
    padded = n + 2 * halo
    idx, wts, owner = [], [], []
    for p, c in enumerate(coords):
        rel = c / np.float32(h)
        base = np.floor(rel).astype(np.int64)
        frac = (rel - np.floor(rel)).astype(np.float32)
        mf = np.float32(m) if np.isscalar(m) else np.float32(
            np.asarray(m)[tuple(np.clip(base + halo, 0, padded - 1))])
        for corner in np.ndindex(2, 2, 2):
            cell = base + np.asarray(corner)
            if np.any(cell < -1) or np.any(cell > n):
                continue
            w = np.float32(1.0)
            for ax in range(3):
                w *= frac[ax] if corner[ax] else np.float32(1.0) - frac[ax]
            q = cell + halo
            idx.append(int((q[0] * padded[1] + q[1]) * padded[2] + q[2]))
            wts.append(np.float32(SOURCE_SCALE) * w / mf)
            owner.append(p)
    return (np.asarray(idx, np.int64), np.asarray(wts, np.float32),
            np.asarray(owner, np.int64))


@torch.no_grad()
def run(u_prev, u_cur, m, src, coords, *, order: int, h: float, dt: float, nsteps: int):
    """nsteps steps from the padded levels u_prev, u_cur (tensors on one
    device, left unchanged; the arithmetic is in u_cur's dtype); m a padded
    tensor or a scalar; src the [nsteps, nsrc] table (tensor or
    array), coords [nsrc, 3]. Returns the tensors (u_{N-1}, u_N, u_{N-2})."""
    dev, dtype = u_cur.device, u_cur.dtype
    H, R = order, order // 2
    n = [s - 2 * H for s in u_cur.shape]
    W = fd_weights(order)
    inv_h2 = 1.0 / (h * h)
    interior = tuple(slice(H, H + k) for k in n)

    def shifted(u, axis, d):
        return u[tuple(slice(H + (d if a == axis else 0), H + (d if a == axis else 0) + n[a])
                       for a in range(3))]

    P = u_prev.to(dtype).clone()
    C = u_cur.clone()
    T = C.clone()
    if torch.is_tensor(m):
        coef = (dt * dt) / m[interior].to(dtype)  # dt^2 / m per cell
        m_dep = m.detach().cpu().numpy()
    else:
        coef, m_dep = float(dt * dt / m), float(m)
    idx, wts, owner = deposit(coords, n, h, H, m_dep)
    idx = torch.as_tensor(idx, device=dev)
    wts = torch.as_tensor(wts, device=dev).to(dtype)
    owner = torch.as_tensor(owner, device=dev)
    table = torch.as_tensor(np.asarray(src, np.float32), device=dev).to(dtype)
    lap = torch.empty(n, dtype=dtype, device=dev)
    pair = torch.empty_like(lap)
    for t in range(nsteps):
        torch.mul(C[interior], 3.0 * W[0] * inv_h2, out=lap)
        for axis in range(3):
            for d in range(1, R + 1):
                torch.add(shifted(C, axis, -d), shifted(C, axis, d), out=pair)
                lap.add_(pair, alpha=W[d] * inv_h2)
        lap.mul_(coef)
        lap.add_(C[interior], alpha=2.0)
        lap.sub_(P[interior])
        T[interior] = lap
        if idx.numel():
            T.view(-1).index_add_(0, idx, table[t, owner] * wts)
        P, C, T = C, T, P
    return P, C, T


def slab_planes(nx: int, halo: int, slabs: int) -> list:
    """[(lo, hi)] of the padded x planes each of `slabs` slabs holds: its
    nx / slabs interior planes and `halo` planes a side."""
    if nx % slabs:
        raise ValueError(f"nx={nx} does not divide into {slabs} slabs")
    L = nx // slabs
    return [(d * L, d * L + L + 2 * halo) for d in range(slabs)]


def owned_planes(nx: int, halo: int, slabs: int) -> list:
    """[(lo, hi)] that split the padded x planes [0, nx + 2 halo) among the
    slabs: each slab's interior planes, and the global rims with the edge
    slabs."""
    L = nx // slabs
    return [(0 if d == 0 else halo + d * L, nx + 2 * halo if d == slabs - 1 else halo + d * L + L)
            for d in range(slabs)]


@torch.no_grad()
def run_slabs(u_prev, u_cur, m, src, coords, *, order: int, h: float, dt: float, nsteps: int):
    """`run` over x-slabs (module docstring): u_prev, u_cur lists of slabs
    (slab d the padded planes slab_planes(...)[d], on its own device); they
    become two of the ring's levels and are overwritten. m a scalar or a
    list of slabs of the same planes. Returns the levels (u_{N-1}, u_N,
    u_{N-2}), each a list of slabs; a slab's inner H planes a side are
    work space, its owned planes the result."""
    S, H, R = len(u_cur), order, order // 2
    dtype = u_cur[0].dtype
    L = u_cur[0].shape[0] - 2 * H
    local = [L] + [s - 2 * H for s in u_cur[0].shape[1:]]
    n = [L * S] + local[1:]
    padded = [k + 2 * H for k in n]
    W = fd_weights(order)
    inv_h2 = 1.0 / (h * h)
    interior = tuple(slice(H, H + k) for k in local)
    starts = [lo for lo, _hi in slab_planes(n[0], H, S)]
    owned = owned_planes(n[0], H, S)

    def shifted(u, axis, d):
        return u[tuple(slice(H + (d if a == axis else 0), H + (d if a == axis else 0) + local[a])
                       for a in range(3))]

    def owner(x):
        return next(d for d, (lo, hi) in enumerate(owned) if lo <= x < hi)

    P = [p.to(dtype) for p in u_prev]
    C = list(u_cur)
    T = [c.clone() for c in C]
    if isinstance(m, (list, tuple)):
        coef = [(dt * dt) / md[interior].to(dtype) for md in m]
    else:
        coef = [float(dt * dt / m)] * S
    # each source's deposit, with m at its lowest corner's cell as `deposit` reads it
    per = [([], [], []) for _ in range(S)]  # per slab: local flat index, weight, source
    for p, c in enumerate(np.asarray(coords, np.float32).reshape(-1, 3)):
        if isinstance(m, (list, tuple)):
            base = np.clip(np.floor(c / np.float32(h)).astype(np.int64) + H, 0,
                           np.asarray(padded) - 1)
            d = owner(int(base[0]))
            m_p = float(m[d][int(base[0]) - starts[d], int(base[1]), int(base[2])])
        else:
            m_p = float(m)
        idx, wts, _ = deposit(c[None], n, h, H, m_p)
        for q, w in zip(zip(*np.unravel_index(idx, padded)), wts):
            d = owner(int(q[0]))
            per[d][0].append(((int(q[0]) - starts[d]) * padded[1] + int(q[1])) * padded[2]
                             + int(q[2]))
            per[d][1].append(w)
            per[d][2].append(p)
    terms = [None if not f else (torch.as_tensor(np.asarray(f, np.int64), device=C[d].device),
                                 torch.as_tensor(np.asarray(w, np.float32),
                                                 device=C[d].device).to(dtype),
                                 torch.as_tensor(np.asarray(o, np.int64), device=C[d].device))
             for d, (f, w, o) in enumerate(per)]
    table = np.asarray(src, np.float32)
    tables = [torch.as_tensor(table, device=c.device).to(dtype) for c in C]
    lap = [torch.empty(local, dtype=dtype, device=c.device) for c in C]
    pair = [torch.empty_like(x) for x in lap]
    for t in range(nsteps):
        for d in range(S - 1):  # the inner sides' R planes from the neighbours
            C[d + 1][H - R: H].copy_(C[d][H + L - R: H + L])
            C[d][H + L: H + L + R].copy_(C[d + 1][H: H + R])
        for d in range(S):
            torch.mul(C[d][interior], 3.0 * W[0] * inv_h2, out=lap[d])
            for axis in range(3):
                for k in range(1, R + 1):
                    torch.add(shifted(C[d], axis, -k), shifted(C[d], axis, k), out=pair[d])
                    lap[d].add_(pair[d], alpha=W[k] * inv_h2)
            lap[d].mul_(coef[d])
            lap[d].add_(C[d][interior], alpha=2.0)
            lap[d].sub_(P[d][interior])
            T[d][interior] = lap[d]
            if terms[d] is not None:
                idx, wts, src_of = terms[d]
                T[d].view(-1).index_add_(0, idx, tables[d][t, src_of] * wts)
        P, C, T = C, T, P
    return P, C, T

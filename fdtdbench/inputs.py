"""The shots' inputs, made from the run's seed: source positions, each
shot's wavelets, the pool of initial wavefields and the medium.

Every draw comes from numpy's Generator seeded with (seed, stream, index),
so the same seed gives the same inputs whatever else the run does; the
large arrays are made on the device from a few drawn numbers. A slab of
them, the padded x planes [lo, hi) (`planes`), draws the same numbers and
equals the whole array's planes bit for bit, so a grid over several cards
is made one slab a card.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent

# streams of the seed
MEDIUM, IC, SHOT, WARMUP, CHECK = range(5)


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), stream, index])


def load(path: Path):
    """The module in the file `path` (a medium, an initial field, a metric)."""
    spec = importlib.util.spec_from_file_location(f"fdtdbench_{path.parent.name}_{path.stem}",
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lattice_coords(nsrc: int, n, h: float) -> np.ndarray:
    """Source positions of the reference's driver (main.cpp:303-325): the
    lattice {1/4, 1/2, 3/4} of L = (n - 1) h per axis, x outermost, then
    the domain's centre for sources past the 27 lattice points."""
    ticks = [[np.float32(f) * np.float32((k - 1) * h) for f in (0.25, 0.5, 0.75)] for k in n]
    points = [(x, y, z) for x in ticks[0] for y in ticks[1] for z in ticks[2]]
    centre = tuple(np.float32(0.5 * (k - 1) * h) for k in n)
    return np.asarray([points[p] if p < len(points) else centre for p in range(nsrc)],
                      np.float32).reshape(nsrc, 3)


def wavelets(traffic: dict, dt: float, r: np.random.Generator) -> np.ndarray:
    """A shot's [steps, nsrc] f32 source table: for each source the
    reference's Ricker (1 - 2a) exp(-a), a = (pi f0 (t - t_p))^2 (main.cpp:
    290-300), with its own amplitude drawn from `amp` and its peak t_p from
    `peak_at` (fractions of the shot)."""
    w, steps, nsrc = traffic["wavelet"], traffic["steps"], traffic["sources"]
    amp = r.uniform(*w["amp"], nsrc)
    peak = r.uniform(*w["peak_at"], nsrc) * steps * dt
    t = np.arange(steps, dtype=np.float64)[:, None] * dt
    a = (np.pi * w["f0"] * (t - peak[None, :])) ** 2
    return (amp[None, :] * (1.0 - 2.0 * a) * np.exp(-a)).astype(np.float32)


def medium(config: dict, seed: int, device, pkg: Path = PKG, planes=None):
    """The configuration's medium: a float (uniform) or a padded f32 tensor
    on `device`, the whole array or its padded x planes `planes` = (lo,
    hi), from <pkg>/media/<kind>.py."""
    spec = config["medium"]
    gen = load(pkg / "media" / f"{spec['kind']}.py")
    return gen.make(_n(config), config["order"], spec, rng(seed, MEDIUM), device, planes)


def initial_fields(config: dict, traffic: dict, seed: int, j: int, device, pkg: Path = PKG,
                   planes=None):
    """Pool entry j of the traffic's initial wavefields: padded f32 tensors
    (u_prev, u_cur) on `device`, the whole arrays or their padded x planes
    `planes` = (lo, hi), from <pkg>/ics/<kind>.py."""
    spec = traffic["ic"]
    gen = load(pkg / "ics" / f"{spec['kind']}.py")
    return gen.make(_n(config), config["order"], spec, rng(seed, IC, j), device, planes)


def _n(config: dict) -> tuple:
    return config["nx"], config["ny"], config["nz"]

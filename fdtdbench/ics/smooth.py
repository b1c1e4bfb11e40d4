"""A smooth random wavefield with zero rims, as a checkpoint an imaging code
restarts from: u_cur is `terms` products of sines along x, y and z, each
axis with a random period in `periods` (cells) and a random phase, the
products weighted by random amplitudes in +-[0.5, 1] and the sum divided by
the sum of their sizes, times an envelope sin(pi (i + 1/2) / n) per axis,
times `amp`. u_prev = u_cur - `prev_offset` * v, v a second such field, so
the two levels differ and the field moves from the first step. The rims
(`halo` cells a side) are zero in both.

With `planes` = (lo, hi) only the padded x planes [lo, hi) are made: every
number is drawn and every axis's sines are taken whole as for the whole
array, and only the 3-D products are cut to the slab, so the slab equals
the whole array's planes [lo, hi) bit for bit."""

import math

import torch


def _field(n, halo, params, rng, device, planes=None):
    lo, hi = planes or (0, n[0] + 2 * halo)
    out = torch.zeros([hi - lo] + [k + 2 * halo for k in n[1:]], dtype=torch.float32,
                      device=device)
    a = min(max(lo, halo), halo + n[0])  # the interior planes the slab holds: [a, b)
    b = max(min(hi, halo + n[0]), a)
    core = out[(slice(a - lo, b - lo),) + tuple(slice(halo, halo + k) for k in n[1:])]
    xs = slice(a - halo, b - halo)
    axes = [torch.arange(k, dtype=torch.float64, device=device) + 0.5 for k in n]
    lo_p, hi_p = params["periods"]
    amps = rng.uniform(0.5, 1.0, int(params["terms"])) * rng.choice([-1.0, 1.0],
                                                                     int(params["terms"]))
    for amp in amps:
        s = [torch.sin(2.0 * math.pi * c / rng.uniform(lo_p, hi_p)
                       + rng.uniform(0.0, 2.0 * math.pi)) for c in axes]
        core += ((float(amp) * s[0][xs, None] * s[1][None, :]).to(torch.float32)[:, :, None]
                 * s[2].to(torch.float32)[None, None, :])
    env = [torch.sin(math.pi * c / k) for c, k in zip(axes, n)]
    core *= ((env[0][xs, None] * env[1][None, :]).to(torch.float32)[:, :, None]
             * env[2].to(torch.float32)[None, None, :])
    core *= float(params["amp"] / abs(amps).sum())
    return out


def make(n, halo, params, rng, device, planes=None):
    u_cur = _field(n, halo, params, rng, device, planes)
    v = _field(n, halo, params, rng, device, planes)
    return u_cur - float(params["prev_offset"]) * v, u_cur

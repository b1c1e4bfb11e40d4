"""A smooth random wavefield with zero rims, as a checkpoint an imaging code
restarts from: u_cur is `terms` products of sines along x, y and z, each
axis with a random period in `periods` (cells) and a random phase, the
products weighted by random amplitudes in +-[0.5, 1] and the sum divided by
the sum of their sizes, times an envelope sin(pi (i + 1/2) / n) per axis,
times `amp`. u_prev = u_cur - `prev_offset` * v, v a second such field, so
the two levels differ and the field moves from the first step. The rims
(`halo` cells a side) are zero in both."""

import math

import torch


def _field(n, halo, params, rng, device):
    out = torch.zeros([k + 2 * halo for k in n], dtype=torch.float32, device=device)
    core = out[tuple(slice(halo, halo + k) for k in n)]
    axes = [torch.arange(k, dtype=torch.float64, device=device) + 0.5 for k in n]
    lo, hi = params["periods"]
    amps = rng.uniform(0.5, 1.0, int(params["terms"])) * rng.choice([-1.0, 1.0],
                                                                     int(params["terms"]))
    for a in amps:
        s = [torch.sin(2.0 * math.pi * c / rng.uniform(lo, hi) + rng.uniform(0.0, 2.0 * math.pi))
             for c in axes]
        core += ((float(a) * s[0][:, None] * s[1][None, :]).to(torch.float32)[:, :, None]
                 * s[2].to(torch.float32)[None, None, :])
    env = [torch.sin(math.pi * c / k) for c, k in zip(axes, n)]
    core *= ((env[0][:, None] * env[1][None, :]).to(torch.float32)[:, :, None]
             * env[2].to(torch.float32)[None, None, :])
    core *= float(params["amp"] / abs(amps).sum())
    return out


def make(n, halo, params, rng, device):
    u_cur = _field(n, halo, params, rng, device)
    v = _field(n, halo, params, rng, device)
    return u_cur - float(params["prev_offset"]) * v, u_cur

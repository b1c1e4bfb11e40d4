"""A seeded layered stand-in for a seismic velocity model, in m = 1/c^2:
five layers along x whose interfaces dip across y, scaled by a small smooth
perturbation, made on the device. The recipe of the port's
`harness/media.layered`, rewritten in torch: m of each layer `layer_m`,
interfaces at the fractions `interfaces` of nx at y = 0, deepening by
`dip` * nx across y, and m scaled by 1 + `perturb` * p, p a sum of `terms`
products of sines along x, y and z (1-3 periods across the grid, random
phases and amplitudes) divided by the sum of the amplitudes, so |p| <= 1.

With `planes` = (lo, hi) only the padded x planes [lo, hi) are made, from
the same draws and the same whole axes, equal bit for bit to the whole
array's planes [lo, hi).
"""

import math

import torch


def make(n, halo, params, rng, device, planes=None):
    nx, ny, nz = n
    f64 = torch.float64
    lo, hi = planes or (0, nx + 2 * halo)

    def centres(k):  # cell centres along an axis of the padded grid, interior units
        return torch.arange(k + 2 * halo, dtype=f64, device=device) - halo + 0.5

    x, y, z = centres(nx), centres(ny) / ny, centres(nz) / nz
    depth = x[lo:hi, None] - params["dip"] * nx * y[None, :]
    layer = sum((depth >= f * nx).to(torch.int64) for f in params["interfaces"])
    m2d = torch.as_tensor(params["layer_m"], dtype=f64, device=device)[layer]

    terms = int(params["terms"])
    amps = rng.uniform(0.5, 1.0, terms)
    p = torch.zeros((hi - lo, ny + 2 * halo, nz + 2 * halo), dtype=torch.float32,
                    device=device)
    for a in amps:
        fx, fy, fz = rng.integers(1, 4, 3)
        px, py, pz = rng.uniform(0.0, 2.0 * math.pi, 3)
        sx = torch.sin(2.0 * math.pi * float(fx) * x / nx + px)
        sy = torch.sin(2.0 * math.pi * float(fy) * y + py)
        sz = torch.sin(2.0 * math.pi * float(fz) * z + pz)
        p += (a * sx[lo:hi, None] * sy[None, :]).to(torch.float32)[:, :, None] * sz.to(
            torch.float32)[None, None, :]
    p *= float(params["perturb"] / amps.sum())
    p += 1.0
    p *= m2d.to(torch.float32)[:, :, None]
    return p

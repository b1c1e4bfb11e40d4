"""Sources and correction layer (sources.py, CudaEngine._correct, inject):
the device milliseconds per step of the kernels that run inside the
replays of the traced shots and are neither stencil kernels nor copies or
memsets: the source injection and the fast ring's correction. Prints the
five largest of them by name."""

import sys

from fdtdbench.metrics.stencil_device_ms_per_step import is_stencil
from fdtdbench.trace import is_copy, short_name


def read(r):
    if not r.device or not r.traced_steps:
        return None
    by_name = {}
    for n, a, b in r.in_spans("run"):
        if not is_stencil(n) and not is_copy(n):
            key = short_name(n)
            count, us = by_name.get(key, (0, 0.0))
            by_name[key] = (count + 1, us + b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    print("fdtdbench: source and correction kernels: "
          + "; ".join(f"{n[:60]} x{c} {us * 1e-3:.3f} ms" for n, (c, us) in top), file=sys.stderr)
    return sum(us for _c, us in by_name.values()) * 1e-3 / r.traced_steps

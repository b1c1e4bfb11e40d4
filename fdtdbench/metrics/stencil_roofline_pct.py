"""Kernels layer: the stencil kernels' share of their roofline, in percent.
The numerator is the least time of the stencil work of the traced shots,
counted from the cell's shapes and steps whatever implements it: the larger
of the operations (cells x steps x flops_per_point(order)) over the f32
peak and the bytes (each level a shot took in and put out, and the medium,
each once) over the HBM peak. The denominator is the stencil
kernels' device time. None for a card whose peaks are not on record."""

import sys

from fdtdbench import roofline
from fdtdbench.metrics.stencil_device_ms_per_step import stencil_us


def read(r):
    us, count = stencil_us(r)
    least = roofline.least_seconds(r.device_kind, cells=r.cells, steps=r.traced_steps,
                                   shots=len(r.traced_shots), levels=r.traced_levels,
                                   order=r.order,
                                   elem_bytes=r.elem_bytes, medium_bytes=r.medium_bytes)
    if not count or least is None:
        return None
    print(f"fdtdbench: stencil roofline: least {least[0]!r} s, bound by {least[1]}, against"
          f" {us * 1e-6!r} s of stencil kernels", file=sys.stderr)
    return 100.0 * least[0] / (us * 1e-6)

"""Kernels layer, the exact ring: kernel A's share of its roofline, in
percent. The numerator is the least time of the traced shots' stencil work
(fdtdbench/roofline.least_seconds): the larger of the operations, cells x
steps x flops_per_point(order), over the f32 peak, and the bytes of the
levels the shots took in and put out (three each way on the exact ring)
and the per-point medium, each once, over the HBM peak. The denominator is
kernel A's device time. None for a card whose peaks are not on record, or
without kernel A in the trace."""

import sys

from fdtdbench import roofline
from fdtdbench.metrics.exact_stencil_device_ms_per_step import kernel_a_us


def read(r):
    us, count = kernel_a_us(r)
    least = roofline.least_seconds(r.device_kind, cells=r.cells, steps=r.traced_steps,
                                   shots=len(r.traced_shots), levels=r.traced_levels,
                                   order=r.order, elem_bytes=r.elem_bytes,
                                   medium_bytes=r.medium_bytes)
    if not count or least is None:
        return None
    print(f"fdtdbench: kernel A roofline: least {least[0]!r} s, bound by {least[1]}, against"
          f" {us * 1e-6!r} s of kernel A", file=sys.stderr)
    return 100.0 * least[0] / (us * 1e-6)

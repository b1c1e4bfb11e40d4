"""Kernels layer, the exact ring (ops/stencil_step.py, csrc/stencil_step.cuh):
the device milliseconds per step of kernel A (step::leapfrog_xsweep) in the
trace of the traced shots, matched by name as CUPTI gives it. Prints the
intervals it matched beside the stencil launches the program counted over
the same shots."""

import sys

KERNEL_A = "leapfrog_xsweep"


def kernel_a_us(r):
    """(microseconds, intervals) of kernel A in the trace."""
    hits = [b - a for n, a, b in r.device if KERNEL_A in n]
    return sum(hits), len(hits)


def read(r):
    us, count = kernel_a_us(r)
    if not count or not r.traced_steps:
        return None
    print(f"fdtdbench: kernel A: {count} intervals in the trace of {len(r.traced_shots)} shots"
          f" of {r.traced_steps} steps, {r.launches} stencil launches counted", file=sys.stderr)
    return us * 1e-3 / r.traced_steps

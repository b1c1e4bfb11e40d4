"""Kernels layer (ops/stencil_sweep.py, ops/stencil_step.py, csrc/): the
device milliseconds per step of the stencil kernels in the trace of the
traced shots. The stencil kernels are the port's hand-written ones, matched
by name as CUPTI gives it, demangled or not: kernel A
(step::leapfrog_xsweep), kernel B (sweep::kernel) and kernel B's deep form
(sweep_deep::kernel). Prints the intervals it matched beside the launches
the program counted over the same shots."""

import sys

STENCIL = ("leapfrog_xsweep", "sweep::kernel<", "5sweep6kernel", "sweep_deep::kernel<",
           "10sweep_deep6kernel")


def is_stencil(name: str) -> bool:
    return any(s in name for s in STENCIL)


def stencil_us(r):
    """(microseconds, intervals) of the stencil kernels in the trace."""
    hits = [b - a for n, a, b in r.device if is_stencil(n)]
    return sum(hits), len(hits)


def read(r):
    us, count = stencil_us(r)
    if not count or not r.traced_steps:
        return None
    print(f"fdtdbench: stencil kernels: {count} intervals in the trace of"
          f" {len(r.traced_shots)} shots, {r.launches} launches counted", file=sys.stderr)
    return us * 1e-3 / r.traced_steps

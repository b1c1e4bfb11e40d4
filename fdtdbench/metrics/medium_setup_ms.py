"""Set-up layer (stepper._Engine.medium): the host milliseconds the engine
took to scan the medium for uniformity and place a per-point medium on the
device, over the process (tracing.counts' medium_ns; set-up is not
profiled, so the program counts it on the host clock whether or not a
profiler runs). Prints the bytes placed (medium_bytes). None for a program
that does not count them."""

import sys

from fdtdbench import program


def read(r):
    t = program.tracing()
    if t is None or "medium_ns" not in t.counts:
        return None
    print(f"fdtdbench: medium: {t.counts['medium_bytes']} bytes placed on the device in"
          f" {t.counts['medium_ns']} ns", file=sys.stderr)
    return t.counts["medium_ns"] * 1e-6

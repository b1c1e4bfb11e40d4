"""Graphs layer (graphs.py, capture): the graphs the program captured
before the window, that is in set-up (tracing.counts' captures, the
process's total, less the window shots that captured one). Prints the
window's captures and the process's evictions. None off the card."""

import sys

from fdtdbench import program


def read(r):
    t = program.tracing()
    if t is None or all(s.nodes is None for s in r.shots):
        return None
    c = t.counts
    window = sum(1 for s in r.shots if s.capture_s)
    print(f"fdtdbench: graph captures in the window {window}, evictions in the process"
          f" {c['evictions']}", file=sys.stderr)
    return c["captures"] - window

"""Host API layer (the card's staging slots, stepper.Staging): the times the
host came back to a slot whose transfer had not ended, per GB moved through
the slots, over the process (tracing.counts' staging_waits over its
staged_bytes). Near the chunks a GB (1e9 over a slot's bytes) the
transfers set the pace of a level's crossing, near 0 the host copies.
Prints both counts. None where nothing went through slots: off the card, or
a program without them."""

import sys

from fdtdbench import program


def read(r):
    t = program.tracing()
    if t is None or not t.counts.get("staged_bytes"):
        return None
    c = t.counts
    print(f"fdtdbench: staged {c['staged_bytes']} bytes in the process, {c['staging_waits']}"
          " waits", file=sys.stderr)
    return c["staging_waits"] / (c["staged_bytes"] / 1e9)

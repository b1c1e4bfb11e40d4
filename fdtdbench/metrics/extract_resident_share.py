"""Host API layer (the host arrays stepper.Resident makes ahead of
extract_state on a card): the share of the levels extract_state took from a
card that went into an array made ahead and ready, over the process
(tracing.counts' resident_levels over resident_levels, resident_waits and
fresh_levels). Near 1 the copies out of the staging slots land on resident
pages; a level waited for or made fresh faults its pages in on the shot's
path. Prints the three counts. None where no level was counted: off the
card, or a program without them."""

import sys

from fdtdbench import program

COUNTS = ("resident_levels", "resident_waits", "fresh_levels")


def read(r):
    t = program.tracing()
    if t is None:
        return None
    c = {k: t.counts.get(k, 0) for k in COUNTS}
    if not sum(c.values()):
        return None
    print("fdtdbench: extracted levels in the process: " +
          ", ".join(f"{v} {k}" for k, v in c.items()), file=sys.stderr)
    return c["resident_levels"] / sum(c.values())

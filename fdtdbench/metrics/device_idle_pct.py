"""Device layer (the card): the share of the traced shots' wall time in
which the device ran nothing, in percent: 100 (1 - the union of the device
intervals over the traced window)."""

from fdtdbench.trace import busy_us


def read(r):
    busy, win = busy_us(r), r.window_us
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / (win[1] - win[0]))

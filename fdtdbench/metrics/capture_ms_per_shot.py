"""Graphs layer (graphs.py, capture): the capture seconds (Graph.seconds,
the program's own clock) of every graph that first appeared during the
window, in milliseconds per window shot; 0 when every shot replayed a graph
captured in set-up. None off the card, where nothing is captured."""


def read(r):
    if not r.shots or all(s.nodes is None for s in r.shots):
        return None
    return 1e3 * sum(s.capture_s for s in r.shots) / len(r.shots)

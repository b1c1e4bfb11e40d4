"""Graphs layer (graphs.py, replay): the nodes of the graph each window
shot replayed (Graph.nodes, the program's count), over the steps it
covers."""


def read(r):
    shots = [s for s in r.shots if s.nodes is not None]
    return sum(s.nodes for s in shots) / sum(s.graph_steps for s in shots) if shots else None

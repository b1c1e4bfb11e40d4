"""Captured CUDA graphs of an engine's eager loop, one per span.

The counterpart of the JAX package's compiled time loops (the single
device's jitted `_run`, the sharded engines' `shard_map` programs): on a
card, a span of an engine's loop is recorded once per key (the engine, the
step count, the source table's shape, the state's buffers and what else
the loop reads) and replayed for every later span with that key. Both
`stepper.Simulator` and `parallel.ShardedSimulator` keep their spans here
(`Graphs`, one card each).

A state is a tensor, or a dict, tuple or list of states: the single
device's (P, C, T) and {"sweep": (U, spare)}, the sharded per-step
engine's three tuples of per-shard levels, the sharded sweep's
{"sweep": [[(U, spare) per y-shard] per x-shard]}. A loop advances its
state in place and returns it with its buffers in new roles (the exact
ring rotates, the fast ring swaps U and spare each block); a replay returns
the same buffers in the roles recorded at capture.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Tuple

import torch

from .ops import _build, stencil_step, stencil_sweep
from .utils import tracing

GRAPH_CACHE = 8  # captured spans a simulator keeps; the least recently used goes first


def counters() -> tuple:
    """The kernels' launch counters, in a fixed order."""
    return (stencil_step.counts["kernel"], stencil_step.counts["plain"],
            stencil_sweep.counts["kernel"], stencil_sweep.counts["plain"],
            stencil_sweep.frozen_counts)


@contextlib.contextmanager
def counts_kept():
    """Launches counted inside the block are taken back on leaving it;
    yields the counts as they were on entry, in `counters()`'s order."""
    saved = [collections.Counter(c) for c in counters()]
    try:
        yield saved
    finally:
        for c, s in zip(counters(), saved):
            c.clear()
            c.update(s)


def graph_nodes(graph) -> Tuple[int, int]:
    """(nodes, kernel nodes) of a capture's recorded graph (kept with
    keep_graph), read through the CUDA driver's cuGraphGetNodes and
    cuGraphNodeGetType."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]

    def check(rc):
        if rc:
            raise RuntimeError(f"reading a captured graph's nodes: CUDA driver error {rc}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    if n.value:
        check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return n.value, kernels


def state_of(like, leaf: Callable):
    """`like`'s structure (dicts, tuples and lists) with each leaf x
    replaced by leaf(x)."""
    if isinstance(like, dict):
        return {k: state_of(v, leaf) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(state_of(v, leaf) for v in like)
    return leaf(like)


def buffers(state) -> tuple:
    """Every leaf of a state (its tensors), in order."""
    out = []
    state_of(state, out.append)
    return tuple(out)


def copy_state(state):
    """A copy of a state on its devices, for a run that must not advance
    the physics."""
    return state_of(state, torch.Tensor.clone)


def roles(state, out):
    """`out`'s structure with each buffer replaced by its index in
    buffers(state): the roles a loop from `state` left its buffers in."""
    ptrs = [b.data_ptr() for b in buffers(state)]

    def role(b):
        if b.data_ptr() not in ptrs:
            raise RuntimeError("the captured span returned a buffer that is not the state's")
        return ptrs.index(b.data_ptr())

    return state_of(out, role)


def _described(state) -> tuple:
    """Each leaf of `state`: a tensor as its address, device, dtype, shape
    and strides, anything else (a scalar, None) as itself."""
    return tuple((b.data_ptr(), str(b.device), b.dtype, tuple(b.shape), b.stride())
                 if torch.is_tensor(b) else b for b in buffers(state))


def span_key(kind, n: int, rows, state, reads=None) -> tuple:
    """A span's key: the engine (`kind`), its step count, its source
    table's shape (None without sources), the state's buffers and, where
    given, `reads`: what else the loop reads that the graph records (a
    medium's tensors or scalar, source terms), in any state structure."""
    key = (kind, n, None if rows is None else rows.shape, _described(state))
    return key if reads is None else key + (_described(reads),)


@contextlib.contextmanager
def recording(graph, stream):
    """torch.cuda.graph(graph, stream=stream) without its emptying of the
    caching allocator: that handed the blocks of the state a caller had just
    dropped back to the card, so the next state got new addresses, whose
    span was captured again, shot after shot. As torch.cuda.graph does, it
    waits for the card, then records on `stream` into a private pool."""
    torch.cuda.synchronize(stream.device)
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            yield
        finally:
            graph.capture_end()


class Graph:
    """One span of an eager loop, captured as a CUDA graph.

    The graph holds the addresses of the state buffers it was captured on,
    the loop's constants (cubes, w, m, source indices) and its own source
    table `src` ([nsteps, nsrc] f32 on the card, or None), which `load`
    fills before a replay. `roles` is the output state's structure with
    each buffer's index in the input's buffers. `deltas` are the launches
    of one replay per counter of `counters()`: the wrappers count when they
    are called, which is at capture, so a replay adds them. `nodes` and
    `kernels` count the recorded graph's nodes and its kernel nodes."""

    def __init__(self, graph, device, src, roles, deltas, nodes: int, kernels: int,
                 seconds: float):
        self.graph, self.device, self.src, self.roles = graph, device, src, roles
        self.deltas, self.nodes, self.kernels = deltas, nodes, kernels
        self.seconds = seconds  # the capture's wall time, instantiation included

    def load(self, rows) -> None:
        if self.src is not None:
            with tracing.span("load"):
                self.src.copy_(torch.from_numpy(rows))

    def launch(self, state):
        # replay() launches on the current device's stream
        with tracing.span("replay"), torch.cuda.device(self.device):
            self.graph.replay()
        for counter, delta in zip(counters(), self.deltas):
            counter.update(delta)
        bufs = buffers(state)
        return state_of(self.roles, bufs.__getitem__)


class Graphs(collections.OrderedDict):
    """key -> Graph: the GRAPH_CACHE most recently used spans of a
    simulator on one card, each captured on a stream of that card (not
    torch.cuda.graph's shared default stream, which lives on whichever card
    was current at its first use). Its captures and the spans it drops past
    GRAPH_CACHE go to utils.tracing.counts (`captures`, `evictions`)."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self._stream = None  # made at the first capture

    def span(self, key, state, rows, enqueue: Callable):
        """A callable that replays the span `key` on `state` and returns the
        new state; the span is captured on first use of the key. `enqueue(src)`
        is the eager loop over `state`, reading source row t of the device
        table `src` (None when `rows` is None) at step t; `rows` fill `src`
        here, before the callable is returned."""
        with torch.cuda.device(self.device):
            graph = self.pop(key, None)
            if graph is None:
                graph = self._capture(state, rows, enqueue)
                tracing.counts["captures"] += 1
            self[key] = graph
            while len(self) > GRAPH_CACHE:
                self.popitem(last=False)
                tracing.counts["evictions"] += 1
            graph.load(rows)
        return lambda: graph.launch(state)

    def _capture(self, state, rows, enqueue: Callable) -> Graph:
        """Record enqueue on `state`'s buffers. The capture runs nothing and
        counts no launch; a failed capture raises and keeps nothing."""
        bufs = buffers(state)
        if any(b.device != self.device for b in bufs):
            raise ValueError(f"a captured span needs every state buffer on {self.device}; got"
                             f" {[str(b.device) for b in bufs]}")
        _build.library()  # nvcc and the library's load stay outside the capture
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with tracing.span("capture"):  # instantiation included
            src = None if rows is None else torch.empty(rows.shape, dtype=torch.float32,
                                                        device=self.device)
            # keep_graph: the recorded graph stays readable (raw_cuda_graph), to
            # check its nodes against the launches counted at capture
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            with counts_kept() as before:  # the capture launched nothing
                with torch.no_grad(), recording(graph, self._stream):
                    out = enqueue(src)
                deltas = [c - b for c, b in zip(counters(), before)]
            nodes, kernels = graph_nodes(graph)
            launched = sum(deltas[0].values()) + sum(deltas[2].values())
            plain = sum(deltas[1].values()) + sum(deltas[3].values())
            if not nodes or kernels < launched or plain:
                raise RuntimeError(
                    f"the captured span recorded {nodes} nodes, {kernels} of them kernels, for"
                    f" {launched} kernel launches and {plain} plain steps counted at capture")
            graph.instantiate()
            return Graph(graph, self.device, src, roles(state, out), deltas, nodes, kernels,
                         time.perf_counter() - t0)

"""The program's own spans and counters, for the readers of fdtdbench/metrics/.

tpufdtd_torch.utils.tracing keeps them: `counts` (the process's graph
captures and evictions) and `record`, each span the program opened while a
profiler ran, as (name, start_ns, end_ns, nbytes) on the program's host
clock (time.perf_counter_ns), nbytes being what a transfer span moved. The
harness profiles the first shots of the window and nothing else, so the
record holds the traced shots' spans and their bytes. A program without
them gives None here, and the readers report nothing.

The record is put on the profiler's clock shot by shot. Each of the program's
top-level spans (prepare_state, run, extract_state) opens a few microseconds
after the benchmark's own range around the same call (fdtdbench.prepare, .run,
.extract), so profiler time = host time + an offset of at least (benchmark
start - program start) for each pair; the largest of the three is taken,
which puts the program's spans early by the shortest of those few
microseconds.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from fdtdbench import trace

PREFIX = "tpufdtd_torch"  # the program's ranges: tpufdtd_torch.<span>
TOP = {"prepare_state": "prepare", "run": "run", "extract_state": "extract"}

Span = Tuple[str, int, float, float, int]  # name, window shot, start us, end us, bytes


def tracing():
    """The program's tracing module where it keeps spans and counters, else None."""
    from tpufdtd_torch.utils import tracing as t

    return t if hasattr(t, "record") and hasattr(t, "counts") else None


def spans(r: trace.Readings) -> Optional[List[Span]]:
    """The program's spans of the traced shots on the profiler's clock, or
    None without a record of one prepare_state per traced shot."""
    t = tracing()
    if t is None or not r.traced_shots:
        return None
    rec = sorted(t.record, key=lambda s: (s[1], -s[2]))
    starts = [s[1] for s in rec if s[0] == "prepare_state"]
    if len(starts) != len(r.traced_shots):
        return None
    bench = {(kind, i): a for kind, i, a, _b in r.spans}
    out = []
    for k, i in enumerate(r.traced_shots):
        end = starts[k + 1] if k + 1 < len(starts) else float("inf")
        shot = [s for s in rec if starts[k] <= s[1] < end]
        offs = [bench[(TOP[n], i)] - a / 1e3 for n, a, _b, _n in shot
                if n in TOP and (TOP[n], i) in bench]
        if not offs:
            return None
        off = max(offs)
        out += [(n, i, a / 1e3 + off, b / 1e3 + off, nb) for n, a, b, nb in shot]
    return out


def self_us(spans_: List[Span]) -> dict:
    """{span name: microseconds} of self time, each span's duration less
    its direct children's (the program's spans nest, on one thread)."""
    out: dict = {}
    stack: list = []  # open spans: [name, end, duration, children's duration]

    def close(name, _end, dur, children):
        out[name] = out.get(name, 0.0) + dur - children

    for n, _i, a, b, _nb in sorted(spans_, key=lambda s: (s[2], -s[3])):
        while stack and stack[-1][1] <= a:
            close(*stack.pop())
        if stack:
            stack[-1][3] += b - a
        stack.append([n, b, b - a, 0.0])
    while stack:
        close(*stack.pop())
    return out


def innermost(spans_: List[Span], t: float) -> Optional[str]:
    """The name of the shortest program span that holds time t."""
    held = [s for s in spans_ if s[2] <= t < s[3]]
    return min(held, key=lambda s: s[3] - s[2])[0] if held else None


def idle_gaps(r: trace.Readings, spans_: List[Span], captured: set, top: int = 10) -> list:
    """The `top` longest idle gaps of the traced window, as trace.breakdown
    gives them, each named by the benchmark's span and the innermost
    program span that holds its middle: [(name, seconds)]."""
    win = r.window_us
    if win is None:
        return []
    busy = trace.union([(a, b) for _n, a, b in r.device], *win)
    edges = [win[0]] + [x for iv in busy for x in iv] + [win[1]]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            name = trace._label(r, mid, captured)
            inner = innermost(spans_, mid)
            gaps.append((name if inner is None else f"{name} / {PREFIX}.{inner}", (b - a) * 1e-6))
    return sorted(gaps, key=lambda g: -g[1])[:top]


def copy_gb_per_s(r: trace.Readings, span: str, copy: str, counted: str) -> Optional[float]:
    """GB/s of the program's transfers: the bytes its `counted` spans moved
    over the traced shots, over the device time of the `copy` intervals
    ("Memcpy HtoD", "Memcpy DtoH") that start inside its `span` spans."""
    sp = spans(r)
    if sp is None:
        return None
    moved = sum(nb for n, _i, _a, _b, nb in sp if n == counted)
    frames = [(a, b) for n, _i, a, b, _nb in sp if n == span]
    us = sum(b - a for n, a, b in r.device
             if n.startswith(copy) and any(s <= a < e for s, e in frames))
    return moved / (us * 1e-6) / 1e9 if moved and us else None

"""What a traced run reads, and the arithmetic the per-layer metrics share.

The traced run profiles whole shots of the window with torch.profiler, in
memory, and keeps from it two lists on the profiler's clock (microseconds):
the device's intervals (kernels, copies, memsets), each with the card it
ran on, and the benchmark's own host spans around each call into the
program. `Readings` carries them,
with the window's per-shot records and the cell's shapes, to the readers in
fdtdbench/metrics/.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

SPAN = "fdtdbench"  # prefix of the benchmark's record_function ranges: fdtdbench.<kind>.<shot>


@dataclasses.dataclass
class Shot:
    """One shot of the window. `capture_s` sums Graph.seconds of the graphs
    that first appeared in it; `nodes` and `graph_steps` are those of the
    graph it replayed (None off the card); the seconds of the host API's
    spans are read in a traced run only (None otherwise), each ending in a
    synchronize."""

    steps: int
    seconds: float
    levels: int = 2  # levels extract_state returned, as many as prepare_state took up
    capture_s: float = 0.0
    nodes: Optional[int] = None
    graph_steps: Optional[int] = None
    prepare_s: Optional[float] = None
    extract_s: Optional[float] = None
    run_s: Optional[float] = None


@dataclasses.dataclass
class Readings:
    """What the readers of fdtdbench/metrics/ read."""

    shots: List[Shot]
    cells: int  # interior cells of the grid
    order: int
    elem_bytes: int  # bytes of a stored level's element
    medium_bytes: int  # bytes a cell of the medium takes (0 for a uniform medium)
    device_kind: str
    traced_shots: List[int] = dataclasses.field(default_factory=list)  # window indices
    device: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    spans: List[Tuple[str, int, float, float]] = dataclasses.field(default_factory=list)
    launches: Optional[int] = None  # stencil launches counted over the traced shots
    # the card (device index) of each interval of `device`, in its order
    cards: List[int] = dataclasses.field(default_factory=list)

    @property
    def traced_steps(self) -> int:
        return sum(self.shots[i].steps for i in self.traced_shots)

    @property
    def traced_levels(self) -> int:
        """Levels the traced shots moved between host and card, each way."""
        return sum(self.shots[i].levels for i in self.traced_shots)

    @property
    def window_us(self) -> Optional[Tuple[float, float]]:
        """The traced shots' extent on the profiler's clock."""
        shots = [(a, b) for kind, _i, a, b in self.spans if kind == "shot"]
        if not shots:
            return None
        return min(a for a, _ in shots), max(b for _, b in shots)

    def in_spans(self, kind: str):
        """The device intervals that start inside a host span of `kind`."""
        spans = [(a, b) for k, _i, a, b in self.spans if k == kind]
        return [(n, a, b) for n, a, b in self.device if any(s <= a < e for s, e in spans)]


def is_copy(name: str) -> bool:
    """A copy or memset as CUPTI names them ("Memcpy HtoD (Pageable -> Device)")."""
    return name.startswith(("Memcpy", "Memset"))


def union(intervals, lo: float = float("-inf"), hi: float = float("inf")) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals (the arithmetic of the port's
    utils/tracing.device_busy_us)."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_us(readings: Readings, card: Optional[int] = None) -> Optional[float]:
    """Microseconds of the traced window in which the device ran anything:
    any card, or the card `card` alone (None where it ran nothing)."""
    win = readings.window_us
    device = readings.device if card is None else [
        iv for iv, c in zip(readings.device, readings.cards) if c == card]
    if win is None or not device:
        return None
    return sum(b - a for a, b in union([(a, b) for _n, a, b in device], *win))


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 96 characters."""
    return re.sub(r"\(.*", "", name)[:96]


def breakdown(readings: Readings, captured: set) -> dict:
    """The ten device operations that took most time, by name, and the ten
    longest idle gaps of the traced window, each named by the host span
    its middle falls in ("capture+replay" for the run of a shot that
    captured); seconds as measured."""
    by_name: dict = {}
    for n, a, b in readings.device:
        key = short_name(n)
        by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    win = readings.window_us
    gaps = []
    if win is not None:
        busy = union([(a, b) for _n, a, b in readings.device], *win)
        edges = [win[0]] + [x for iv in busy for x in iv] + [win[1]]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps.append((_label(readings, (a + b) / 2, captured), (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [list(x) for x in ops], "idle_gaps": [list(x) for x in gaps[:10]]}


def _label(readings: Readings, t: float, captured: set) -> str:
    for kind, i, a, b in readings.spans:
        if kind != "shot" and a <= t < b:
            if kind == "run" and i in captured:
                return f"capture+replay (shot {i})"
            return f"{'replay' if kind == 'run' else kind} (shot {i})"
    return "between shots"


def from_profiler(prof) -> tuple:
    """(device intervals, host spans, the card of each device interval) of
    a torch.profiler run."""
    import torch

    device, spans, cards = [], [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN + "."):
            # a record_function range shows on the device's timeline too
            # (a user annotation), which is no device work
            if e.device_type == torch.autograd.DeviceType.CUDA:
                continue
            _, kind, shot = e.name.split(".")
            spans.append((kind, int(shot), a, b))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((e.name, a, b))
            cards.append(e.device_index)
    return device, spans, cards

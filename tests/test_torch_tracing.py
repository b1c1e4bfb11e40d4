"""The program's spans and counters (tpufdtd_torch.utils.tracing) on the CPU:
the ranges a shot opens under torch.profiler and how they nest, their count
whatever the step count, the bytes recorded, and the graph cache's counts
with its capture stubbed."""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpufdtd_torch as tt
from tpufdtd_torch import graphs
from tpufdtd_torch.utils import tracing

# the program span each span of a shot opens inside (None: at the top)
PARENT = {"prepare_state": None, "rims": "prepare_state", "stage": "prepare_state",
          "h2d": "prepare_state", "assemble": "prepare_state", "run": None,
          "extract_state": None, "d2h": "extract_state"}


def _sim(ring: str, nsteps: int):
    g = tt.Grid3D(12, 16, 20, hx=1.0, hy=1.0, hz=1.0)
    m = np.full(g.padded_shape, 1.5, np.float32)
    cfg = tt.SimConfig(dt=0.001, nsteps=nsteps, backend="cuda", ring=ring)
    coords = np.array([[6.0, 8.0, 10.0]], np.float32)
    return tt.Simulator(g, cfg, m, coords, device="cpu"), tt.ricker_table(nsteps, 1, cfg.dt)


def _levels(sim):
    rng = np.random.default_rng(0)
    u = rng.standard_normal(sim.grid.padded_shape).astype(np.float32)
    u[2:-2, 2:-2, 2:-2] = 0.0
    return u, u.copy()


def _shot(sim, src):
    up, uc = _levels(sim)
    state = sim.prepare_state(up, uc)
    return sim.extract_state(sim.run(state, src))


def _traced_shot(ring: str, nsteps: int):
    """The program's ranges of one traced shot: [(span, enclosing span)]."""
    sim, src = _sim(ring, nsteps)
    tracing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _shot(sim, src)
    out = []
    for e in prof.events():
        if not e.name.startswith(tracing.PREFIX + "."):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith(tracing.PREFIX + "."):
            up = up.cpu_parent
        out.append((e.name.split(".", 1)[1], None if up is None else up.name.split(".", 1)[1]))
    return sim, out


@pytest.mark.parametrize("ring, levels", [("auto", 2), ("exact", 3)])
def test_a_shot_opens_the_host_api_spans_nested(ring, levels):
    sim, ranges = _traced_shot(ring, 4)
    fast = ring == "auto"
    assert bool(sim.engine.sweep_k) == fast
    want = Counter({"prepare_state": 1, "stage": levels, "h2d": levels, "run": 1,
                    "extract_state": 1, "d2h": levels})
    if fast:
        want.update({"rims": 1, "assemble": 1})
    assert Counter(name for name, _ in ranges) == want
    for name, parent in ranges:
        assert parent == PARENT[name], name
    # the record holds the same spans, each with its interval on one clock
    assert Counter(r[0] for r in tracing.record) == want
    assert all(t0 <= t1 for _n, t0, t1, _b in tracing.record)


def test_a_shot_opens_as_many_ranges_at_4_and_40_steps():
    counts = [Counter(name for name, _ in _traced_shot("auto", n)[1]) for n in (4, 40)]
    assert counts[0] == counts[1]
    assert sum(counts[0].values()) == 11


@pytest.mark.parametrize("ring, levels", [("auto", 2), ("exact", 3)])
def test_bytes_counted_on_the_cpu(ring, levels):
    """The transfers record their bytes with their spans: none on a CPU
    device. Without a profiler nothing is recorded and nothing counted."""
    sim, src = _sim(ring, 4)
    tracing.reset_counts()
    out = _shot(sim, src)
    assert len(out) == levels and tracing.record == [] and not tracing.counts
    with profile(activities=[ProfilerActivity.CPU]):
        _shot(sim, src)
    moved = [(n, nb) for n, _a, _b, nb in tracing.record if n in ("h2d", "d2h")]
    assert sorted(moved) == sorted([("h2d", 0), ("d2h", 0)] * levels)
    assert all(nb == 0 for *_x, nb in tracing.record) and not tracing.counts


class _Replay:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_graph_cache_counts_captures_replays_and_evictions(monkeypatch):
    """Past GRAPH_CACHE keys the least recently used span is evicted and a
    key used again after its eviction is captured again; a cached key is
    replayed with no capture."""
    monkeypatch.setattr(graphs.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    made = []

    def capture(self, state, rows, enqueue):
        g = graphs.Graph(_Replay(), self.device, None, 0, [Counter() for _ in graphs.counters()],
                         1, 1, 0.0)
        made.append(g)
        return g

    monkeypatch.setattr(graphs.Graphs, "_capture", capture)
    tracing.reset_counts()
    cache = graphs.Graphs(torch.device("cpu"))
    state = torch.zeros(3)
    n = graphs.GRAPH_CACHE + 3
    for k in range(n):
        assert cache.span(("key", k), state, None, None)() is state
    assert tracing.counts == Counter(captures=n, evictions=3)
    assert len(cache) == graphs.GRAPH_CACHE and len(made) == n
    assert list(cache.values()) == made[3:]
    cache.span(("key", 4), state, None, None)()  # cached: a replay, no capture
    assert tracing.counts == Counter(captures=n, evictions=3)
    assert made[4].graph.replays == 2 and list(cache.values())[-1] is made[4]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cache.span(("key", 0), state, None, None)()  # evicted: captured again
    assert tracing.counts == Counter(captures=n + 1, evictions=4)
    assert len(made) == n + 1 and made[-1].graph.replays == 1
    assert [r[0] for r in tracing.record] == ["replay"]
    assert [e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)] == [
        "tpufdtd_torch.replay"]


@pytest.mark.parametrize("backend, layered", [("cuda", True), ("cuda", False), ("torch", True)])
def test_the_medium_span_and_counters(backend, layered):
    """An engine's medium: a per-point medium's upload goes in one top-level
    `medium` span with the bytes placed on the device (none for a uniform
    medium, which the steps take as a scalar), and the bytes and the host
    time of the uniformity scan and the upload in counts' `medium_bytes` and
    `medium_ns` whether a profiler runs or not. Without a profiler no range
    opens and nothing is recorded."""
    g = tt.Grid3D(12, 16, 20, hx=1.0, hy=1.0, hz=1.0, order=8)
    m = np.full(g.padded_shape, 1.5, np.float32)
    if layered:
        m[: g.padded_shape[0] // 2] = 2.0
    cfg = tt.SimConfig(dt=0.001, nsteps=4, backend=backend)
    placed = m.nbytes if layered or backend == "torch" else 0
    tracing.reset_counts()
    tt.Simulator(g, cfg, m, device="cpu")
    assert tracing.record == [] and tracing.counts["medium_bytes"] == placed
    assert tracing.counts["medium_ns"] > 0
    tracing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim = tt.Simulator(g, cfg, m, device="cpu")
    ranges = [e for e in prof.events() if e.name.startswith(tracing.PREFIX + ".")]
    assert [e.name for e in ranges] == [tracing.PREFIX + ".medium"]
    assert [(r[0], r[3]) for r in tracing.record] == [("medium", placed)]
    assert tracing.counts["medium_bytes"] == placed and tracing.counts["medium_ns"] > 0
    assert (sim.engine.m is None) == (placed == 0)

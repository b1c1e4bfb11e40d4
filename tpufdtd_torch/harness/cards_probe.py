"""Can one captured CUDA graph span several cards? The evidence for
parallel.sharded.graphed's rule, on a host with two or more cards.

    python3 -m tpufdtd_torch.harness.cards_probe

Each case runs in a process of its own (a failed capture can leave the
CUDA context unusable) and prints one line. Every case captures the
"torch" backend's sharded per-step loop (ShardedSimulator._enqueue, 64^3,
four shards, one per card of cuda:0-3, or cuda:0-1 twice) on a stream of
cuda:0, with a stream forked onto each other card by an event, current
there for the whole loop, and joined back by an event:
  * cold: the first cross-card copy comes inside the capture;
  * warm: one eager span first, then the capture and a replay against the
    eager loop;
  * reuse: as warm, then tensors allocated on the other cards after the
    capture and filled, and a second replay.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys

import numpy as np
import torch

CASES = ("cold", "warm", "reuse")


def _capture(graph, cards, body):
    cap = torch.cuda.Stream(cards[0])
    sides = {d: torch.cuda.Stream(d) for d in dict.fromkeys(cards[1:]) if d != cards[0]}
    with torch.cuda.device(cards[0]), torch.cuda.graph(graph, stream=cap):
        fork = torch.cuda.Event()
        fork.record(cap)
        with contextlib.ExitStack() as stack:
            for s in sides.values():
                s.wait_event(fork)
                stack.enter_context(torch.cuda.stream(s))
            out = body()
            joins = [torch.cuda.Event() for _ in sides]
            for e, s in zip(joins, sides.values()):
                e.record(s)
        for e in joins:
            cap.wait_event(e)
    return out


def run_case(case: str) -> str:
    import tpufdtd_torch as tt
    from tpufdtd_torch import graphs
    from tpufdtd_torch.parallel import ShardedSimulator, make_mesh

    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i % n) for i in range(4)]
    g = tt.Grid3D(64, 64, 64)
    m = np.full(g.padded_shape, 1.5, np.float32)
    sim = ShardedSimulator(g, tt.SimConfig(dt=0.001, backend="torch"), m,
                           make_mesh(devices=cards), tt.default_source_coords(1, 64, 64, 64))
    u = np.zeros(g.padded_shape, np.float32)
    u[g.interior_slices()] = np.random.default_rng(0).standard_normal((64, 64, 64))
    state, m_sh, terms = sim.prepare(u, u, m)
    src = tt.ricker_table(7, 1, 0.001)
    twin = graphs.copy_state(state)
    if case != "cold":
        sim.run(graphs.copy_state(state), m_sh, terms, src, 7)
    tables = {d: torch.as_tensor(src, device=d) for d in dict.fromkeys(cards)}
    graph = torch.cuda.CUDAGraph()
    out = _capture(graph, cards, lambda: sim._enqueue(state, m_sh, terms, tables, 7))
    graph.replay()
    for d in set(cards):
        torch.cuda.synchronize(d)
    want = sim.run(twin, m_sh, terms, src, 7)
    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(graphs.buffers(out),
                                                             graphs.buffers(want)))
    line = f"{case}: capture over {len(set(cards))} cards, replay bitwise eager {same}"
    if case == "reuse":
        held = [torch.full((k,), 7.0, device=d) for d in set(cards) - {cards[0]}
                for k in (1 << 10, 1 << 14, 1 << 16, 1 << 18, 1 << 20) for _ in range(4)]
        graph.replay()
        for d in set(cards):
            torch.cuda.synchronize(d)
        line += (f"; after it, {sum(int((t != 7.0).any()) for t in held)} of {len(held)}"
                 " tensors allocated on the other cards changed under a second replay")
    return line


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        print(run_case(argv[0]), flush=True)
        return 0
    if torch.cuda.device_count() < 2:
        raise RuntimeError("cards_probe needs two or more CUDA cards")
    for case in CASES:
        res = subprocess.run([sys.executable, "-m", __spec__.name, case], capture_output=True,
                             text=True, timeout=600)
        errors = [ln for ln in (res.stdout + res.stderr).splitlines()
                  if "Error" in ln or "Assertion" in ln]
        print(res.stdout.strip() or f"{case}: exit {res.returncode}; " + " | ".join(errors[:3]),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Drives one cell of the benchmark through the program under test.

A cell is a configuration (fdtdbench/configs/, a grid, medium and
precision) under a traffic mix (fdtdbench/traffic/, shots of a given length
and number of sources), both named in BENCHMARK.json. Set-up builds one
`tpufdtd_torch.Simulator` and a pool of initial wavefields, and warms up on
the cell's own shots. The window is a closed loop of shots, back to back as
a batch job submits them: a shot is `prepare_state` from host arrays, `run`
with its source table, and `extract_state` back to host arrays, timed from
the first call to the return of the last. After the window a sample of its
shots, drawn from the seed, is run again by the plain reference
(fdtdbench/reference/) from the same inputs and compared; the limits of the
comparison are fdtdbench/limits/<cell>.json.

A configuration may name a mesh, `"mesh": {"axis": "x", "shards": N}`: the
deployment's x-decomposition, one shard a card, for a grid one card does
not hold. Such a cell drives `tpufdtd_torch.parallel.ShardedSimulator` over
N cards (`prepare`, `run`, `extract_state`), makes its inputs in x-slabs,
one a card, into whole host arrays, and checks in x-slabs too
(`reference.run_slabs`, `compare_slabs`), so that no level is ever whole on
a card. Every other cell runs on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import resource
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import inputs, trace
from .reference import fdtd as reference

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufdtd")  # top-level names no run may load


def log(*parts) -> None:
    print("fdtdbench:", *parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """The loaded modules' top-level names (before the first dot) that are
    in FORBIDDEN, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict  # number compared -> limit
    end_to_end: list  # BENCHMARK.json's entries: every cell reports each
    per_layer: list  # the entries that list this cell under "workloads"
    pkg: Path  # the benchmark's folder, where its data files are


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of <root>/BENCHMARK.json, with its configuration,
    traffic and limits read from their files."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pkg = root / "fdtdbench"
    config = json.loads((root / conf["file"]).read_text())
    mesh = config.get("mesh")
    if mesh is not None:
        if set(mesh) != {"axis", "shards"} or mesh["axis"] != "x":
            raise ValueError(f"{conf['file']}: a mesh is {{\"axis\": \"x\", \"shards\": N}},"
                             f" not {mesh}")
        if mesh["shards"] != w["chips"]:
            raise ValueError(f"cell {name}: {mesh['shards']} shards on {w['chips']} chips;"
                             " a mesh takes one card a shard")
        if config["nx"] % mesh["shards"]:
            raise ValueError(f"{conf['file']}: nx={config['nx']} does not divide into"
                             f" {mesh['shards']} shards")
    return Cell(
        name=name,
        config=config,
        traffic=json.loads((pkg / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=int(w["chips"]),
        limits=_limits(pkg / "limits" / f"{name}.json"),
        end_to_end=bench["end_to_end"],
        per_layer=[m for m in bench["per_layer"] if name in m["workloads"]],
        pkg=pkg,
    )


def _limits(path: Path) -> dict:
    """A cell's limits file: {"limits": {number: limit}, ...the readings
    they were set from}; {} while the cell has none (no run judges then)."""
    return json.loads(path.read_text())["limits"] if path.is_file() else {}


def stencil_launches() -> int:
    """The program's launch counters of its stencil kernels (kernel A and
    kernel B), which a graph replay advances by its recorded launches."""
    from tpufdtd_torch.ops import stencil_step, stencil_sweep

    return sum(stencil_step.counts["kernel"].values()) + sum(
        stencil_sweep.counts["kernel"].values())


class Bench:
    """One cell's program under test and the inputs of its shots.

    `storage_dtype` replaces the configuration's (the lower-precision
    control of fdtdbench/control.py). Under a mesh the program is a
    ShardedSimulator over `cards`: cuda:0..N-1, or N shards on the CPU
    where the run's device is the CPU."""

    def __init__(self, cell: Cell, seed: int, device, storage_dtype: Optional[str] = None):
        import tpufdtd_torch as tt  # the system under test

        c, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.n = (c["nx"], c["ny"], c["nz"])
        self.order, self.h, self.dt, self.steps = c["order"], c["h"], c["dt"], tr["steps"]
        self.storage_dtype = storage_dtype or c["storage_dtype"]
        self.mesh = c.get("mesh")
        shards = self.mesh["shards"] if self.mesh else 1
        self.cards = ([torch.device(self.device.type, d) for d in range(shards)]
                      if self.mesh and self.cuda else [self.device] * shards)
        padded = tuple(k + 2 * self.order for k in self.n)
        self.coords = inputs.lattice_coords(tr["sources"], self.n, self.h)
        self.boxes = source_boxes(self.coords, self.n, self.h, self.order)
        grid = tt.Grid3D(*self.n, hx=self.h, hy=self.h, hz=self.h, order=self.order)
        cfg = tt.SimConfig(dt=self.dt, nsteps=self.steps, backend="cuda",
                           storage_dtype=self.storage_dtype)
        if self.mesh:
            t0 = time.perf_counter()
            self.per_point_m = c["medium"]["kind"] != "uniform"
            # the program takes a padded host array; a uniform medium is a
            # read-only view of one number (no bytes), a per-point one is
            # made a slab a card
            m_host = (self._host_slabs(lambda dev, pl: (inputs.medium(c, seed, dev, cell.pkg,
                                                                       pl),))[0]
                      if self.per_point_m else np.broadcast_to(
                          np.float32(inputs.medium(c, seed, "cpu", cell.pkg)), padded))
            self.pool = [self._host_slabs(lambda dev, pl, j=j: inputs.initial_fields(
                c, tr, seed, j, dev, cell.pkg, pl)) for j in range(tr["ic"]["pool"])]
            if self.cuda:  # the cards' cache held the slabs' temporaries, not the program's
                torch.cuda.empty_cache()
            from tpufdtd_torch.parallel import ShardedSimulator, make_mesh

            t1 = time.perf_counter()
            mesh = make_mesh(shards) if self.cuda else make_mesh(devices=["cpu"] * shards)
            self.sim = ShardedSimulator(grid, cfg, m_host, mesh, self.coords)
            self.state = None
            log(f"host inputs made a slab a card in {t1 - t0:.3f} s, the ShardedSimulator over"
                f" {shards} shards built in {time.perf_counter() - t1:.3f} s")
            return
        med = inputs.medium(c, seed, self.device, cell.pkg)
        self.per_point_m = not isinstance(med, float)
        m_host = med.cpu().numpy() if self.per_point_m else np.full(padded, med, np.float32)
        del med
        self.pool = []
        for j in range(tr["ic"]["pool"]):
            fields = inputs.initial_fields(c, tr, seed, j, self.device, cell.pkg)
            self.pool.append(tuple(u.cpu().numpy() for u in fields))
            del fields
        self.sim = tt.Simulator(grid, cfg, m_host, self.coords, device=self.device)
        self.state = None  # the last shot's state, held as a caller holds it

    def _host_slabs(self, make) -> tuple:
        """Whole padded host arrays made a slab a card: make(device, planes)
        gives the tensors of the padded x planes `planes` on `device`, which
        are copied into their planes of the host arrays and dropped."""
        padded = tuple(k + 2 * self.order for k in self.n)
        out = None
        for dev, (lo, hi) in zip(self.cards, reference.owned_planes(self.n[0], self.order,
                                                                    len(self.cards))):
            slabs = make(dev, (lo, hi))
            if out is None:
                out = tuple(np.empty(padded, np.float32) for _ in slabs)
            for host, slab in zip(out, slabs):
                torch.from_numpy(host[lo:hi]).copy_(slab)
            del slabs
        return out

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            for card in self.cards:
                torch.cuda.synchronize(card)

    def table(self, stream: int, i: int) -> np.ndarray:
        return inputs.wavelets(self.cell.traffic, self.dt, inputs.rng(self.seed, stream, i))

    @contextlib.contextmanager
    def _span(self, kind: str, i: int, spans: Optional[dict]):
        """A host span: with `spans` a record_function range on the
        profiler's clock and its seconds, ending in a synchronize."""
        if spans is None:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"{trace.SPAN}.{kind}.{i}"):
            yield
            self.sync()
        spans[kind] = time.perf_counter() - t0

    def shot(self, i: int, table: np.ndarray, spans: bool = False):
        """Shot i: (its trace.Shot, the host arrays extract_state returned)."""
        sim = self.sim
        u_prev, u_cur = self.pool[i % len(self.pool)]
        before = set() if sim.graphs is None else {id(g) for g in sim.graphs.values()}
        secs = {} if spans else None
        t0 = time.perf_counter()
        with self._span("shot", i, secs):
            if self.mesh:
                # a grid that fills the cards leaves no room for two
                # states: the last shot's goes before the next is made
                self.state = None
                with self._span("prepare", i, secs):
                    state, m_sh, terms = sim.prepare(u_prev, u_cur)
                with self._span("run", i, secs):
                    self.state = sim.run(state, m_sh, terms, table, self.steps)
                with self._span("extract", i, secs):
                    out = sim.extract_state(self.state)
            else:
                with self._span("prepare", i, secs):
                    self.state = sim.prepare_state(u_prev, u_cur)
                with self._span("run", i, secs):
                    self.state = sim.run(self.state, table, self.steps)
                with self._span("extract", i, secs):
                    out = sim.extract_state(self.state)
        rec = trace.Shot(steps=self.steps, seconds=time.perf_counter() - t0, levels=len(out))
        if secs is not None:
            rec.prepare_s, rec.run_s, rec.extract_s = secs["prepare"], secs["run"], secs["extract"]
        if sim.graphs is not None and len(sim.graphs):
            rec.capture_s = sum(g.seconds for g in sim.graphs.values() if id(g) not in before)
            key, graph = next(reversed(sim.graphs.items()))  # the span just replayed
            rec.nodes, rec.graph_steps = graph.nodes, key[1]
        return rec, out

    def peak_bytes(self) -> int:
        """The fullest card's torch.cuda.max_memory_allocated (0 off the card)."""
        return max(torch.cuda.max_memory_allocated(c) for c in self.cards) if self.cuda else 0

    def reset_peaks(self) -> None:
        if self.cuda:
            for card in self.cards:
                torch.cuda.reset_peak_memory_stats(card)

    def free(self) -> None:
        """Drop the program and its state (the inputs stay)."""
        self.sim = self.state = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


BOX = 8  # half-width in cells of the box around each source that source_err reads


def source_boxes(coords, n, h: float, halo: int) -> list:
    """For each source, the slices of the padded array that hold the cells
    within BOX of the cell its position falls in."""
    padded = [k + 2 * halo for k in n]
    boxes = []
    for c in np.asarray(coords, np.float32):
        centre = [int(np.floor(x / np.float32(h))) + halo for x in c]
        boxes.append(tuple(slice(max(q - BOX, 0), min(q + BOX + 1, p))
                           for q, p in zip(centre, padded)))
    return boxes


def compare(out, ref, u_cur, boxes, detail: Optional[dict] = None) -> dict:
    """The numbers compared for one shot (tensors on one device):
    field_err, the largest over the levels the program returned of the L2
    gap ||program - reference|| over the whole padded array, relative to
    ||u_cur||, the initial field both sides were handed: a scale the seed
    does not move, where the final field's norm follows the drawn wavelets
    while the gap does not.
    source_err, the largest over the sources' boxes (source_boxes) and the
    levels returned of the relative L2 gap inside the box, against the
    reference's field there: the source's own wave fills its box, so a
    source left out, misplaced or mis-scaled moves it by its share.
    step_err, the relative L2 gap of the last step's change u_N - u_{N-1}
    (the first two levels returned), which a level returned in the wrong
    role moves by the whole change. `detail`, where given, gets the norms
    behind them."""

    def norm(x):
        return float(torch.linalg.vector_norm(x, dtype=torch.float64))

    gaps = [norm(o - r) for o, r in zip(out, ref)]
    field = max(gaps) / norm(u_cur)
    box_gaps = [[norm(o[b] - r[b]) for o, r in zip(out, ref)] for b in boxes]
    box_norms = [[norm(r[b]) for r in ref[:len(out)]] for b in boxes]
    source = max((g / n for gs, ns in zip(box_gaps, box_norms) for g, n in zip(gs, ns)),
                 default=0.0)
    step = norm((out[1] - out[0]) - (ref[1] - ref[0])) / norm(ref[1] - ref[0])
    if detail is not None:
        detail.update(gaps=gaps, initial_norm=norm(u_cur),
                      norms=[norm(r) for r in ref[:len(out)]], box_gaps=box_gaps,
                      box_norms=box_norms)
    return {"field_err": field, "source_err": source, "step_err": step}


CHUNK = 2**28  # elements of planes taken at once by the slab check (1 GiB in f32)


def _sq(x) -> float:
    """||x||^2 in float64, CHUNK elements of x's planes at a time (the norm
    makes a float64 copy of what it reads)."""
    step = max(1, CHUNK // math.prod(x.shape[1:]))
    return sum(float(torch.linalg.vector_norm(x[a:a + step], dtype=torch.float64)) ** 2
               for a in range(0, x.shape[0], step))


def compare_slabs(out, ref, initial_norm: float, boxes, halo: int,
                  detail: Optional[dict] = None) -> dict:
    """`compare` for a grid held in x-slabs: `out` the program's whole host
    arrays, `ref` the levels of reference.run_slabs, each a list of slabs
    (slab d the padded planes reference.slab_planes(...)[d], on its
    device), `initial_norm` ||u_cur|| over the whole padded array. The same
    numbers by the same definitions: the squared gaps and norms are summed
    in float64 over the planes each slab owns (reference.owned_planes), the
    program's planes taken to the slab's card CHUNK elements at a time, so
    a card holds no more than the reference's slabs and a few chunks; each
    source's box is gathered from the host arrays and the slabs it
    straddles."""
    S, k = len(ref[0]), len(out)
    nx = out[0].shape[0] - 2 * halo
    starts = [lo for lo, _hi in reference.slab_planes(nx, halo, S)]
    owned = reference.owned_planes(nx, halo, S)
    chunk = max(1, CHUNK // math.prod(out[0].shape[1:]))  # planes
    gaps2, norms2, step_gap2, step2 = [0.0] * k, [0.0] * k, 0.0, 0.0
    for d, (lo, hi) in enumerate(owned):
        for a in range(lo, hi, chunk):
            b = min(a + chunk, hi)
            o = [torch.from_numpy(x[a:b]).to(ref[0][d].device) for x in out]
            r = [level[d][a - starts[d]: b - starts[d]] for level in ref[:k]]
            dr = r[1] - r[0]
            step2 += _sq(dr)
            step_gap2 += _sq((o[1] - o[0]).sub_(dr))
            for q in range(k):
                gaps2[q] += _sq(o[q] - r[q])
                norms2[q] += _sq(r[q])
            del o, r, dr

    def ref_box(level, box):
        sx = box[0]
        return torch.cat([level[d][max(lo, sx.start) - starts[d]: min(hi, sx.stop) - starts[d],
                                   box[1], box[2]].cpu()
                          for d, (lo, hi) in enumerate(owned)
                          if max(lo, sx.start) < min(hi, sx.stop)])

    box_gaps, box_norms = [], []
    for b in boxes:
        rb = [ref_box(level, b) for level in ref[:k]]
        ob = [torch.from_numpy(np.ascontiguousarray(x[b])) for x in out]
        box_gaps.append([math.sqrt(_sq(o - r)) for o, r in zip(ob, rb)])
        box_norms.append([math.sqrt(_sq(r)) for r in rb])
    gaps, norms = [math.sqrt(g) for g in gaps2], [math.sqrt(n) for n in norms2]
    source = max((g / n for gs, ns in zip(box_gaps, box_norms) for g, n in zip(gs, ns)),
                 default=0.0)
    if detail is not None:
        detail.update(gaps=gaps, initial_norm=initial_norm, norms=norms, box_gaps=box_gaps,
                      box_norms=box_norms)
    return {"field_err": max(gaps) / initial_norm, "source_err": source,
            "step_err": math.sqrt(step_gap2) / math.sqrt(step2)}


def check_shot_slabs(bench: Bench, i: int, out, detail: Optional[dict] = None) -> dict:
    """check_shot under a mesh: the inputs made again a slab a card (the
    reference's slabs, reference.slab_planes), reference.run_slabs on the
    cell's cards, and compare_slabs."""
    cell, c, S = bench.cell, bench.cell.config, len(bench.cards)
    planes = reference.slab_planes(bench.n[0], bench.order, S)
    owned = reference.owned_planes(bench.n[0], bench.order, S)
    fields = [inputs.initial_fields(c, cell.traffic, bench.seed, i % len(bench.pool), dev,
                                    cell.pkg, pl) for dev, pl in zip(bench.cards, planes)]
    prev, cur = [f[0] for f in fields], [f[1] for f in fields]
    del fields
    initial = math.sqrt(sum(_sq(u[lo - pl[0]: hi - pl[0]])
                            for u, pl, (lo, hi) in zip(cur, planes, owned)))
    m = [inputs.medium(c, bench.seed, dev, cell.pkg, pl) for dev, pl in zip(bench.cards, planes)]
    if isinstance(m[0], float):
        m = m[0]
    t0 = time.perf_counter()
    ref = reference.run_slabs(prev, cur, m, bench.table(inputs.SHOT, i), bench.coords,
                              order=bench.order, h=bench.h, dt=bench.dt, nsteps=bench.steps)
    del prev, cur, m
    bench.sync()
    secs = time.perf_counter() - t0
    log(f"check shot {i}: the plain reference in {S} x-slabs, {secs:.3f} s,"
        f" {secs / bench.steps * 1e3:.3f} ms a step")
    return compare_slabs(out, ref, initial, bench.boxes, bench.order, detail)


def check_shot(bench: Bench, i: int, out, detail: Optional[dict] = None) -> dict:
    """Run window shot i again in the plain reference and compare what the
    program returned for it. The reference's inputs are made again from
    the seed, as they were for the program, so nothing the program did to
    the arrays it was handed reaches the reference. Under a mesh the
    inputs are made, the reference is run and the comparison made in
    x-slabs on the cell's cards (check_shot_slabs)."""
    if bench.mesh:
        return check_shot_slabs(bench, i, out, detail)
    cell, dev = bench.cell, bench.device
    u_prev, u_cur = inputs.initial_fields(cell.config, cell.traffic, bench.seed,
                                          i % len(bench.pool), dev, cell.pkg)
    m = inputs.medium(cell.config, bench.seed, dev, cell.pkg)
    ref = reference.run(u_prev, u_cur, m, bench.table(inputs.SHOT, i), bench.coords,
                        order=bench.order, h=bench.h, dt=bench.dt, nsteps=bench.steps)
    del m, u_prev
    got = [torch.as_tensor(o, device=dev) for o in out]
    return compare(got, ref, u_cur, bench.boxes, detail)


def judge(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


class HostMemoryError(RuntimeError):
    """The cell would hold more on the host than the host has free."""


def host_bytes(cell: Cell) -> int:
    """Bytes of the host arrays a run of the cell holds at once: the pool
    of initial fields (two levels an entry), the outputs kept for the
    check and one shot's returned levels (three levels a shot, the most
    extract_state returns), and the medium where the harness makes it
    whole (a per-point medium, or any medium on one card)."""
    c, tr = cell.config, cell.traffic
    level = math.prod(c[k] + 2 * c["order"] for k in ("nx", "ny", "nz")) * 4
    medium = 0 if c.get("mesh") and c["medium"]["kind"] == "uniform" else 1
    return level * (2 * tr["ic"]["pool"] + 3 * tr["check_shots"] + 3 + medium)


def mem_available(path: str = "/proc/meminfo") -> Optional[int]:
    """The host's MemAvailable, in bytes; None where the file has none."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def host_peak_rss() -> int:
    """This process's peak resident set (getrusage's ru_maxrss), in bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """One run of a cell: set-up from t0 (the process's start), warm-up,
    the window, its metrics, and the comparison; returns the result line."""
    tr = cell.traffic
    if not cell.limits:
        raise FileNotFoundError(f"cell {cell.name} has no limits file in {cell.pkg / 'limits'}")
    need, have = host_bytes(cell), mem_available()
    if have is not None and need > have:
        raise HostMemoryError(f"cell {cell.name} holds {need} bytes on the host (pool, outputs"
                              f" kept for the check, a shot's returned levels, the medium);"
                              f" MemAvailable is {have} bytes")
    bench = Bench(cell, seed, device)
    cuda = bench.cuda
    # warm-up on the cell's own shots until one captures nothing, at most
    # warmup_shots: the first builds the kernels (on a checkout's first run)
    warm = []
    for w in range(tr["warmup_shots"]):
        rec = bench.shot(w, bench.table(inputs.WARMUP, w))[0]  # its levels go at once
        warm.append(rec)
        if w and not rec.capture_s:
            break
    bench.sync()
    log(f"warm-up: {len(warm)} shots (c: captured): " + " ".join(
        f"{s.seconds:.3f}{'c' if s.capture_s else ''}" for s in warm))
    peak_setup = bench.peak_bytes()
    bench.reset_peaks()
    win0 = time.perf_counter()
    setup_s = win0 - t0

    n_trace = tr["trace_shots"] if traced else 0
    sampler, k = inputs.rng(seed, inputs.CHECK), tr["check_shots"]
    shots, kept, prof, launches = [], {}, None, None
    while True:
        i = len(shots)
        table = bench.table(inputs.SHOT, i)
        if i == 0 and n_trace:
            prof = _profiler(cuda)
            prof.start()
            launches = stencil_launches()
        rec, out = bench.shot(i, table, spans=traced)
        if prof is not None and i == n_trace - 1:
            bench.sync()
            prof.stop()
            launches = stencil_launches() - launches
        shots.append(rec)
        slot = i if i < k else int(sampler.integers(0, i + 1))
        if slot < k:
            kept[slot] = (i, out)
        del out
        if time.perf_counter() - win0 >= seconds and len(shots) >= n_trace:
            break
    bench.sync()
    window_s = time.perf_counter() - win0

    window_peak = bench.peak_bytes()  # the fullest card's
    result_device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if cuda:
        result_device = {"platform": "gpu", "kind": torch.cuda.get_device_name(bench.device),
                         "count": len(bench.cards),
                         "memory_peak_bytes": max(peak_setup, window_peak)}
    cells = math.prod(bench.n)
    times = [s.seconds for s in shots]
    log(f"cell {cell.name}, seed {seed}: set-up {setup_s:.3f} s; {len(shots)} shots of"
        f" {bench.steps} steps in a window of {window_s:.3f} s; shot seconds median"
        f" {float(np.median(times)):.4f}, p95 {float(np.percentile(times, 95)):.4f} over"
        f" {len(times)} shots; captures in the window {sum(1 for s in shots if s.capture_s)};"
        f" the fullest card's peak {window_peak} bytes in the window, {peak_setup} in set-up")
    log("shot seconds (c: captured): " + " ".join(
        f"{s.seconds:.3f}{'c' if s.capture_s else ''}" for s in shots))

    metrics, breakdown = {}, None
    if not traced:
        e2e = {
            "gcell_per_s": cells * sum(s.steps for s in shots) / window_s / 1e9,
            "shot_s_p95": float(np.percentile(times, 95)),
            "peak_device_gib": window_peak / 2**30,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if m["name"] in e2e and (cuda or m["name"] != "peak_device_gib"):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        storage = 2 if bench.storage_dtype == "bfloat16" else 4
        readings = trace.Readings(
            shots=shots, cells=cells, order=bench.order, elem_bytes=storage,
            medium_bytes=4 if bench.per_point_m else 0,
            device_kind=result_device["kind"], traced_shots=list(range(n_trace)),
            launches=launches)
        readings.device, readings.spans, readings.cards = trace.from_profiler(prof)
        del prof
        for j in readings.traced_shots:
            log(f"traced shot {j}: prepare {shots[j].prepare_s:.4f} s, run {shots[j].run_s:.4f}"
                f" s, extract {shots[j].extract_s:.4f} s")
        for m in cell.per_layer:
            value = inputs.load(cell.pkg / "metrics" / f"{m['name']}.py").read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = trace.busy_us(readings)
        if busy is not None and bench.mesh:
            # the mean of the cards' own busy times
            busy = sum(trace.busy_us(readings, c.index) or 0.0 for c in bench.cards) / len(
                bench.cards)
        if busy is not None:
            win = readings.window_us
            result_device["busy_s"] = busy * 1e-6
            result_device["window_s"] = (win[1] - win[0]) * 1e-6
        captured = {i for i, s in enumerate(shots) if s.capture_s}
        breakdown = trace.breakdown(readings, captured)

    # the comparison, once the window has closed and the program is freed
    bench.free()
    checks, failed = {}, 0
    for slot in sorted(kept):
        i, out = kept[slot]
        numbers = {k: v for k, v in check_shot(bench, i, out).items() if k in cell.limits}
        failed += not judge(numbers, cell.limits)
        log(f"check shot {i}: " + ", ".join(
            f"{k} {v!r} (limit {cell.limits[k]!r})" for k, v in numbers.items()))
        for key, v in numbers.items():
            if key not in checks or not v <= checks[key]:
                checks[key] = v
    checks = {key: {"value": v, "limit": cell.limits[key]} for key, v in checks.items()}
    for key, c in checks.items():
        log(f"compared {key}: worst {c['value']!r}, limit {c['limit']!r}")
    log(f"host peak RSS {host_peak_rss()} bytes")
    result = {"correct": failed == 0 and bool(checks), "attempted": len(shots),
              "failed": failed, "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)

"""The harness over x-slabs, on the CPU at 32^3 and 16^3: inputs made a slab
at a time, the plain reference and the comparison in slabs, a configuration
with a mesh run on a CPU mesh, the refusals and the host memory guard, and
the trace's intervals kept per card."""

import json
import shutil
import time
import types

import numpy as np
import pytest
import torch

from fdtdbench import harness, inputs, trace
from fdtdbench.reference import fdtd
from fdtdbench_cells import tiny

ROOT = harness.ROOT
SEED = 2**35 + 11
N, SLABS = 32, 4
LAYERED = {"kind": "layered", "layer_m": [1.0, 1.3, 1.6, 2.0, 2.5],
           "interfaces": [0.2, 0.4, 0.6, 0.8], "dip": 0.1, "perturb": 0.05, "terms": 4}
MEDIA = {"uniform": {"kind": "uniform", "m": 1.5}, "layered": LAYERED}


def config(order, medium):
    return {"nx": N, "ny": N, "nz": N, "order": order, "medium": MEDIA[medium]}


def traffic(steps=10, sources=1):
    return {"steps": steps, "sources": sources,
            "wavelet": {"f0": 10.0, "amp": [0.5, 2.0], "peak_at": [0.2, 0.8]},
            "ic": {"kind": "smooth", "amp": 1e-3 * N**1.5, "periods": [4.0, 12.0],
                   "terms": 8, "prev_offset": 1e-3}}


def slab_sets(order):
    """The two ways the harness cuts the padded x planes: the slabs the
    reference holds (overlapping by the halo) and those that split them."""
    return [fdtd.slab_planes(N, order, SLABS), fdtd.owned_planes(N, order, SLABS)]


@pytest.mark.parametrize("kind", ["smooth", "layered", "uniform"])
@pytest.mark.parametrize("order", [4, 8])
def test_slabs_of_the_inputs_equal_the_whole_arrays(kind, order):
    if kind == "smooth":
        make = lambda pl: inputs.initial_fields(config(order, "uniform"), traffic(),  # noqa: E731
                                                SEED, 1, "cpu", planes=pl)
    else:
        make = lambda pl: (inputs.medium(config(order, kind), SEED, "cpu", planes=pl),)  # noqa
    whole = make(None)
    if kind == "uniform":
        assert whole == (1.5,) and make((0, 3)) == (1.5,)
        return
    owned, overlapping = slab_sets(order)[1], slab_sets(order)[0]
    assert owned[0][0] == 0 and owned[-1][1] == N + 2 * order
    assert all(a[1] == b[0] for a, b in zip(owned, owned[1:]))
    for planes in (owned, overlapping):
        for lo, hi in planes:
            for w, s in zip(whole, make((lo, hi))):
                assert torch.equal(w[lo:hi], s), (lo, hi)
    for w, *parts in zip(whole, *(make(pl) for pl in owned)):
        assert torch.equal(torch.cat(parts), w)


def reference_case(order, medium, sources, steps=10):
    """The whole reference's levels and run_slabs' on 4 CPU slabs, from the
    same inputs."""
    c, tr = config(order, medium), traffic(steps, sources)
    n, h, dt = (N, N, N), 0.1, 0.001
    coords = inputs.lattice_coords(sources, n, h)
    table = inputs.wavelets(tr, dt, inputs.rng(SEED, inputs.SHOT))
    u_prev, u_cur = inputs.initial_fields(c, tr, SEED, 0, "cpu")
    m = inputs.medium(c, SEED, "cpu")
    whole = fdtd.run(u_prev, u_cur, m, table, coords, order=order, h=h, dt=dt, nsteps=steps)
    planes = fdtd.slab_planes(N, order, SLABS)
    fields = [inputs.initial_fields(c, tr, SEED, 0, "cpu", planes=pl) for pl in planes]
    m_slabs = m if isinstance(m, float) else [inputs.medium(c, SEED, "cpu", planes=pl)
                                              for pl in planes]
    slabs = fdtd.run_slabs([f[0] for f in fields], [f[1] for f in fields], m_slabs, table,
                           coords, order=order, h=h, dt=dt, nsteps=steps)
    return whole, slabs, u_cur, coords, h


def joined(level, order):
    """A level of run_slabs as one array: each slab's owned planes."""
    starts = [lo for lo, _hi in fdtd.slab_planes(N, order, SLABS)]
    return torch.cat([s[lo - a: hi - a] for s, a, (lo, hi) in
                      zip(level, starts, fdtd.owned_planes(N, order, SLABS))])


@pytest.mark.parametrize("sources", [1, 27])
@pytest.mark.parametrize("medium", ["uniform", "layered"])
@pytest.mark.parametrize("order", [4, 8])
def test_run_slabs_equals_the_whole_reference(order, medium, sources):
    # bitwise: each cell goes through the same operations in the same
    # order, on the same z rows; 27 sources put corners on both sides of a
    # slab's edge at 32^3
    whole, slabs, u_cur, _coords, _h = reference_case(order, medium, sources)
    for w, s in zip(whole, slabs):
        assert torch.equal(joined(s, order), w)
    assert float((whole[1] - u_cur).norm() / u_cur.norm()) > 1e-3  # the field moved


@pytest.mark.parametrize("chunk", [harness.CHUNK, 3 * (N + 8) ** 2])
@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("sources", [1, 27])
def test_compare_in_slabs_equals_the_whole_compare(levels, sources, chunk, monkeypatch):
    monkeypatch.setattr(harness, "CHUNK", chunk)  # whole slabs, or 3 planes at a time
    order = 4
    whole, slabs, u_cur, coords, h = reference_case(order, "layered", sources)
    g = torch.Generator().manual_seed(7)
    out = [(w + 1e-4 * w.abs().max() * torch.randn(w.shape, generator=g)).numpy()
           for w in whole[:levels]]
    boxes = harness.source_boxes(coords, (N, N, N), h, order)
    want_detail, got_detail = {}, {}
    want = harness.compare([torch.as_tensor(o) for o in out], whole, u_cur, boxes, want_detail)
    got = harness.compare_slabs(out, slabs, float(torch.linalg.vector_norm(
        u_cur, dtype=torch.float64)), boxes, order, got_detail)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    for k in ("gaps", "norms", "box_gaps", "box_norms"):
        assert np.allclose(got_detail[k], want_detail[k], rtol=1e-12, atol=0), k
    # a box that straddles a slab's edge is there
    cuts = [hi for _lo, hi in fdtd.owned_planes(N, order, SLABS)[:-1]]
    assert any(b[0].start < c < b[0].stop for b in boxes for c in cuts)


def mesh_root(tmp_path, shards=4, chips=4):
    """A checkout with one more configuration, ref512-o4 with a mesh, and
    its cell under the short traffic, added as data."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fdtdbench", tmp_path / "fdtdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = tmp_path / "fdtdbench"
    conf = json.loads((pkg / "configs" / "ref512-o4.json").read_text())
    conf.update(name="ref512-o4.x4", mesh={"axis": "x", "shards": shards})
    (pkg / "configs" / "ref512-o4.x4.json").write_text(json.dumps(conf))
    (pkg / "limits" / "ref512-o4.x4.short.json").write_text(
        (pkg / "limits" / "ref512-o4.short.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="ref512-o4.x4",
                                 file="fdtdbench/configs/ref512-o4.x4.json"))
    bench["workloads"].append({"name": "ref512-o4.x4.short", "config": "ref512-o4.x4",
                               "traffic": "short", "chips": chips, "why": "added as data"})
    for m in bench["per_layer"]:
        m["workloads"].append("ref512-o4.x4.short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_a_four_shard_configuration_added_as_data_runs_on_a_cpu_mesh(tmp_path, monkeypatch):
    root = mesh_root(tmp_path)
    results = {}
    for name in ("ref512-o4.short", "ref512-o4.x4.short"):
        cell = tiny(name, root=root)
        # one shot in the window, so both sides check the same one
        results[name] = harness.run_cell(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    one, mesh = results["ref512-o4.short"], results["ref512-o4.x4.short"]
    assert mesh["correct"] is True and mesh["attempted"] == one["attempted"] == 1
    assert set(mesh["checks"]) == {"field_err", "source_err", "step_err"}
    for k, v in one["checks"].items():
        assert mesh["checks"][k]["value"] == pytest.approx(v["value"], abs=1e-6), k
    assert set(mesh["metrics"]) == {"gcell_per_s", "shot_s_p95", "setup_s"}

    # traced: the program's record starts empty, as in a run's own process
    from tpufdtd_torch.utils import tracing

    monkeypatch.setattr(tracing, "record", [])
    cell = tiny("ref512-o4.x4.short", root=root)
    cell.traffic.update(steps=6, trace_shots=1)
    traced = harness.run_cell(cell, SEED + 1, 0.0, True, "cpu", time.perf_counter())
    assert traced["correct"] is True and "host_io_ms_per_shot" in traced["metrics"]
    assert harness.forbidden_modules() == []


def test_a_mesh_bench_drives_the_sharded_program(tmp_path):
    cell = tiny("ref512-o4.x4.short", root=mesh_root(tmp_path))
    assert cell.config["mesh"] == {"axis": "x", "shards": 4} and cell.chips == 4
    bench = harness.Bench(cell, SEED, "cpu")
    from tpufdtd_torch.parallel import ShardedSimulator

    assert isinstance(bench.sim, ShardedSimulator) and bench.sim.ndev == 4
    assert bench.cards == [torch.device("cpu")] * 4
    one = harness.Bench(tiny("ref512-o4.short", root=tmp_path), SEED, "cpu")
    for a, b in zip(bench.pool[0], one.pool[0]):  # made a slab a card, equal to the whole
        assert np.array_equal(a, b)
    rec, out = bench.shot(0, bench.table(inputs.SHOT, 0), spans=True)
    assert rec.levels == len(out) == 2 and rec.capture_s == 0.0 and rec.nodes is None
    assert rec.prepare_s > 0 and rec.run_s > 0 and rec.extract_s > 0
    assert bench.peak_bytes() == 0


@pytest.mark.parametrize("mesh, chips, nx, why", [
    ({"axis": "x", "shards": 4}, 1, 512, "4 shards on 1 chips"),
    ({"axis": "x", "shards": 2}, 4, 512, "2 shards on 4 chips"),
    ({"axis": "x", "shards": 4}, 4, 510, "does not divide"),
    ({"axis": "y", "shards": 4}, 4, 512, "a mesh is"),
])
def test_load_cell_refuses_a_mesh_that_does_not_fit(tmp_path, mesh, chips, nx, why):
    root = mesh_root(tmp_path, shards=mesh["shards"], chips=chips)
    path = root / "fdtdbench" / "configs" / "ref512-o4.x4.json"
    conf = json.loads(path.read_text())
    conf.update(mesh=mesh, nx=nx)
    path.write_text(json.dumps(conf))
    with pytest.raises(ValueError, match=why):
        harness.load_cell("ref512-o4.x4.short", root)


def test_host_memory_guard_refuses_before_building(tmp_path, monkeypatch):
    root = mesh_root(tmp_path)
    one, mesh = (harness.load_cell(n, root) for n in ("ref512-o4.short", "ref512-o4.x4.short"))
    level = 520**3 * 4
    # short: a pool of 2, 4 shots kept, one returned; the medium whole on one card only
    assert harness.host_bytes(one) == level * (2 * 2 + 3 * 4 + 3 + 1)
    assert harness.host_bytes(mesh) == level * (2 * 2 + 3 * 4 + 3)

    assert harness.mem_available("/nonexistent") is None and harness.host_peak_rss() > 0

    def never(*_a, **_k):
        raise AssertionError("built before the guard")

    monkeypatch.setattr(harness, "Bench", never)
    monkeypatch.setattr(harness, "mem_available", lambda: level)
    with pytest.raises(harness.HostMemoryError, match=f"MemAvailable is {level} bytes"):
        harness.run_cell(mesh, SEED, 0.0, False, "cpu", time.perf_counter())


def test_trace_keeps_each_interval_s_card():
    ev = lambda name, a, b, dev, idx: types.SimpleNamespace(  # noqa: E731
        name=name, time_range=types.SimpleNamespace(start=a, end=b), device_type=dev,
        device_index=idx)
    CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    prof = types.SimpleNamespace(events=lambda: [
        ev("fdtdbench.shot.0", 0, 100, CPU, -1), ev("fdtdbench.shot.0", 0, 100, CUDA, 0),
        ev("k", 10, 30, CUDA, 0), ev("k", 20, 60, CUDA, 1), ev("k", 40, 50, CUDA, 3),
        ev("aten::add", 5, 6, CPU, -1)])
    device, spans, cards = trace.from_profiler(prof)
    assert device == [("k", 10, 30), ("k", 20, 60), ("k", 40, 50)] and cards == [0, 1, 3]
    assert spans == [("shot", 0, 0, 100)]
    r = trace.Readings(shots=[trace.Shot(steps=1, seconds=1.0)], cells=1, order=4,
                       elem_bytes=4, medium_bytes=0, device_kind="x", traced_shots=[0],
                       device=device, spans=spans, cards=cards)
    assert trace.busy_us(r) == 50  # [10, 60) on any card
    assert [trace.busy_us(r, c) for c in range(4)] == [20, 40, None, 10]


@pytest.mark.gpu
def test_a_four_shard_cell_on_four_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    cell = tiny("ref512-o4.x4.short", n=32, root=mesh_root(tmp_path))
    result = harness.run_cell(cell, 5, 0.5, True, "cuda", time.perf_counter())
    assert result["correct"] is True, result
    assert result["device"]["count"] == 4 and result["device"]["busy_s"] > 0

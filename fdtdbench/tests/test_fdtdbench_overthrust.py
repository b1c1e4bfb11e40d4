"""The SEG/EAGE Overthrust cell (overthrust-o8.rec4s) on the CPU: its files
found by name, its configuration as published, the plain reference against
the port at an odd shape that is no cube with the configuration's medium,
a rehearsal at a test-only size with no JAX module loaded, and the readers
of its per-layer metrics on synthetic readings."""

import json
import subprocess
import sys
import types
from collections import Counter

import numpy as np
import pytest
import torch

from fdtdbench import harness, inputs, program, roofline, trace
from fdtdbench.reference import fdtd
from test_fdtdbench_metrics import KA, KB, PKG, readings

ROOT = harness.ROOT
CELL = "overthrust-o8.rec4s"
METRICS = ("exact_stencil_device_ms_per_step", "exact_stencil_roofline_pct",
           "exact_inject_device_ms_per_step", "medium_setup_ms")


def reader(name):
    return inputs.load(PKG / "metrics" / f"{name}.py").read


def test_the_cell_and_its_files_found_by_name():
    cell = harness.load_cell(CELL)
    c, tr = cell.config, cell.traffic
    assert (c["nx"], c["ny"], c["nz"], c["h"], c["dt"], c["order"]) == (187, 801, 801, 0.025,
                                                                        0.0015, 8)
    assert c["storage_dtype"] == "float32" and c["reduced"] == [] and "mesh" not in c
    assert c["medium"]["kind"] == "layered" and any("medium" in a for a in c["assumed"])
    assert c["medium"]["layer_m"] == [0.2066, 0.1111, 0.0693, 0.0434, 0.0278]
    # c dt / h at the fastest perturbed cell, under order 8's 3-D limit
    w = fdtd.fd_weights(8)
    limit = 2 / np.sqrt(3 * (abs(w[0]) + 2 * sum(abs(x) for x in w[1:])))
    v_max = (min(c["medium"]["layer_m"]) * (1 - c["medium"]["perturb"])) ** -0.5
    courant = v_max * c["dt"] / c["h"]
    assert courant == pytest.approx(0.369, abs=1e-3) and courant < limit
    assert tr["steps"] == 2667 and tr["steps"] * c["dt"] == pytest.approx(4.0, abs=1e-3)
    assert (tr["sources"], tr["warmup_shots"], tr["trace_shots"], tr["check_shots"]) == (1, 10,
                                                                                         1, 1)
    assert cell.chips == 1 and set(cell.limits) == {"field_err", "source_err", "step_err"}
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    for m in cell.per_layer:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file() and m["workloads"] == [CELL]
    # the harness's source: the lattice point at 1/4 of each extent, 1.16 km deep
    assert inputs.lattice_coords(1, (187, 801, 801), 0.025)[0] == pytest.approx(
        [1.1625, 5.0, 5.0])
    # the host holds 11 levels of 203 x 817 x 817 f32
    assert harness.host_bytes(cell) == 11 * 203 * 817 * 817 * 4


@pytest.mark.parametrize("shape", [(11, 25, 27), (27, 11, 25)])
def test_reference_agrees_with_the_port_at_an_odd_shape(shape):
    """The configuration's medium block at order 8 on a grid that is no
    cube, with odd extents: the port (the exact ring, kernel A's plain
    version here) against the plain reference on seeded inputs."""
    import tpufdtd_torch as tt

    conf = json.loads((PKG / "configs" / "overthrust-o8.json").read_text())
    conf.update(nx=shape[0], ny=shape[1], nz=shape[2])
    order, h, dt, steps, seed = conf["order"], conf["h"], conf["dt"], 40, 2**31 + 9
    traffic = {"steps": steps, "sources": 1,
               "wavelet": {"f0": 10.0, "amp": [0.5, 2.0], "peak_at": [0.03, 0.05]},
               "ic": {"kind": "smooth", "amp": 1e-3 * 64**1.5, "periods": [4.0, 12.0],
                      "terms": 8, "prev_offset": 1e-3}}
    m = inputs.medium(conf, seed, "cpu")
    u_prev, u_cur = inputs.initial_fields(conf, traffic, seed, 0, "cpu")
    coords = inputs.lattice_coords(1, shape, h)
    table = inputs.wavelets(traffic, dt, inputs.rng(seed, inputs.SHOT))
    grid = tt.Grid3D(*shape, hx=h, hy=h, hz=h, order=order)
    sim = tt.Simulator(grid, tt.SimConfig(dt=dt, nsteps=steps), m.numpy(), coords, device="cpu")
    assert sim.engine.sweep_k == 0 and sim.engine.m is not None
    out = sim.extract_state(sim.run(sim.prepare_state(u_prev.numpy(), u_cur.numpy()), table))
    ref = fdtd.run(u_prev, u_cur, m, table, coords, order=order, h=h, dt=dt, nsteps=steps)
    assert len(out) == 3
    numbers = harness.compare([torch.as_tensor(o) for o in out], ref, u_cur,
                              harness.source_boxes(coords, shape, h, order))
    assert max(numbers.values()) < 1e-4, numbers
    assert float((ref[1] - u_cur).norm() / u_cur.norm()) > 1e-3


REHEARSAL = """
import json, sys, time
sys.path.insert(0, {tests!r})
from fdtdbench import harness
from fdtdbench_cells import tiny
out = []
for traced in (False, True):
    cell = tiny({cell!r})
    if traced:  # the profiler records every CPU op of the plain kernels
        cell.traffic["steps"] = 40
    out.append(harness.run_cell(cell, 2**31 + 177, 0.3, traced, "cpu", time.perf_counter()))
print(json.dumps({{"results": out, "loaded": harness.forbidden_modules()}}))
"""


def test_rehearsal_at_a_test_size_loads_no_jax():
    code = REHEARSAL.format(tests=str(ROOT / "fdtdbench" / "tests"), cell=CELL)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    untraced, traced = got["results"]
    for r in (untraced, traced):
        assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(untraced["metrics"]) == {"gcell_per_s", "shot_s_p95", "setup_s"}
    # no device intervals on the CPU: of the four, the program's counter alone
    assert set(traced["metrics"]) == {"medium_setup_ms"}
    assert traced["metrics"]["medium_setup_ms"]["value"] > 0
    assert "medium: " in proc.stderr and "bytes placed on the device" in proc.stderr


def test_exact_ring_readers():
    steps, cells = 2667, 187 * 801 * 801
    shot = trace.Shot(steps=steps, seconds=3.5, levels=3)
    dev = [(KA, 0, 2_400_000.0), (KB, 0, 10.0), ("void at::index_put_kernel", 10, 1010),
           ("Memcpy HtoD (Pinned -> Device)", 2_400_000, 2_500_000)]
    spans = [("shot", 0, 0, 3_500_000), ("run", 0, 0, 2_450_000)]
    r = readings(device=dev, spans=spans, shots=[shot], cells=cells, order=8, medium_bytes=4)
    assert reader("exact_stencil_device_ms_per_step")(r) == pytest.approx(2400.0 / steps)
    least = max(cells * steps * roofline.flops_per_point(8) / 67e12,
                cells * (2 * 3 * 4 + 4) / 3.35e12)
    assert reader("exact_stencil_roofline_pct")(r) == pytest.approx(100 * least / 2.4)
    # the non-stencil kernels of the replay: the injection
    assert reader("exact_inject_device_ms_per_step")(r) == pytest.approx(1.0 / steps)
    no_a = readings(device=dev[1:], spans=spans, shots=[shot], cells=cells, order=8)
    assert reader("exact_stencil_device_ms_per_step")(no_a) is None
    assert reader("exact_stencil_roofline_pct")(no_a) is None


@pytest.mark.parametrize("counts, want", [(Counter(medium_ns=312_500_000, medium_bytes=7),
                                           312.5), (Counter(captures=3), None), (None, None)])
def test_medium_setup_ms(monkeypatch, capsys, counts, want):
    """The program's medium counters, in ms; nothing from a program that
    does not count them (the parent of this cell) or has no tracing."""
    monkeypatch.setattr(program, "tracing", lambda: None if counts is None else
                        types.SimpleNamespace(record=[], counts=counts))
    got = reader("medium_setup_ms")(readings())
    assert got == (None if want is None else pytest.approx(want))
    if want is not None:
        assert "7 bytes placed on the device" in capsys.readouterr().err

"""The harness rehearsed on the CPU at a test-only size: the result line,
the modules a run loads, the refusals, and a traffic mix added as data."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from fdtdbench import harness
from fdtdbench_cells import tiny

ROOT = harness.ROOT

REHEARSAL = """
import json, sys, time
sys.path.insert(0, {tests!r})
from fdtdbench import harness
from fdtdbench_cells import tiny
out = []
for name in {cells!r}:
    for traced in (False, True):
        cell = tiny(name)
        if traced:  # the profiler records every CPU op of the plain kernels
            cell.traffic["steps"] = min(cell.traffic["steps"], 40)
        out.append(harness.run_cell(cell, 2**31 + 77, 0.3, traced, "cpu", time.perf_counter()))
print(json.dumps({{"results": out, "loaded": harness.forbidden_modules()}}))
"""

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_rehearsal_of_every_cell_loads_no_jax():
    code = REHEARSAL.format(tests=str(ROOT / "fdtdbench" / "tests"), cells=CELLS)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "tpufdtd")
    for r in got["results"]:
        assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
        assert list(r)[-1] == "checks"
        assert set(r["checks"]) == {"field_err", "source_err", "step_err"}
    untraced = got["results"][0]
    assert set(untraced["metrics"]) == {"gcell_per_s", "shot_s_p95", "setup_s"}
    assert "host_io_ms_per_shot" in got["results"][1]["metrics"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpufdtd_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxish.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpufdtd.ops", sys)
    assert harness.forbidden_modules() == ["tpufdtd"]


def test_cli_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "fdtdbench.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_cli_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fdtdbench", tmp_path / "fdtdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "fdtdbench.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_traffic_mix_added_as_data_is_picked_up(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fdtdbench", tmp_path / "fdtdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = tmp_path / "fdtdbench"
    mix = json.loads((pkg / "traffic" / "short.json").read_text())
    mix.update(steps=6, sources=8)
    (pkg / "traffic" / "burst8.json").write_text(json.dumps(mix))
    (pkg / "limits" / "ref512-o4.burst8.json").write_text(
        (pkg / "limits" / "ref512-o4.short.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ref512-o4.burst8", "config": "ref512-o4",
                               "traffic": "burst8", "chips": 1, "why": "added as data"})
    for m in bench["per_layer"]:
        m["workloads"].append("ref512-o4.burst8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = tiny("ref512-o4.burst8", root=tmp_path)
    assert cell.traffic["sources"] == 8 and cell.traffic["steps"] == 6
    assert len(cell.per_layer) == len(bench["per_layer"])
    result = harness.run_cell(cell, 4242, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"] is True


def test_same_seed_same_inputs():
    cell = tiny(CELLS[0])
    a, b = harness.Bench(cell, 2**33 + 1, "cpu"), harness.Bench(cell, 2**33 + 1, "cpu")
    c = harness.Bench(cell, 2**33 + 2, "cpu")
    assert all((x == y).all() for x, y in zip(a.pool[0], b.pool[0]))
    assert (a.table(1, 3) == b.table(1, 3)).all()
    assert not (a.pool[0][1] == c.pool[0][1]).all()
    assert a.table(1, 3).shape == c.table(1, 3).shape


@pytest.mark.gpu
def test_a_tiny_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in CELLS:
        result = harness.run_cell(tiny(name, n=32), 5, 0.5, True, "cuda", time.perf_counter())
        assert result["correct"] is True, result
        assert result["device"]["busy_s"] > 0

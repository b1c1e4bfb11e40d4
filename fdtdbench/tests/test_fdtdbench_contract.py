"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, and every cell's files found by name."""

import json
import re
from pathlib import Path

import pytest

from fdtdbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert one_line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for f in ROOT.joinpath("fdtdbench").rglob("*"):
        if "__pycache__" not in f.parts:
            assert PATH.match(str(f.relative_to(ROOT))), f


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])


def test_end_to_end_metrics_are_the_four():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert names == {"gcell_per_s", "shot_s_p95", "peak_device_gib", "setup_s"}
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]["bound"] == 0.25


def test_per_layer_moves_a_metric_each_listed_cell_reports():
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS), m["name"]
        for cell in m["workloads"]:
            reported = {e["name"] for e in harness.load_cell(cell).end_to_end}
            assert m["moves"] in reported, (m["name"], cell)


def test_each_layer_name_is_spelled_one_way():
    by_prefix = {}
    for m in BENCH["per_layer"]:
        by_prefix.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell.limits, f"{name} has no limits file"
    pkg = cell.pkg
    assert (pkg / "media" / f"{cell.config['medium']['kind']}.py").is_file()
    assert (pkg / "ics" / f"{cell.traffic['ic']['kind']}.py").is_file()
    for m in cell.per_layer:
        assert (pkg / "metrics" / f"{m['name']}.py").is_file()
    readings = json.loads((pkg / "limits" / f"{name}.json").read_text())
    assert set(readings["limits"]) == {"field_err", "source_err", "step_err"}


def test_config_files_are_their_own_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert any(Path(c["file"]).parts[0] == p for p in BENCH["paths"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)

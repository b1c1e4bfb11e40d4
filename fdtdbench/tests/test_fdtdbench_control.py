"""The comparison fails what it has to fail, at a test-only size on the
CPU: the control (the program's own bfloat16 storage, the precision below
the configuration's float32) and the faults a cell can have, planted in
the program under a full run of the harness. The exchange between cards is
no fault of these one-card cells; a level returned in the wrong role is
one more."""

import json
import time

import pytest

from fdtdbench import harness, inputs
from fdtdbench_cells import tiny

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [7, 2**31 + 11, 99991])
def test_the_control_fails_and_the_program_passes(name, seed):
    cell = tiny(name)
    numbers = {}
    for storage in (None, "bfloat16"):
        bench = harness.Bench(cell, seed, "cpu", storage)
        table = bench.table(inputs.SHOT, 0)
        _, out = bench.shot(0, table)
        bench.free()
        numbers[storage] = harness.check_shot(bench, 0, out)
    assert harness.judge(numbers[None], cell.limits), numbers
    assert not harness.judge(numbers["bfloat16"], cell.limits), numbers


def run(cell):
    return harness.run_cell(cell, 31337, 0.2, False, "cpu", time.perf_counter())


def unchanged(monkeypatch):
    import tpufdtd_torch.stepper as st

    monkeypatch.setattr(st.CudaEngine, "run_scan", lambda self, state, *a, **k: state)


def half_the_sources(monkeypatch):
    """Every other source left out: a one-source shot loses its source."""
    import tpufdtd_torch.stepper as st

    real = st.Simulator._src_rows

    def rows(self, src, t0, t1):
        r = real(self, src, t0, t1)
        r[:, ::2] = 0.0
        return r

    monkeypatch.setattr(st.Simulator, "_src_rows", rows)


def a_source_mis_scaled(monkeypatch):
    """Every source's wavelet injected 10 % too strong."""
    import tpufdtd_torch.stepper as st

    real = st.Simulator._src_rows
    monkeypatch.setattr(st.Simulator, "_src_rows",
                        lambda self, src, t0, t1: real(self, src, t0, t1) * 1.1)


def an_answer_altered(monkeypatch):
    """u_N returned with its values around the first source negated."""
    import tpufdtd_torch.stepper as st

    real = st.CudaEngine.extract_state

    def extract(self, state):
        out = real(self, state)
        ix, iy, iz = (int(a[0]) for a in (self.term.ix, self.term.iy, self.term.iz))
        out[1][ix - 2:ix + 3, iy - 2:iy + 3, iz - 2:iz + 3] *= -1.0
        return out

    monkeypatch.setattr(st.CudaEngine, "extract_state", extract)


def levels_swapped(monkeypatch):
    """u_{N-1} and u_N returned in each other's roles."""
    import tpufdtd_torch.stepper as st

    real = st.CudaEngine.extract_state
    monkeypatch.setattr(st.CudaEngine, "extract_state",
                        lambda self, state: tuple(real(self, state))[1::-1])


FAULTS = {"unchanged": unchanged, "half_the_sources": half_the_sources,
          "a_source_mis_scaled": a_source_mis_scaled, "an_answer_altered": an_answer_altered,
          "levels_swapped": levels_swapped}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_run_with_a_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny(name)  # its sound runs are correct: test_fdtdbench_harness
    FAULTS[fault](monkeypatch)
    result = run(cell)
    assert result["correct"] is False and result["failed"] >= 1, result["checks"]


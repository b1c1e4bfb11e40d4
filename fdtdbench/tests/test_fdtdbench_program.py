"""The readers of the program's own spans and counters on synthetic
readings: a record of the program's spans on its host clock, the benchmark's
ranges and the device's intervals on the profiler's."""

import types
from collections import Counter

import pytest

from fdtdbench import inputs, program, trace
from test_fdtdbench_metrics import PKG, readings

LEVEL = 512**3 * 4
OFFSET_NS = 7_000_000_000  # the program's clock ahead of the profiler's, in ns


def reader(name):
    return inputs.load(PKG / "metrics" / f"{name}.py").read


def shot_record(t0_us: float, stage_us: float = 100.0):
    """One fast-ring shot's program spans from profiler time t0_us, in the
    record's form (in the order they ended, on the program's clock) and
    the benchmark's ranges around its three calls."""
    at = lambda us: int((t0_us + us) * 1e3) + OFFSET_NS  # noqa: E731
    spans = [("rims", 10, 30, 0), ("stage", 30, 30 + stage_us, LEVEL),
             ("h2d", 130, 200, LEVEL), ("stage", 200, 200 + stage_us, LEVEL),
             ("h2d", 300, 370, LEVEL), ("assemble", 370, 390, 0), ("prepare_state", 5, 395, 0),
             ("load", 402, 403, 0), ("replay", 403, 410, 0), ("run", 401, 411, 0),
             ("d2h", 1004, 1100, LEVEL), ("d2h", 1100, 1200, LEVEL),
             ("extract_state", 1002, 1201, 0)]
    record = [(n, at(a), at(b), nb) for n, a, b, nb in spans]
    bench = [("prepare", t0_us + 4, t0_us + 398), ("run", t0_us + 400, t0_us + 1000),
             ("extract", t0_us + 1001, t0_us + 1205)]
    return record, bench


def two_shots(monkeypatch, captures=17):
    record, bench = [], []
    for i, t0 in enumerate((0.0, 2000.0)):
        rec, b = shot_record(t0)
        record += rec
        bench += [(kind, i, a, z) for kind, a, z in b] + [("shot", i, t0 + 3, t0 + 1206)]
    counts = Counter(captures=captures, evictions=9)
    monkeypatch.setattr(program, "tracing",
                        lambda: types.SimpleNamespace(record=record, counts=counts))
    device = []
    for t0 in (0.0, 2000.0):
        device += [("Memcpy HtoD (Pageable -> Device)", t0 + 140, t0 + 190),
                   ("Memcpy HtoD (Pageable -> Device)", t0 + 310, t0 + 360),
                   ("Memcpy HtoD (Pageable -> Device)", t0 + 402.2, t0 + 402.4),  # load
                   ("void sweep::kernel<2, 2, true, float, false>", t0 + 420, t0 + 990),
                   ("Memcpy DtoH (Device -> Pageable)", t0 + 1010, t0 + 1090),
                   ("Memcpy DtoH (Device -> Pageable)", t0 + 1110, t0 + 1190)]
    shots = [trace.Shot(steps=50, seconds=1.0, capture_s=c, nodes=1650, graph_steps=50)
             for c in (0.0, 0.2, 0.0)]
    return readings(device=device, spans=bench, shots=shots, traced_shots=[0, 1])


def test_spans_put_on_the_profilers_clock(monkeypatch):
    r = two_shots(monkeypatch)
    sp = program.spans(r)
    assert len(sp) == 26 and {i for _n, i, *_ in sp} == {0, 1}
    # the largest start difference is prepare's (4 - 5 us): the program's spans land 1 us early
    prep = [s for s in sp if s[0] == "prepare_state"]
    assert [(a, b) for _n, _i, a, b, _nb in prep] == [pytest.approx((4, 394)),
                                                      pytest.approx((2004, 2394))]


def test_host_stage_is_the_self_time_of_stage_and_rims(monkeypatch):
    r = two_shots(monkeypatch)
    assert reader("host_stage_ms_per_shot")(r) == pytest.approx((2 * 100 + 20) * 1e-3)
    own = program.self_us(program.spans(r))
    assert own["prepare_state"] == pytest.approx(2 * (390 - 20 - 200 - 140 - 20))
    assert own["run"] == pytest.approx(2 * (10 - 1 - 7))


def test_transfer_rates(monkeypatch):
    r = two_shots(monkeypatch)
    # the source table's copy lands in run, not in prepare_state
    assert reader("h2d_gb_per_s")(r) == pytest.approx(4 * LEVEL / (200e-6) / 1e9)
    assert reader("d2h_gb_per_s")(r) == pytest.approx(4 * LEVEL / (320e-6) / 1e9)


def test_setup_captures_leave_out_the_windows(monkeypatch, capsys):
    r = two_shots(monkeypatch, captures=17)
    assert reader("setup_captures")(r) == 16
    assert "captures in the window 1, evictions in the process 9" in capsys.readouterr().err


def test_idle_gaps_named_by_the_innermost_program_span(monkeypatch):
    r = two_shots(monkeypatch)
    gaps = program.idle_gaps(r, program.spans(r), captured={1}, top=20)
    for i in (0, 1):
        # 190-310 us of each shot: the second level's host copy
        assert (f"prepare (shot {i}) / tpufdtd_torch.stage", pytest.approx(120e-6)) in gaps
        assert (f"extract (shot {i}) / tpufdtd_torch.d2h", pytest.approx(20e-6)) in gaps
    # a gap outside the program's spans keeps the benchmark's name alone
    assert ("capture+replay (shot 1)", pytest.approx(17.6e-6)) in gaps
    assert gaps[0] == ("between shots", pytest.approx((2140 - 1190) * 1e-6))
    assert len(program.idle_gaps(r, program.spans(r), set())) == 10


def test_readers_silent_without_the_program_record_or_bytes(monkeypatch):
    monkeypatch.setattr(program, "tracing", lambda: None)
    r = readings(shots=[trace.Shot(steps=50, seconds=1.0, nodes=10, graph_steps=50)])
    for name in ("host_stage_ms_per_shot", "h2d_gb_per_s", "d2h_gb_per_s", "setup_captures"):
        assert reader(name)(r) is None
    # a record of other shots than those traced is not read
    monkeypatch.setattr(program, "tracing", lambda: types.SimpleNamespace(
        record=shot_record(0.0)[0], counts=Counter()))
    assert program.spans(readings(traced_shots=[0, 1])) is None
    # on a CPU device nothing moves and nothing is captured
    rec = [(n, a, b, 0 if n in ("h2d", "d2h") else nb) for n, a, b, nb in shot_record(0.0)[0]]
    monkeypatch.setattr(program, "tracing",
                        lambda: types.SimpleNamespace(record=rec, counts=Counter()))
    r = readings(spans=[(k, 0, a, b) for k, a, b in shot_record(0.0)[1]],
                 shots=[trace.Shot(steps=50, seconds=1.0)])
    assert reader("h2d_gb_per_s")(r) is None and reader("d2h_gb_per_s")(r) is None
    assert reader("setup_captures")(r) is None
    assert reader("host_stage_ms_per_shot")(r) == pytest.approx(0.22)


def test_the_programs_tracing_module_is_found():
    from tpufdtd_torch.utils import tracing

    assert program.tracing() is tracing
    assert program.PREFIX == tracing.PREFIX

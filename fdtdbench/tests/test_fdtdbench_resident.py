"""The reader of the program's made-ahead counters on synthetic counts."""

import types
from collections import Counter

import pytest

from fdtdbench import inputs, program, trace
from test_fdtdbench_metrics import PKG, readings


def reader(name):
    return inputs.load(PKG / "metrics" / f"{name}.py").read


def test_extract_resident_share(monkeypatch, capsys):
    counts = Counter(staged_bytes=8 * 10**9, resident_levels=27, resident_waits=2,
                     fresh_levels=1)
    monkeypatch.setattr(program, "tracing",
                        lambda: types.SimpleNamespace(record=[], counts=counts))
    assert reader("extract_resident_share")(readings()) == pytest.approx(0.9)
    assert ("extracted levels in the process: 27 resident_levels, 2 resident_waits,"
            " 1 fresh_levels") in capsys.readouterr().err
    counts["resident_levels"] = 0
    assert reader("extract_resident_share")(readings()) == 0.0


@pytest.mark.parametrize("counts", [None, Counter(), Counter(captures=5, staged_bytes=10**9)])
def test_extract_resident_share_silent_without_counts(monkeypatch, capsys, counts):
    """The parent program, a CPU device or no program tracing: nothing read."""
    monkeypatch.setattr(program, "tracing", lambda: None if counts is None else
                        types.SimpleNamespace(record=[], counts=counts))
    r = readings(shots=[trace.Shot(steps=50, seconds=1.0)])
    assert reader("extract_resident_share")(r) is None
    assert capsys.readouterr().err == ""

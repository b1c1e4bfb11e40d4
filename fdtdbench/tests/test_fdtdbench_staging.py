"""The reader of the program's staging counters on synthetic counts."""

import types
from collections import Counter

import pytest

from fdtdbench import inputs, program, trace
from test_fdtdbench_metrics import PKG, readings


def reader(name):
    return inputs.load(PKG / "metrics" / f"{name}.py").read


def test_staging_waits_per_gb(monkeypatch, capsys):
    counts = Counter(captures=3, staged_bytes=8 * 10**9, staging_waits=12)
    monkeypatch.setattr(program, "tracing",
                        lambda: types.SimpleNamespace(record=[], counts=counts))
    assert reader("staging_waits_per_gb")(readings()) == pytest.approx(1.5)
    assert f"staged {8 * 10**9} bytes in the process, 12 waits" in capsys.readouterr().err
    counts["staging_waits"] = 0
    assert reader("staging_waits_per_gb")(readings()) == 0.0


@pytest.mark.parametrize("counts", [None, Counter(), Counter(captures=5)])
def test_staging_waits_silent_without_staged_bytes(monkeypatch, counts):
    """The parent program, a CPU device or no program tracing: nothing read."""
    monkeypatch.setattr(program, "tracing", lambda: None if counts is None else
                        types.SimpleNamespace(record=[], counts=counts))
    r = readings(shots=[trace.Shot(steps=50, seconds=1.0)])
    assert reader("staging_waits_per_gb")(r) is None

"""Host arrays made ahead of extract_state (stepper.Resident) on the CPU: a
set hands out each array once, apart from every other; a set of another
shape or count, or a helper that fails, falls back to a fresh array; the
helper ends with its Resident; and through an engine made to stage as on a
card, extract_state's arrays stay apart from the slots, from each other and
from the last shot's, while the three counters add up to the levels
extracted. Off the card nothing of it runs."""

import gc
import sys
import threading
import weakref
from collections import Counter

import numpy as np
import pytest
import torch

import tpufdtd_torch as tt
from tpufdtd_torch import stepper
from tpufdtd_torch.stepper import Resident, Staging
from tpufdtd_torch.utils import tracing

SHAPE = (6, 7, 1100)  # a level of several pages, the last one partly used
RESIDENT = ("resident_levels", "resident_waits", "fresh_levels")


def _taken() -> Counter:
    return Counter({k: tracing.counts[k] for k in RESIDENT if tracing.counts[k]})


def _made(r: Resident, timeout: float = 10.0) -> None:
    """Wait until the helper has made every array of the pending set."""
    assert all(ev.wait(timeout) for ev in r._set.ready)


def _apart(arrays) -> bool:
    return not any(np.shares_memory(a, b) for i, a in enumerate(arrays) for b in arrays[i + 1:])


@pytest.mark.parametrize("count", [1, 2, 3])
def test_a_set_hands_out_each_array_once(count):
    r = Resident()
    tracing.reset_counts()
    r.expect(SHAPE, count)
    _made(r)
    got = [r.take(SHAPE) for _ in range(count)]
    assert all(a.shape == SHAPE and a.dtype == np.float32 for a in got)
    assert all(a.flags.owndata and a.flags.writeable and a.flags.c_contiguous for a in got)
    assert _apart(got)
    assert r.take(SHAPE) is None  # the set is spent: the next level is fresh
    assert _taken() == Counter(resident_levels=count, fresh_levels=1)


def test_a_take_before_the_helper_is_done_waits_for_its_level():
    """A level the helper has not made yet is waited for, counted apart."""
    gate = threading.Event()

    class Slow(Resident):
        @staticmethod
        def touch(a):
            assert gate.wait(10.0)
            Resident.touch(a)

    r = Slow()
    tracing.reset_counts()
    r.expect(SHAPE, 1)
    threading.Timer(0.05, gate.set).start()
    a = r.take(SHAPE)
    assert a is not None and a.shape == SHAPE
    assert _taken() == Counter(resident_waits=1)


def test_a_matching_pending_set_is_kept():
    r = Resident()
    r.expect(SHAPE, 2)
    first = r._set
    r.expect(SHAPE, 2)
    assert r._set is first and not first.cancelled


@pytest.mark.parametrize("case", ["no_set", "other_shape", "more_levels", "other_count",
                                  "partly_taken"])
def test_a_shape_or_count_mismatch_falls_back(case):
    """Levels with no matching array made ahead go into fresh arrays and
    count as fresh_levels; a pending set of another count, or one already
    partly taken, is replaced by the set asked for."""
    r = Resident()
    other = (SHAPE[0] + 1, *SHAPE[1:])
    tracing.reset_counts()
    if case == "no_set":
        assert r.take(SHAPE) is None and r._thread is None
        assert _taken() == Counter(fresh_levels=1)
        return
    r.expect(SHAPE, 2)
    _made(r)
    if case == "other_shape":
        assert r.take(other) is None
        assert r._set.taken == 0  # the set waits for a level of its shape
        assert r.take(SHAPE) is not None
        assert _taken() == Counter(fresh_levels=1, resident_levels=1)
    elif case == "more_levels":
        got = [r.take(SHAPE) for _ in range(3)]
        assert got[2] is None and _apart(got[:2])
        assert _taken() == Counter(resident_levels=2, fresh_levels=1)
    else:
        first = r._set
        if case == "partly_taken":
            assert r.take(SHAPE) is not None
        r.expect(SHAPE, 3 if case == "other_count" else 2)
        assert r._set is not first and first.cancelled
        _made(r)
        got = [r.take(SHAPE) for _ in range(4)]
        n = 3 if case == "other_count" else 2
        assert all(a is not None for a in got[:n]) and all(a is None for a in got[n:])
        kept = 1 if case == "partly_taken" else 0
        assert _taken() == Counter(resident_levels=n + kept, fresh_levels=4 - n)


@pytest.mark.parametrize("fail_at", [0, 1])
def test_a_failing_helper_falls_back_and_leaks_nothing(fail_at):
    """An exception on the helper (a MemoryError) ends its set there: the
    levels before it are handed out, the rest fall back to fresh arrays with
    a warning, the array it was touching is freed, and the helper makes the
    next set."""
    made = []

    class Failing(Resident):
        fail = True

        @staticmethod
        def touch(a):
            made.append(weakref.ref(a))
            if Failing.fail and len(made) == fail_at + 1:
                raise MemoryError("no room for the level")
            Resident.touch(a)

    r = Failing()
    tracing.reset_counts()
    r.expect(SHAPE, 3)
    _made(r)
    with pytest.warns(RuntimeWarning, match="MemoryError"):
        got = [r.take(SHAPE) for _ in range(3)]
    assert [a is None for a in got] == [i >= fail_at for i in range(3)]
    assert len(made) == fail_at + 1  # nothing made after the failure
    gc.collect()
    assert made[fail_at]() is None  # the failed level's array is gone
    assert _taken() == Counter(resident_levels=fail_at, fresh_levels=3 - fail_at)
    Failing.fail = False
    r.expect(SHAPE, 1)
    _made(r)
    assert r.take(SHAPE) is not None and r._thread.is_alive()


def test_the_helper_ends_with_its_resident():
    r = Resident()
    assert r._thread is None  # no thread before the first set
    r.expect(SHAPE, 1)
    thread = r._thread
    assert thread.daemon and thread.is_alive()
    _made(r)
    del r
    gc.collect()
    thread.join(10.0)
    assert not thread.is_alive()


def test_sets_replaced_under_a_short_switch_interval_hand_out_distinct_arrays():
    """Many Residents, more than cores, each replacing and taking sets while
    its helper makes them, with threads switching every microsecond: every
    array handed out is apart from the others its caller holds, and a take
    never returns a cancelled set's array."""
    old = sys.getswitchinterval()
    failures = []

    def caller(seed):
        rng = np.random.default_rng(seed)
        r, held = Resident(), []
        shape = (2, 3, 2000)
        for _ in range(40):
            r.expect(shape, int(rng.integers(1, 4)))
            for _ in range(int(rng.integers(0, 4))):
                a = r.take(shape)
                if a is not None:
                    held.append(a)
        if not _apart(held) or any(a.shape != shape for a in held):
            failures.append(seed)

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=caller, args=(s,)) for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not failures


# -- through an engine that stages as on a card -------------------------------------------


def _sim(ring: str, storage: str, monkeypatch):
    """A CPU Simulator whose engine takes the card's path: staging slots
    (two small ones) and arrays made ahead."""
    monkeypatch.setattr(stepper._Engine, "on_card", property(lambda self: True))
    g = tt.Grid3D(12, 16, 20, hx=1.0, hy=1.0, hz=1.0)
    cfg = tt.SimConfig(dt=0.001, nsteps=4, backend="cuda", ring=ring, storage_dtype=storage)
    sim = tt.Simulator(g, cfg, np.full(g.padded_shape, 1.5, np.float32),
                       np.array([[6.0, 8.0, 10.0]], np.float32), device="cpu")
    sim.engine.staging = Staging(sim.device, sim.engine.dtype, slots=2, slot_bytes=4096)
    return sim


def _pair(sim, seed: int):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(sim.grid.padded_shape).astype(np.float32)
    u[2:-2, 2:-2, 2:-2] = 0.0
    return u, u.copy()


def _levels(state):
    return list(state["sweep"][0]) if isinstance(state, dict) else list(state)


@pytest.mark.parametrize("ring, storage, levels", [("auto", "float32", 2), ("exact", "float32", 3),
                                                   ("auto", "bfloat16", 2)])
def test_extracted_arrays_are_apart_and_bitwise_the_state(ring, storage, levels, monkeypatch):
    """Two shots: each extract_state takes the set its prepare_state asked
    for; its arrays are bitwise the state's levels, owned by the caller and
    apart from each other, from the slots and from the last shot's."""
    sim = _sim(ring, storage, monkeypatch)
    tracing.reset_counts()
    shots = []
    for seed in (1, 2):
        state = sim.run(sim.prepare_state(*_pair(sim, seed)), tt.ricker_table(4, 1, 0.001))
        out = sim.extract_state(state)
        assert len(out) == levels
        assert all(o.tobytes() == x.float().numpy().tobytes() for o, x in zip(out, _levels(state)))
        shots.append(out)
    arrays = [a for out in shots for a in out]
    assert all(a.flags.owndata and a.flags.writeable for a in arrays)
    assert _apart(arrays)
    slots = [s.view(torch.uint8).numpy() for s in sim.engine.staging.slots]
    assert not any(np.shares_memory(a, s) for a in arrays for s in slots)
    kept = [a.copy() for a in shots[0]]
    sim.extract_state(sim.prepare_state(*_pair(sim, 3)))
    assert all(a.tobytes() == k.tobytes() for a, k in zip(shots[0], kept))
    c = _taken()
    assert c["fresh_levels"] == 0 and c["resident_levels"] + c["resident_waits"] == 3 * levels


def test_counters_add_up_to_the_levels_extracted(monkeypatch):
    """Prepares and extracts out of step, as checkpoint.py and a caller
    holding two states make them: every level extracted is counted once, and
    a level with no set pending is fresh."""
    sim = _sim("auto", "float32", monkeypatch)
    tracing.reset_counts()
    a = sim.prepare_state(*_pair(sim, 4))
    b = sim.prepare_state(*_pair(sim, 5))  # the set asked for by `a` is kept
    n = len(sim.extract_state(a)) + len(sim.extract_state(a)) + len(sim.extract_state(b))
    exact = sim.prepare_state(*_pair(sim, 6)[:1], _pair(sim, 6)[0] * 0)  # rims differ: exact
    assert not isinstance(exact, dict)
    n += len(sim.extract_state(exact))
    c = _taken()
    assert sum(c.values()) == n == 9
    assert c["fresh_levels"] == 4 and c["resident_levels"] + c["resident_waits"] == 5


@pytest.mark.parametrize("ring", ["auto", "exact"])
def test_off_the_card_nothing_is_made_ahead(ring):
    g = tt.Grid3D(12, 16, 20, hx=1.0, hy=1.0, hz=1.0)
    sim = tt.Simulator(g, tt.SimConfig(dt=0.001, nsteps=4, backend="cuda", ring=ring),
                       np.full(g.padded_shape, 1.5, np.float32), device="cpu")
    rng = np.random.default_rng(7)
    u = rng.standard_normal(g.padded_shape).astype(np.float32)
    threads = threading.active_count()
    tracing.reset_counts()
    out = sim.extract_state(sim.prepare_state(u, u))
    assert len(out) == (2 if ring == "auto" else 3)
    assert not tracing.counts and threading.active_count() == threads
    assert "resident" not in vars(sim.engine) and "staging" not in vars(sim.engine)

"""Profiling and tracing hooks.

The reference instruments with host wall-time section macros, cudaEvents
and nsys/ncu recipes (SURVEY.md §5). Here:
  * `sync(x)`: the completion fence, torch.cuda.synchronize on the devices
    of the CUDA tensors in x; nothing for CPU tensors;
  * `trace(logdir)`: a torch.profiler context (CPU and, with a card, CUDA
    activities) that writes a Chrome trace to logdir/trace.json, the nsys
    analogue; nothing when logdir is None;
  * `device_busy_us(prof)`: the time the device spent in kernels and copies
    over a traced window, the union of their intervals;
  * `span(name, nbytes)`: the program's own range `tpufdtd_torch.<name>`
    around a host call (the reference's START/STOP macro pair,
    openacc.cpp:2-3), on the profiler's clock while one runs;
  * `counts`: the process's graph `captures` and `evictions`, the
    bytes its levels moved through the card's staging slots
    (`staged_bytes`) and the times a slot's transfer was not done when the
    host came back to it (`staging_waits`), the levels extract_state took
    from a card into an array made ahead and ready (`resident_levels`),
    made ahead but waited for (`resident_waits`) or made then
    (`fresh_levels`), and the bytes of the per-point
    media its engines placed on their devices (`medium_bytes`) with the
    host nanoseconds that took, uniformity scans included (`medium_ns`),
    with `reset_counts()`;
  * `record`: the spans entered while a profiler ran, with the bytes each
    moved, for a reader that does not hold the profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter
from typing import Optional

import torch

PREFIX = "tpufdtd_torch"  # the program's ranges: tpufdtd_torch.<span name>

counts = Counter()
# while a profiler runs, one (name, start_ns, end_ns, nbytes) per span, in the
# order the spans ended, on time.perf_counter_ns
record = []


def reset_counts() -> None:
    counts.clear()
    record.clear()


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x) -> None:
    """Wait for the devices of the CUDA tensors in x (a tensor, or nested
    tuples, lists and dicts of them, as a Simulator state); CPU tensors
    need no fence."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """torch.profiler over the block; yields the profiler (None when logdir
    is None, which traces nothing). The Chrome trace goes to
    logdir/trace.json."""
    if logdir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_busy_us(prof) -> float:
    """Microseconds in which the device ran at least one kernel, copy or
    memset during the traced window: the union of the device events'
    intervals (kernels on two streams overlap and count once)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


@contextlib.contextmanager
def span(name: str, nbytes: int = 0):
    """The block as the program's range `tpufdtd_torch.<name>`; `nbytes`, what
    it moves, goes with it to `record`. Without a profiler running the range
    is not opened and nothing is recorded. It is a FUNCTION-scope range, not
    torch.profiler.record_function's user scope: a user range is mirrored on
    the device's timeline as an annotation over the kernels it launched, which
    a reader of device intervals would count as device work. Never
    synchronizes.

    Both names used here are torch's private ones (torch 2.11); a torch that
    renames them fails tests/test_torch_tracing.py."""
    if not torch.autograd._profiler_enabled():
        yield
        return
    t0 = time.perf_counter_ns()
    with torch._C._profiler._RecordFunctionFast(f"{PREFIX}.{name}"):
        yield
    record.append((name, t0, time.perf_counter_ns(), nbytes))

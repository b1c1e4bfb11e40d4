"""Profiling and tracing hooks.

The reference instruments with host wall-time section macros, cudaEvents
and nsys/ncu recipes (SURVEY.md §5). Here:
  * `sync(x)`: the completion fence, torch.cuda.synchronize on the devices
    of the CUDA tensors in x; nothing for CPU tensors;
  * `trace(logdir)`: a torch.profiler context (CPU and, with a card, CUDA
    activities) that writes a Chrome trace to logdir/trace.json, the nsys
    analogue; nothing when logdir is None;
  * `timed_section(timers, name, fence)`: wall time into timers[name], the
    reference's START/STOP macro pair (openacc.cpp:2-3);
  * `device_busy_us(prof)`: the time the device spent in kernels and copies
    over a traced window, the union of their intervals.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


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
def timed_section(timers: Dict[str, float], name: str, fence=None):
    """Add the block's wall time to timers[name]; `fence` (tensors) is
    synced before and after, so the time covers the device work."""
    if fence is not None:
        sync(fence)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if fence is not None:
            sync(fence)
        timers[name] = timers.get(name, 0.0) + time.perf_counter() - t0

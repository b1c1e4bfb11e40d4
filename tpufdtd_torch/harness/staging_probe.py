"""Slot count and size for stepper.Staging, on a card: one level of 512^3
at order 4 (f32) to the card and back through staging slots of each
(count, MiB) asked for, against the copies without slots and the bare
rates, in one process.

    python3 -m tpufdtd_torch.harness.staging_probe [--slots 2 3 4] [--mib 8 16 32 64]
        [--repeat 5] [--json PATH]

Prints one line a setting: the median ms of `to_device` (ending in a
synchronize) and of `to_host` (which returns when the array is filled),
their GB/s, and the waits a level (tracing.counts' staging_waits); then the
copies without slots (a host copy and a pageable `.to`, a pageable
`.cpu()`), a pinned buffer of the whole level each way (the link's rate)
and a host copy of the whole level from pinned memory into fresh and into
warm pages. Each level returned by `to_host` in those rows is a fresh
array.

Then, through the engine's own slots (STAGING_SLOTS x STAGING_SLOT_BYTES),
the arrays a stepper.Resident makes ahead, with each way of faulting their
pages in (TOUCHES: on the helper thread alone, or spread over torch's
intra-op threads): the ms a level takes the helper; `to_host` into its
array once the helper is done, and at once after `expect` (the wait
included); `to_device` of two levels while the helper makes two, against
`to_device` alone; and a short shot's host side (two levels in, 40 ms of a
card's run, two levels out) with the arrays made ahead and with fresh ones.
"""

from __future__ import annotations

import argparse
import json
import mmap
import statistics
import subprocess
import time

import numpy as np
import torch

from .. import Grid3D
from ..stepper import STAGING_SLOT_BYTES, STAGING_SLOTS, Resident, Staging
from ..utils import tracing


def _touch_intra_op(a: np.ndarray) -> None:
    """One element a page written by torch, over its intra-op threads: the
    alternative to Resident.touch, which writes them on the helper alone."""
    flat = torch.from_numpy(a).view(-1)
    flat[:: mmap.PAGESIZE // a.itemsize].zero_()
    flat[-1:].zero_()


# the ways a Resident's helper may fault in its arrays' pages
TOUCHES = {"helper": Resident.touch, "intra_op": _touch_intra_op}


def _timed(fn, repeat: int) -> float:
    """The median seconds of fn() over `repeat` calls, after one untimed."""
    fn()
    secs = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--slots", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--mib", type=int, nargs="+", default=[8, 16, 32, 64])
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--json", default=None, help="write the results here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("staging_probe needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    shape = Grid3D(512, 512, 512, order=4).padded_shape
    rng = np.random.default_rng(0)
    u = rng.standard_normal(shape, dtype=np.float32)
    nbytes = u.nbytes
    dst = torch.empty(shape, device=dev)
    print(f"card {card}; torch {torch.__version__}, {torch.get_num_threads()} host threads;"
          f" level {shape} f32, {nbytes / 1e6:.1f} MB", flush=True)
    rows = []

    def sync():
        torch.cuda.synchronize(dev)

    for slots in args.slots:
        for mib in args.mib:
            st = Staging(dev, torch.float32, slots=slots, slot_bytes=mib << 20)

            def put():
                st.to_device(u, dst)
                sync()

            put_s = _timed(put, args.repeat)
            get_s = _timed(lambda: st.to_host(dst), args.repeat)
            tracing.reset_counts()
            put()
            st.to_host(dst)
            waits = tracing.counts["staging_waits"] / 2
            if not np.array_equal(st.to_host(dst), u):
                raise RuntimeError(f"slots {slots} x {mib} MiB: the level came back changed")
            row = {"slots": slots, "mib": mib, "to_device_ms": put_s * 1e3,
                   "to_host_ms": get_s * 1e3, "h2d_gb_per_s": nbytes / put_s / 1e9,
                   "d2h_gb_per_s": nbytes / get_s / 1e9, "waits_per_level": waits}
            rows.append(row)
            print(f"slots {slots} x {mib} MiB: to_device {row['to_device_ms']:.2f} ms"
                  f" ({row['h2d_gb_per_s']:.2f} GB/s), to_host {row['to_host_ms']:.2f} ms"
                  f" ({row['d2h_gb_per_s']:.2f} GB/s), waits a level {waits}", flush=True)
            del st

    def put_plain():
        dst.copy_(torch.tensor(u).to(torch.float32).to(dev))
        sync()

    pinned = torch.empty(shape, pin_memory=True)
    pinned.copy_(torch.from_numpy(u))

    def put_pinned():
        dst.copy_(pinned, non_blocking=True)
        sync()

    def get_pinned():
        pinned.copy_(dst, non_blocking=True)
        sync()

    warm = torch.empty(shape)
    bare = {
        "unstaged_to_device_ms": _timed(put_plain, args.repeat) * 1e3,
        "unstaged_to_host_ms": _timed(lambda: dst.cpu().numpy(), args.repeat) * 1e3,
        "pinned_level_h2d_ms": _timed(put_pinned, args.repeat) * 1e3,
        "pinned_level_d2h_ms": _timed(get_pinned, args.repeat) * 1e3,
        "host_copy_level_fresh_ms": _timed(
            lambda: torch.from_numpy(np.empty(shape, np.float32)).copy_(pinned),
            args.repeat) * 1e3,
        "host_copy_level_warm_ms": _timed(lambda: warm.copy_(pinned), args.repeat) * 1e3,
    }
    for k, v in bare.items():
        print(f"{k} {v:.2f}", flush=True)
    del pinned, warm
    ahead = _made_ahead(dev, shape, u, dst, args.repeat)
    for k, v in ahead.items():
        print(f"{k} {v:.2f}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "threads": torch.get_num_threads(), "level_bytes": nbytes,
                       "settings": rows, "bare": bare, "made_ahead": ahead}, f, indent=1)
    return 0


def _made_ahead(dev, shape, u, dst, repeat: int) -> dict:
    """The Resident rows (the module's docstring), in ms, for each TOUCHES."""
    st = Staging(dev, torch.float32, STAGING_SLOTS, STAGING_SLOT_BYTES)
    dst2 = torch.empty_like(dst)

    def put():
        st.to_device(u, dst)
        st.to_device(u, dst2)
        torch.cuda.synchronize(dev)

    def shot(r):
        if r is not None:
            r.expect(shape, 2)
        put()
        time.sleep(0.04)  # the card's run, which the helper overlaps
        for x in (dst, dst2):
            st.to_host(x, out=None if r is None else r.take(shape))

    out = {"to_device_2_levels_alone_ms": _timed(put, repeat) * 1e3,
           "short_shot_fresh_ms": _timed(lambda: shot(None), repeat) * 1e3}
    for name, touch in TOUCHES.items():
        r = type(f"Resident_{name}", (Resident,), {"touch": staticmethod(touch)})()

        def made():
            r.expect(shape, 1)
            r._set.ready[0].wait()
            return r.take(shape)

        def ready_then_to_host():
            a = made()
            t0 = time.perf_counter()
            st.to_host(dst, out=a)
            return time.perf_counter() - t0

        def put_while_making():
            r.expect(shape, 2)
            t0 = time.perf_counter()
            put()
            secs = time.perf_counter() - t0
            r.take(shape), r.take(shape)  # waits for the helper: the next row starts idle
            return secs

        def median(fn):
            fn()
            return statistics.median(fn() for _ in range(repeat)) * 1e3

        out[f"{name}_fault_in_level_ms"] = _timed(made, repeat) * 1e3
        out[f"{name}_to_host_ready_ms"] = median(ready_then_to_host)
        out[f"{name}_to_host_unfinished_ms"] = _timed(
            lambda: (r.expect(shape, 1), st.to_host(dst, out=r.take(shape))), repeat) * 1e3
        out[f"{name}_to_device_2_levels_while_making_ms"] = median(put_while_making)
        out[f"{name}_short_shot_ms"] = _timed(lambda: shot(r), repeat) * 1e3
        if not np.array_equal(st.to_host(dst, out=made()), u):
            raise RuntimeError(f"{name}: the level came back changed")
        del r
    return out


if __name__ == "__main__":
    raise SystemExit(main())

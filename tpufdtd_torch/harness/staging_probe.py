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
warm pages. Each level returned by `to_host` is a fresh array, as
extract_state's are.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from .. import Grid3D
from ..stepper import Staging
from ..utils import tracing


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
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "threads": torch.get_num_threads(), "level_bytes": nbytes,
                       "settings": rows, "bare": bare}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""One run of one cell of the benchmark:

    python3 -m fdtdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints progress and the numbers compared on
standard error and, as the last line of standard output, the result: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer ones.
Exits non-zero, printing no result, without the CUDA cards the cell asks
for, when the cell's host arrays would not fit in the host's MemAvailable,
or when a module of JAX or of the JAX package has been loaded.
"""

import time

T0 = time.perf_counter()  # set-up runs from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m fdtdbench.run", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import harness

    cell = harness.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        harness.log(f"cell {cell.name} needs {cell.chips} CUDA card(s);"
                    f" torch.cuda.is_available() is {torch.cuda.is_available()},"
                    f" {have} card(s)")
        return 2
    try:
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    except harness.HostMemoryError as e:
        harness.log(str(e))
        return 4
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"modules of JAX or the JAX package were loaded: {loaded}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

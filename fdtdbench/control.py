"""Readings that the comparison's limits are set from, at a cell's own size:

    python3 -m fdtdbench.control --workload <cell> --sound 11,12,.. --control 21,22,..

For each seed of --sound, one shot of the program as the configuration
states it, and for each seed of --control one shot with bfloat16 storage
(the program's own lower-precision path, the control that has to fail),
each compared with the plain reference as a run compares its sample; all in
one process, one line of JSON a shot on standard output. Needs a card.
"""

import argparse
import json
import sys
import time

import torch

from . import harness, inputs


def reading(cell, seed: int, storage_dtype=None) -> dict:
    t0 = time.perf_counter()
    bench = harness.Bench(cell, seed, "cuda", storage_dtype)
    table = bench.table(inputs.SHOT, 0)
    rec, out = bench.shot(0, table)
    bench.free()
    detail = {}
    numbers = harness.check_shot(bench, 0, out, detail)
    return {"cell": cell.name, "seed": seed, "storage": bench.storage_dtype,
            "shot_s": rec.seconds, "total_s": time.perf_counter() - t0, **numbers, **detail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m fdtdbench.control", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", default="", help="seeds of sound runs, comma-separated")
    ap.add_argument("--control", default="", help="seeds of the bfloat16 control")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("the readings need a CUDA card")
        return 2
    cell = harness.load_cell(args.workload)
    for seeds, storage in ((args.sound, None), (args.control, "bfloat16")):
        for s in filter(None, seeds.split(",")):
            print(json.dumps(reading(cell, int(s), storage)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that set a cell's limits, taken on the card at the cell's own
size: the port as it runs, the reference in the precision below the
configuration's in the port's place (the control), and the port with a
fault planted under it (``benchmark/faults.py``), each on every seed:

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--modes sound,control]

One JSON line a seed and mode on standard output: the numbers the
cell's check compares. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--modes", default="",
                    help="comma-separated; default: every mode the driver has")
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    modes = args.modes.split(",") if args.modes else list(cell.driver.MODES)
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in modes:
            t0 = time.perf_counter()
            run = harness.Run(cell, seed, "cuda")
            values = cell.driver.readings(run, mode)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "readings": values,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

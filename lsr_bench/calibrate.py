"""Readings that the output check's limits are set from: for each seed, the
numbers a cell's check compares, from sound runs of the program, from the
control (the reference at float8 in the program's place), or from the
program with a fault planted.

    python3 lsr_bench/calibrate.py --workload <name> --variant sound --seeds 1,2,3 [--units 4]

prints one JSON line per seed. Every seed runs the cell's own set-up at the
cell's own size and `--units` units of its traffic (no timed window), all
in this one process. The benchmark's runs never run this.

Variants: sound, control, and the faults a cell can have: frozen (a step
that returns its state unchanged), half_batch (half of the batch left out,
the mean over the rest), no_exchange (the gradient sum between mesh
positions left out), token (a token altered where it is produced), answer
(an answer altered where it is produced).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="sound")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=4)
    args = ap.parse_args(argv)

    from lsr_bench import harness

    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        cell = harness.load_cell(args.workload)
        cell.seed = seed
        if args.variant not in ("sound", "control"):
            cell.overrides["fault"] = args.variant
        driver = harness.load_driver(cell)
        if args.variant == "control" and hasattr(driver, "setup_for_control"):
            driver.setup_for_control(args.units)
        else:
            driver.setup()
            for _ in range(args.units):
                driver.unit()
        nums = driver.control() if args.variant == "control" else driver.readings()
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          **nums, "seconds": time.perf_counter() - t0}), flush=True)
        del driver


if __name__ == "__main__":
    main()

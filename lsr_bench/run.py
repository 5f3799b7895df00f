"""Run one cell of the port's benchmark and print its result line.

    python3 lsr_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (kernel build or load, weights and
inputs made on the card from the seed, warm-up of the cell's shapes) is
timed from the start of this process to the first timed unit of work;
then the window runs for --seconds. --trace 1 runs the first half of the
window as it is and profiles the second half, and prints the per-layer
metrics instead of the end-to-end ones. The last line of standard output
is the result's JSON object; the numbers the output check compared, each
with its limit, are the last lines of standard error and the result's last
key. The run fails, and prints no result, without enough CUDA cards, or if
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel and compiler caches at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from lsr_bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    cell.seed = args.seed
    out = harness.run_cell(cell, args.seconds, bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules that the benchmark must not load: {bad}", file=sys.stderr)
        return 3
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

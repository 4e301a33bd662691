"""Run one cell of the benchmark once, on the card:

    python3 gpbench/run.py --workload paper-m4.serve --seed 7 --seconds 30 \
        --trace 0

from the root of a checkout. Prints the result as one JSON line, the last
of standard output; each compared number and its limit are the last lines
of standard error. Exits non-zero, printing no result, without a CUDA card
or without the program beside the benchmark.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    # the program's kernels build once into its own directory inside the
    # checkout (src/repro_torch/kernels/build); nothing else is cached
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpbench import harness
    sys.exit(harness.main(args, T_START))

"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as one JSON line, last on
standard output; the numbers compared for `correct` come last on
standard error. Needs the cell's CUDA devices: without them it exits 2
and prints no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, root: Path = ROOT) -> int:
    """`device` None means the cell's CUDA devices; the tests pass "cpu"."""
    from portbench.core import harness

    return harness.run(parse(argv), root, device, T_START)


if __name__ == "__main__":
    sys.exit(main())

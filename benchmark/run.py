"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The last
line of standard output is the result (``benchlib/harness.py``); progress
goes to standard error. Exit codes: 0 a result, 2 bad arguments, 3 no card
(or fewer than the cell needs), 4 a JAX module was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "benchmark" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "benchmark" / "triton")
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path[:0] = [str(HERE), str(ROOT)]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    from benchlib import harness

    sys.exit(harness.main(parse(), T_PROCESS))

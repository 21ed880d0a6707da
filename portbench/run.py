"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices
(it refuses to run without them).  ``BENCHMARK.json`` names the cell's
configuration and traffic; ``--trace 0`` prints its end-to-end metrics,
``--trace 1`` its per-layer ones, read from a ``torch.profiler`` trace of
the window.  The last line of standard output is one JSON object; the
compared numbers and their limits close standard error.
"""

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / "_cache"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the program's nvcc cache is its own fixed src/repro_torch/_build;
    # any other kernel cache stays inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())

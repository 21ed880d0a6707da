"""Readings that set a cell's correctness limits, on the chip.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 8 [--control 3]

For each seed, in one process: the cell's weights and traffic from the
seed, a short window at the cell's own load, then the numbers the run's
check compares (the program's) and, for the first ``--control`` seeds,
the same numbers of the control: the reference in float8 put in the
program's place.  One JSON line a seed on standard output.  The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench import check, harness, registry

    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = harness.Cell.load(registry.benchmark(), args.workload)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run, srv = harness.run(cell, seed, args.seconds, False, device,
                               time.perf_counter_ns(), warm=n == 0)
        params = srv.params
        srv.close()
        del srv
        torch.cuda.empty_cache()
        picked = check.sample(run.requests, seed,
                              cell.traffic["check"]["sampled_requests"])
        out = check.readings(cell, picked, params, n < args.control)
        out.update(workload=args.workload, seed=seed,
                   requests=len(run.requests),
                   seconds=round(time.perf_counter() - t0, 3))
        print(json.dumps(out), flush=True)
        del params, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

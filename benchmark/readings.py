"""The readings behind a cell's limits: the numbers ``correct`` compares, on
many seeds, in one process (the set-up of a run is long; the benchmark's own
runs each take a process of their own).

    python3 -m benchmark.readings --workload NAME --seeds 1,2,3 --seconds 3 \\
        [--control-seeds 4,5,6 --control fp8,half_batch,altered]

Each seed prints its result line as a run does; the control seeds add the
same numbers with the reference put in the program's place (in float8, or
with a fault planted). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import sys

from . import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", default="3")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control", default="fp8,half_batch,altered")
    args = p.parse_args(argv)
    jobs = [(int(s), "") for s in args.seeds.split(",") if s]
    jobs += [(int(s), args.control) for s in args.control_seeds.split(",") if s]
    worst = 0
    for seed, control in jobs:
        rc = run.main(["--workload", args.workload, "--seed", str(seed), "--seconds", args.seconds,
                       "--control", control])
        print(f"readings seed {seed} rc {rc}", file=sys.stderr, flush=True)
        sys.stdout.flush()
        worst = max(worst, rc)
        gc.collect()
    return worst


if __name__ == "__main__":
    sys.exit(main())

"""
The control of a cell's comparison, per seed, at the cell's own size: the
reference put in the program's place, one precision below what the
configuration states (the assignment's product in TF32 for the
segmentation cells, float32 sums for the statistics), judged by the
cell's own comparison (its job's ``verify``). Every seed has to come out
not correct.

    python gpubench/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed. Runs on the GPU; ``--device cpu`` runs it
on the CPU (at a cell's size that takes long).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# import the benchmark as the package ``gpubench`` from the checkout, not
# its modules from the script's own folder
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, CHECKOUT)

from gpubench import bench  # noqa: E402


def control_checks(run):
    """The control put where the window's outputs go (the job's
    ``control``), judged by the job's own ``verify``: the cell's compared
    numbers."""
    run.job.control(run)
    run.job.release(run)
    return run.job.verify(run)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = bench.Spec(CHECKOUT)
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = bench.Run(spec, args.workload, seed, 0, 0, args.device)
        run.workdir = tempfile.mkdtemp(prefix="gpubench-")
        try:
            t0 = time.time()
            run.job.prepare(run)
            t1 = time.time()
            checks = control_checks(run)
        finally:
            shutil.rmtree(run.workdir, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": "control", "setup_s": t1 - t0,
                          "check_s": time.time() - t1,
                          "correct": bench.correct(checks),
                          "checks": {n: v for n, v, _ in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

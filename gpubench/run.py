"""
Run one cell of ``BENCHMARK.json`` once on the GPU:

    python gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

Prints the result as the last line of standard output, one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: every compared number
beside its limit), after the same numbers as the last lines of standard
error. Exits non-zero, printing no result, without a CUDA device, with
fewer devices than the cell asks for, or when a forbidden module (JAX,
the JAX package) was loaded.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# import the benchmark as the package ``gpubench`` from the checkout, not
# its modules from the script's own folder
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, CHECKOUT)

import torch  # noqa: E402

IMPORTED = time.time()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench import bench
    spec = bench.Spec(CHECKOUT)
    cell = spec.workload(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the GPU only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print("the cell asks for %d devices, %d present"
              % (cell["chips"], torch.cuda.device_count()), file=sys.stderr)
        return 2
    print("device: %s x %d" % (torch.cuda.get_device_name(0),
                               torch.cuda.device_count()), file=sys.stderr)
    result = bench.run_cell(spec, args.workload, args.seed, args.seconds,
                            args.trace, "cuda", STARTED,
                            {"import_torch": IMPORTED - STARTED})
    bench.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

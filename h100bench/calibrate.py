"""Readings that the limits of ``limits/<workload>.json`` are set from.

    python3 h100bench/calibrate.py --workload <name> --seeds <n> ... \
        [--control-seeds <n> ...] [--out <file>]

On the card, at the cell's own sizes, each reading is one run of the
cell (``harness.cell.run_cell``) with a window of one job, checked by
the run's own comparison: for each of ``--seeds`` the program as
configured (the lower reading is the largest of these); for each of
``--control-seeds`` the program at the nearest lower precision
(complex64, the program's own path), which has to come out not correct
(the upper reading is the smallest of these). One JSON line per run,
with its ``correct`` and ``checks``, to standard output and, with
``--out``, to that file.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from harness import registry
    from harness.cell import forbidden_modules, run_cell

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = registry.benchmark()
    runs = ([("program", None, s) for s in args.seeds]
            + [("control", torch.complex64, s) for s in args.control_seeds])
    sink = open(args.out, "a") if args.out else None
    for kind, dtype, seed in runs:
        r = run_cell(spec, args.workload, seed, 0, device="cuda",
                     dtype=dtype)
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "correct": r["correct"],
                           "checks": r["checks"], "seconds": r["seconds"]})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    if sink:
        sink.close()
    if forbidden_modules():
        print(f"JAX or the JAX package was loaded: {forbidden_modules()}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())

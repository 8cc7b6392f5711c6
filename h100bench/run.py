"""Benchmark of pyqed_tpu_torch on one NVIDIA H100.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Runs one cell of ``BENCHMARK.json`` (its
files are found by name, see ``harness/registry.py``) and prints, as the
last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``: each number that decides
``correct`` with its limit, which also end standard error.

Exits with a code other than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), when the measured program
cannot be imported, or when JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, "build", "h100bench_cache")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    sys.path[:0] = [HERE, ROOT]
    import torch

    from harness import registry
    from harness.cell import forbidden_modules, run_cell

    spec = registry.benchmark()
    cell = registry.workload(spec, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import pyqed_tpu_torch  # noqa: F401  (fails outside a full checkout)

    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      trace=bool(args.trace), device="cuda", t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

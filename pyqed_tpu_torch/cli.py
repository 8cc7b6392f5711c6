"""Command-line interface of the PyTorch port: ``pyqed-tpu-torch``.

Counterpart of ``pyqed_tpu/cli.py`` with the same subcommands:

- ``info``: the package, torch's and CUDA's versions and the cards;
- ``test``: the Rabi smoke test through the port's ``SESolver``;
- ``bench``: run() steps/s of the FMO flagship ``HEOMSolver`` (7 sites,
  Padé-decomposed Drude baths, lmax = 3, 680 ADOs; RK4, dt = 10 au), as
  one JSON line;
- ``run JOB``: a JSON job spec (sesolve, lindblad, heom, spo) through the
  port's solvers, dumped to NPZ by ``Result.dump``.

Every subcommand that computes runs on the card unless ``--device cpu``
is given (``test``, ``bench``, ``run``); without a card it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="pyqed-tpu-torch",
        description="molecular QED / quantum dynamics framework "
                    "(PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="cmd")

    sub.add_parser("info", help="show versions and devices")
    p_bench = sub.add_parser(
        "bench", help="time the FMO flagship HEOM run (steps/s)")
    p_test = sub.add_parser("test", help="run a quick smoke test")
    p_run = sub.add_parser(
        "run", help="run a job described by a JSON spec file")
    p_run.add_argument("job", help="path to the JSON job spec")
    p_run.add_argument("-o", "--output", default=None,
                       help="output .npz path (default: <job>.npz)")
    for p in (p_bench, p_test, p_run):
        p.add_argument("--device", default=None,
                       help="torch device (default: the card, cuda)")

    args = parser.parse_args(argv)

    if args.cmd == "info":
        import torch
        import pyqed_tpu_torch
        print(f"pyqed_tpu_torch {pyqed_tpu_torch.__version__}")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"cuda available: {torch.cuda.is_available()}")
        for i in range(torch.cuda.device_count()):
            print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")
        return 0

    if args.cmd == "bench":
        print(json.dumps(bench_heom(device=args.device)))
        return 0

    if args.cmd == "test":
        return rabi_test(device=args.device)

    if args.cmd == "run":
        import os
        out = args.output or (os.path.splitext(args.job)[0] + ".npz")
        run_job(args.job, out, device=args.device)
        return 0

    parser.print_help()
    return 0


def rabi_test(device=None):
    """H = 0.1 sx from |0>: p1(t) = sin²(0.1 t) over 500 RK4 steps of
    0.01; prints a JSON line and returns 0 when the error is below
    1e-6."""
    import numpy as np
    from .models.mol import SESolver
    from .ops.linalg import ket2dm
    from .ops.operators import basis, pauli
    _, sx, _, _ = pauli()
    res = SESolver(0.1 * sx, device=device).run(
        psi0=basis(2, 0), dt=0.01, Nt=500, e_ops=[ket2dm(basis(2, 1))])
    p1 = res.observables[:, 0].real.cpu().numpy()
    t = res.times.cpu().numpy() if hasattr(res.times, "cpu") \
        else np.asarray(res.times)
    err = float(np.max(np.abs(p1 - np.sin(0.1 * t) ** 2)))
    ok = err < 1e-6
    print(json.dumps({"smoke_test": "rabi", "max_err": err, "ok": ok}))
    return 0 if ok else 1


def bench_heom(nt=2000, device=None, nout=40):
    """run() steps/s of the FMO flagship (temperature 300 K, lmax 3, one
    Padé term per bath, 680 ADOs; RK4 at dt = 10 au), from the difference
    of an ``nt``-step and an ``nout``-step run so that run()'s setup
    cancels. Returns a dict (the JSON line of ``bench``)."""
    import torch
    from .config import resolve_device
    from .models.named import FMO
    dev = resolve_device(device)
    m = FMO()
    sol = m.heom(temperature=300.0, lmax=3, nexp=1, decomposition="pade",
                 device=dev)
    rho0 = m.initial_state(0)
    e_ops = m.site_projectors()

    def wall(steps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sol.run(rho0, dt=10.0, nt=steps, nout=nout, e_ops=e_ops)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    wall(nout)                      # warm-up: builds and first launches
    rate = (nt - nout) / (wall(nt) - wall(nout))
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"bench": "heom_fmo_flagship", "steps": nt,
            "steps_per_s": rate, "device": name}


def run_job(job_path, out_path, device=None):
    """Execute a JSON job spec and dump the Result to NPZ.

    Spec format (all matrices as nested lists; with "complex_pairs":
    true, trailing [re, im] pairs are read as complex entries):

        {"task": "sesolve" | "lindblad" | "heom" | "spo",
         "H": [[...]], "psi0"/"rho0": [...], "dt": 0.01, "nt": 1000,
         "nout": 10, "e_ops": [[[...]]], "c_ops": [...],      # lindblad
         "bath": {"temperature": .., "cutoff": .., "reorg": ..},  # heom
         "grid": {"xmin": .., "xmax": .., "n": ..}, "mass": ..,
         "potential": "0.5*x**2"}                              # spo

    The SPO potential and initial state are math-only expressions of
    ``np`` and ``x`` (no builtins). Runs on ``device`` (the card when
    None).
    """
    import numpy as np

    with open(job_path) as fh:
        spec = json.load(fh)

    def arr(x):
        a = np.asarray(x)
        if a.ndim and a.shape[-1] == 2 and spec.get("complex_pairs"):
            a = a[..., 0] + 1j * a[..., 1]
        return a.astype(complex)

    task = spec["task"]
    dt = float(spec.get("dt", 0.01))
    nt = int(spec.get("nt", 100))
    nout = int(spec.get("nout", 1))
    e_ops = [arr(o) for o in spec.get("e_ops", [])]

    if task == "sesolve":
        from .models.mol import SESolver
        res = SESolver(arr(spec["H"]), device=device).run(
            psi0=arr(spec["psi0"]), dt=dt, Nt=nt, nout=nout, e_ops=e_ops)
    elif task == "lindblad":
        from .open.lindblad import LindbladSolver
        c_ops = [arr(c) for c in spec.get("c_ops", [])]
        res = LindbladSolver(arr(spec["H"]), c_ops=c_ops,
                             device=device).run(
            arr(spec["rho0"]), dt=dt, Nt=nt, nout=nout, e_ops=e_ops)
    elif task == "heom":
        from .open.heom import HEOMSolver
        from .open.bath import DrudeBath
        b = spec["bath"]
        bath = DrudeBath(temperature=float(b["temperature"]),
                         cutoff=float(b["cutoff"]),
                         reorg=float(b["reorg"]))
        bath.set_bath_ops([arr(spec["coupling"])])
        sol = HEOMSolver(arr(spec["H"]), bath=bath,
                         lmax=int(spec.get("lmax", 4)),
                         nexp=int(spec.get("nexp", 2)), device=device)
        res = sol.run(arr(spec["rho0"]), dt=dt, nt=nt, nout=nout,
                      e_ops=e_ops)
    elif task == "spo":
        from .grid.spo import SPON
        g = spec["grid"]
        x = np.linspace(float(g["xmin"]), float(g["xmax"]), int(g["n"]),
                        endpoint=False)
        sol = SPON([x], masses=[float(spec.get("mass", 1.0))], nstates=1,
                   device=device)
        # expression strings are math only — no builtins, just np and x
        env = {"__builtins__": {}, "np": np, "x": x}
        v = eval(spec["potential"], env)
        sol.set_dpes(np.asarray(v))
        psi0 = eval(spec["psi0"], env)
        psi0 = np.asarray(psi0, complex)
        psi0 /= np.sqrt(np.sum(np.abs(psi0) ** 2) * (x[1] - x[0]))
        res = sol.run(psi0[:, None], dt=dt, nt=nt, nout=nout)
    else:
        raise SystemExit(f"unknown task {task!r}")

    res.dump(out_path)
    print(json.dumps({"task": task, "output": out_path,
                      "times": int(np.asarray(
                          res.times.cpu() if hasattr(res.times, "cpu")
                          else res.times).shape[0])}))
    return res


if __name__ == "__main__":
    sys.exit(main())

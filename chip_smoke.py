#!/usr/bin/env python3
"""GPU smoke run of pyqed_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the exit code is
nonzero:

1. environment: the card's name and power limit (nvidia-smi), TF32 off;
2. build: compiles csrc/heom_coupling.cu with nvcc and prints the
   -Xptxas -v report;
3. kernel parity: the CUDA coupling kernel against its plain PyTorch
   version at the FMO flagship shape (680 ADOs, V = 49) and at the n = 8
   exciton-chain shape (680 ADOs, V = 64), complex128 (rel <= 1e-12) and
   complex64 (rel <= 1e-5);
4. main path: FMO().heom(..., device='cuda').run(...) for 4000 steps of
   10 au (968 fs) at complex128 through the kernel (launch count 4 x nt, trace error and
   agreement with the plain einsum run <= 1e-10, first window against a
   CPU run), then the nexp=2 hierarchy (2,024 ADOs);
5. timing, for the record: kernel vs plain per call (CUDA events), and
   run() steps/s for every right-hand side, in turns.

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}. Without a CUDA device it raises before
printing any result.
"""
import json
import subprocess
import time

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(temperature=300.0, lmax=3, nexp=1, decomposition="pade")
DT = 10.0          # au
NT = 4000          # 4000 x 10 au = 967.6 fs
NOUT = 40
DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ 1
def phase_environment():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "TF32 off")
    return card


# ------------------------------------------------------------------ 2
def phase_build():
    from pyqed_tpu_torch.ops import _cuda_lib
    built = _cuda_lib.load("heom_coupling")
    log(f"[build] {built.path.name}: nvcc {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if line.strip():
            log(f"[build] {line.strip()}")


# ------------------------------------------------------------------ 3
def chain_solver():
    """The n = 8 exciton chain (ground + 7 sites) with per-site Drude
    baths, Pade-decomposed to 2 terms per site: M = 14, lmax = 3."""
    from pyqed_tpu_torch import DrudeBath, HEOMSolver
    rng = np.random.default_rng(0)
    nsite = 7
    n = nsite + 1
    H = np.zeros((n, n))
    E = 1.0 + 0.1 * rng.standard_normal(nsite)
    for i in range(nsite):
        H[1 + i, 1 + i] = E[i]
    for i in range(nsite - 1):
        H[1 + i, 2 + i] = H[2 + i, 1 + i] = 0.05
    c, nu = DrudeBath(temperature=0.25, cutoff=0.25, reorg=0.02).pade(1)
    bath = []
    for site in range(nsite):
        Q = np.zeros((n, n))
        Q[1 + site, 1 + site] = 1.0
        bath.append((Q, c, nu))
    return HEOMSolver(H, bath=bath, lmax=3, device=DEVICE)


def coupling_operands(sol, dtype):
    """Kernel operands of a solver's hierarchy, with F from a numpy seed."""
    from pyqed_tpu_torch.ops import kernels as kn
    keys, plus_idx, minus_idx, Q, c, _ = sol._build(dtype)
    _, OpT, nbr, w = kn.heom_coupling_operands(sol._H_np, Q, c, keys,
                                               plus_idx, minus_idx)
    rng = np.random.default_rng(SEED)
    nado, V = keys.shape[0], OpT.shape[-1]
    F = rng.standard_normal((nado, V)) + 1j * rng.standard_normal((nado, V))
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    return (torch.as_tensor(F, dtype=dtype, device=DEVICE),
            torch.as_tensor(nbr, device=DEVICE),
            torch.as_tensor(w, dtype=rdt, device=DEVICE),
            torch.as_tensor(OpT, dtype=dtype, device=DEVICE))


def phase_parity(shapes):
    from pyqed_tpu_torch.ops import kernels as kn
    errs = {}
    for name, sol in shapes.items():
        for dtype, tol in ((torch.complex128, 1e-12), (torch.complex64, 1e-5)):
            F, nbr, w, OpT = coupling_operands(sol, dtype)
            out = kn.heom_coupling(F, nbr, w, OpT)
            ref = kn.heom_coupling_ref(F, nbr, w, OpT)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            log(f"[parity] {name} nado={F.shape[0]} V={F.shape[1]} "
                f"nj={OpT.shape[0]} {str(dtype)[6:]}: max abs err {err:.3e}, "
                f"rel {rel:.3e} (tol {tol:g})")
            if not (np.isfinite(rel) and rel <= tol):
                raise AssertionError(f"kernel disagrees with plain version "
                                     f"at {name} {dtype}: rel {rel:.3e}")
            errs[(name, dtype)] = err
    return errs


# ------------------------------------------------------------------ 4
def checked_run(m, sol, nt, label):
    """Run through the default (kernel) path, counting launches, then the
    plain einsum path on the same card; check both."""
    from pyqed_tpu_torch.ops import kernels as kn
    from pyqed_tpu_torch.units import au2fs
    rho0, e_ops = m.initial_state(0), m.site_projectors()
    kn.heom_coupling.launches = 0
    t0 = time.perf_counter()
    res = sol.run(rho0, dt=DT, nt=nt, nout=NOUT, e_ops=e_ops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kn.heom_coupling.launches
    nwin = nt // NOUT
    obs = res.observables
    if tuple(obs.shape) != (nwin + 1, m.nsites) or not bool(
            torch.isfinite(torch.view_as_real(obs)).all()):
        raise AssertionError(f"{label}: bad observables {tuple(obs.shape)}")
    pops = obs.real
    trace_err = (pops.sum(dim=1) - 1.0).abs().max().item()
    res_e = sol.run(rho0, dt=DT, nt=nt, nout=NOUT, e_ops=e_ops,
                    kernel="einsum")
    diff = max((obs - res_e.observables).abs().max().item(),
               (res.ado - res_e.ado).abs().max().item())
    p = pops[-1].cpu().numpy()
    log(f"[main] {label}: nado={res.ado.shape[0]} nt={nt} "
        f"({nt * DT * au2fs:.1f} fs) in {wall:.2f} s, kernel launches "
        f"{launches} (expected {4 * nt}), trace err {trace_err:.2e}, "
        f"|kernel - einsum| {diff:.2e}, final populations "
        + " ".join(f"{x:.4f}" for x in p))
    if launches != 4 * nt:
        raise AssertionError(f"{label}: {launches} kernel launches, "
                             f"expected {4 * nt}")
    if not trace_err <= 1e-10:
        raise AssertionError(f"{label}: trace error {trace_err:.3e}")
    if not diff <= 1e-10:
        raise AssertionError(f"{label}: kernel and einsum runs differ by "
                             f"{diff:.3e}")
    return res, launches


def phase_main():
    from pyqed_tpu_torch import FMO
    m = FMO()
    sol = m.heom(**FLAGSHIP, device=DEVICE)
    res, launches = checked_run(m, sol, NT, "FMO flagship nexp=1")
    # the first window against the same run on the CPU
    cpu = m.heom(**FLAGSHIP).run(m.initial_state(0), dt=DT, nt=NOUT,
                                 nout=NOUT, e_ops=m.site_projectors())
    d = (res.observables[:2].cpu() - cpu.observables).abs().max().item()
    log(f"[main] first window vs CPU einsum run: max |diff| {d:.2e}")
    if not d <= 1e-12:
        raise AssertionError(f"card and CPU runs differ by {d:.3e}")
    sol2 = m.heom(**dict(FLAGSHIP, nexp=2), device=DEVICE)
    checked_run(m, sol2, 400, "FMO nexp=2")
    return launches


# ------------------------------------------------------------------ 5
def event_ms(fn, args, iters=200, warmup=20):
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def steps_per_s(m, sol, kernel, nt=2000):
    """run() steps/s from the difference of an nt-step and a one-window
    run, so the setup of run() cancels."""
    rho0, e_ops = m.initial_state(0), m.site_projectors()
    walls = []
    for steps in (NOUT, nt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol.run(rho0, dt=DT, nt=steps, nout=NOUT, e_ops=e_ops, kernel=kernel)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return (nt - NOUT) / (walls[1] - walls[0])


def phase_timing(card, shapes):
    from pyqed_tpu_torch import FMO
    from pyqed_tpu_torch.ops import kernels as kn
    times = {}
    for name, sol in shapes.items():
        for dtype in (torch.complex128, torch.complex64):
            args = coupling_operands(sol, dtype)
            t_plain = event_ms(kn.heom_coupling_ref, args)
            t_kern = event_ms(kn.heom_coupling, args)
            t_plain2 = event_ms(kn.heom_coupling_ref, args)
            times[(name, dtype)] = (t_kern, min(t_plain, t_plain2))
            log(f"[time] heom_coupling {name} {str(dtype)[6:]}: kernel "
                f"{t_kern * 1e3:.1f} us, plain {t_plain * 1e3:.1f} / "
                f"{t_plain2 * 1e3:.1f} us per call ({card})")
    m = FMO()
    sol = m.heom(**FLAGSHIP, device=DEVICE)
    order = ["cuda", "einsum", "matmul", "levels", "rowcol"]
    rates = {k: [] for k in order}
    for k in order + order[::-1]:
        rates[k].append(steps_per_s(m, sol, k))
    for k in order:
        log(f"[time] run() FMO flagship complex128 kernel={k}: "
            + ", ".join(f"{r:.0f}" for r in rates[k])
            + f" steps/s ({card})")
    return times


def main():
    card = phase_environment()
    import pyqed_tpu_torch  # noqa: F401  (fails outside the repository)
    phase_build()
    from pyqed_tpu_torch import FMO
    shapes = {"fmo": FMO().heom(**FLAGSHIP, device=DEVICE),
              "chain8": chain_solver()}
    errs = phase_parity(shapes)
    launches = phase_main()
    times = phase_timing(card, shapes)
    t_kern, t_plain = times[("fmo", torch.complex128)]
    log(json.dumps({"kernels": [{
        "name": "heom_coupling",
        "route": "cuda",
        "source": "pyqed_tpu_torch/csrc/heom_coupling.cu",
        "replaces": "pyqed_tpu/ops/pallas_kernels.py:681",
        "launches": launches,
        "max_abs_err": errs[("fmo", torch.complex128)],
        "ms": t_kern,
        "plain_ms": t_plain,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Rank bodies of the port's multi-process tests.

``tests/test_torch_parallel.py`` and ``tests/test_torch_distributed.py``
each start one gloo process group of :data:`WORLD` ranks
(``torch.multiprocessing``, start method ``spawn``) and run
every case of their suite in that one launch (:class:`Launch`); each rank
saves what it got
(numpy arrays, counts, errors) and the parent compares case by case, so
each case is still its own test. This module imports torch, numpy and
the port, never JAX: a spawned rank imports it for :func:`main`. Inputs
made in the parent (the JAX package's draws) come in through
``inputs.pt`` in the output folder.
"""
import os
import socket
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

WORLD = 4
TIMEOUT = 400          # seconds for a whole launch (a guard against hangs)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Launch:
    """One launch of a suite on ``world`` spawned gloo ranks
    (``torch.multiprocessing``, start method ``spawn``): started at
    construction, so the parent can compute its references meanwhile;
    :meth:`wait` returns the ranks' result dicts, in rank order."""

    def __init__(self, suite, outdir, world=WORLD):
        import torch.multiprocessing as mp
        self.suite, self.outdir, self.world = suite, Path(outdir), world
        self.ctx = mp.start_processes(
            main, args=(world, _free_port(), str(self.outdir), suite),
            nprocs=world, start_method="spawn", join=False)
        self.deadline = time.time() + TIMEOUT

    def provide(self, inputs):
        """Hand the ranks their inputs (they wait for them where a case
        needs them)."""
        tmp = self.outdir / "inputs.tmp"
        torch.save(inputs, tmp)
        tmp.rename(self.outdir / "inputs.pt")

    def wait(self):
        try:
            while not self.ctx.join(timeout=1.0):
                if time.time() > self.deadline:
                    raise TimeoutError(f"{self.suite}: ranks still running "
                                       f"after {TIMEOUT} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(self.outdir / f"{self.suite}_{r}.pt",
                           weights_only=False) for r in range(self.world)]


class Inputs:
    """The parent's inputs, loaded at the first look (waiting for the
    file the parent writes while the ranks run their first cases)."""

    def __init__(self, outdir):
        self.path, self.data = Path(outdir) / "inputs.pt", None

    def __getitem__(self, key):
        if self.data is None:
            deadline = time.time() + TIMEOUT
            while not self.path.exists():
                if time.time() > deadline:
                    raise TimeoutError("no inputs from the parent")
                time.sleep(0.05)
            self.data = torch.load(self.path, weights_only=False)
        return self.data[key]


def case_result(results, name):
    """The case's result on every rank; raises with the first rank's
    traceback where a rank failed it."""
    out = [r[name] for r in results]
    for rank, r in enumerate(out):
        if isinstance(r, dict) and "error" in r:
            raise AssertionError(f"case {name} failed on rank {rank}:\n"
                                 + r["error"])
    return out


def main(rank, world, port, outdir, suite):
    """One rank: join the group through ``ensure_distributed`` from the
    ``PYQED_*`` variables, run the suite's cases, save the results."""
    torch.set_num_threads(1)
    os.environ.update(PYQED_COORDINATOR=f"127.0.0.1:{port}",
                      PYQED_NUM_PROCS=str(world), PYQED_PROC_ID=str(rank))
    import torch.distributed as dist
    from pyqed_tpu_torch.parallel import ensure_distributed
    outdir = Path(outdir)
    started = ensure_distributed(device="cpu")
    inputs = Inputs(outdir)
    res = {"started": started}
    for name, case in SUITES[suite]:
        try:
            res[name] = case(rank, world, inputs, outdir)
        except Exception:                      # noqa: BLE001
            res[name] = {"error": traceback.format_exc()}
    torch.save(res, outdir / f"{suite}_{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------- helpers
def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def mesh_of(name, world):
    from pyqed_tpu_torch.parallel import make_mesh
    return make_mesh({name: world}, devices="cpu")


@contextmanager
def counting(module, *names):
    """Count the calls of ``module``'s functions ``names`` (a dict name ->
    count), restoring them after."""
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(module, n) for n in names}

    def wrap(n):
        def f(*a, **k):
            counts[n] += 1
            return saved[n](*a, **k)
        return f

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield counts
    finally:
        for n in names:
            setattr(module, n, saved[n])


def collectives():
    """Counts of the collectives called (``all_gather``: either name of
    the all-gather into one tensor)."""
    import torch.distributed as dist
    names = [n for n in ("all_to_all_single", "all_gather_single",
                         "all_gather_into_tensor", "all_reduce")
             if hasattr(dist, n)]
    return counting(dist, *names)


def summary(c):
    return dict(all_to_all=c["all_to_all_single"], all_reduce=c["all_reduce"],
                all_gather=c.get("all_gather_single", 0)
                + c.get("all_gather_into_tensor", 0))


def plain_kernels():
    from pyqed_tpu_torch.ops import kernels as kn
    return counting(kn, "heom_coupling_ref", "spo_phase_multiply_ref",
                    "spo_potential_apply_ref")


def crand(gen, *shape):
    return torch.complex(torch.randn(shape, generator=gen,
                                     dtype=torch.float64),
                         torch.randn(shape, generator=gen,
                                     dtype=torch.float64))


# -------------------------------------------------- models of the tests
def heom_model():
    """tests/test_parallel.py::test_heom_run_mesh: 15 ADOs (no multiple of
    4 or 8)."""
    H = np.array([[1.0, 0.2], [0.2, -1.0]])
    Q = np.diag([1.0, -1.0])
    rho0 = np.array([[1.0, 0.0], [0.0, 0.0]])
    e_ops = [np.diag([1.0, 0.0])]
    return H, Q, rho0, e_ops


HEOM_RUN = dict(dt=0.01, nt=60)
HEOM_DRIVE = dict(dt=0.01, nt=40, nout=5)
EDIP = np.array([[0.0, 1.0], [1.0, 0.0]])


def spo2_model():
    n = 32
    x = np.linspace(-6, 6, n, endpoint=False)
    X, Y = np.meshgrid(x, x, indexing="ij")
    v1 = 0.5 * (X ** 2 + Y ** 2)
    v2 = 0.5 * ((X - 1) ** 2 + Y ** 2) + 1.0
    cpl = 0.1 * np.ones_like(X)
    psi0 = np.zeros((n, n, 2), complex)
    psi0[..., 0] = np.exp(-(X + 1) ** 2 - Y ** 2)
    psi0[..., 0] /= np.sqrt(np.sum(np.abs(psi0) ** 2) * (x[1] - x[0]) ** 2)
    return x, [v1, v2], [[(0, 1), cpl]], psi0


def jacobi_model():
    n = 32
    x = np.linspace(1.2, 4.2, n, endpoint=False)
    th = np.linspace(-np.pi, np.pi, n, endpoint=False)
    X, TH = np.meshgrid(x, th, indexing="ij")
    v1 = 0.5 * (X - 2.5) ** 2 + 0.1 * np.cos(TH)
    cpl = 0.05 * np.ones_like(X)
    psi0 = np.zeros((n, n, 2), complex)
    psi0[..., 0] = np.exp(-(X - 2.5) ** 2 - TH ** 2)
    psi0[..., 0] /= np.linalg.norm(psi0)
    return x, th, [v1, v1 + 1.0], [[(0, 1), cpl]], psi0


def spo1_model():
    n = 64
    x = np.linspace(-8, 8, n, endpoint=False)
    v = np.zeros((n, 2, 2))
    v[:, 0, 0] = 0.5 * x ** 2
    v[:, 1, 1] = 0.5 * (x - 1) ** 2 + 0.5
    v[:, 0, 1] = v[:, 1, 0] = 0.05 * np.exp(-x ** 2)
    psi0 = np.zeros((n, 2), complex)
    psi0[:, 0] = np.exp(-(x + 1) ** 2)
    return x, v, psi0


SPO_RUNS = {"linear": dict(dt=0.02, nt=40, nout=10),
            "jacobi": dict(dt=0.01, nt=20, nout=10),
            "1d": dict(dt=0.02, nt=40, nout=10)}


def f2d_setup(device="cpu"):
    """tests/test_parallel.py::TestField2DESSharded's two-level system."""
    import pyqed_tpu_torch as pt
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    sz = np.diag([1.0, -1.0])
    bath = pt.DrudeBath(temperature=0.5, cutoff=0.5, reorg=0.01)
    bath.set_bath_ops([sz])
    sol = pt.HEOMSolver((0.5 * sz).astype(complex), bath=bath, lmax=1,
                        decomposition="pade", nexp=1, device=device)
    rho0 = np.array([[1.0, 0], [0, 0]], complex)
    return sol, rho0, sx


F2D_T1S = np.arange(8) * 0.3
F2D_RUN = dict(t2=0.3, nt3=32, dt=0.05, pulse_width=0.3,
               e_amps=(0.05, 0.05, 0.05), omega_c=1.0)


# ---------------------------------------------- suite: test_torch_parallel
def case_mesh_api(rank, world, inputs, outdir):
    from pyqed_tpu_torch.parallel import (make_mesh, pad_to_multiple,
                                          process_info, replicated,
                                          shard_along, with_sharding)
    out = {}
    m = make_mesh({"dp": 2, "tp": -1}, devices="cpu")
    out["shape"] = tuple(m.shape)
    out["names"] = tuple(m.mesh_dim_names)
    try:
        make_mesh({"a": 3}, devices="cpu")
        out["bad"] = "no error"
    except ValueError as e:
        out["bad"] = str(e)
    y, n = pad_to_multiple(torch.ones(10, 3, dtype=torch.complex128), 8)
    out["pad"] = (tuple(y.shape), n, float(y[10:].abs().sum()))
    w = mesh_of("walker", world)
    out["shard"] = host(with_sharding(torch.arange(10.0), w))
    out["placements"] = ([str(p) for p in shard_along(m, "tp", 2, 1)],
                         [str(p) for p in replicated(m, 2)])
    out["info"] = process_info()
    return out


PENCIL_SHAPES = [((512, 2), 1), ((1024,), 1), ((64, 64, 2), 2),
                 ((32, 64, 16, 1), 3)]


def case_pencil_fft(rank, world, inputs, outdir):
    from pyqed_tpu_torch.parallel import fft_sharded, ifft_sharded
    from pyqed_tpu_torch.parallel.mesh import axis_group, gather_rows
    mesh = mesh_of("grid", world)
    group = axis_group(mesh)[0]
    gen = torch.Generator().manual_seed(1)
    out = {}
    for shape, fnd in PENCIL_SHAPES:
        x = crand(gen, *shape)
        m = shape[0] // world
        with collectives() as c:
            f = fft_sharded(x[rank * m:(rank + 1) * m], mesh, "grid", fnd)
        back = ifft_sharded(f, mesh, "grid", fnd)
        full = gather_rows(f, group, world)
        ref = torch.fft.fftn(x, dim=tuple(range(fnd)))
        out[shape] = dict(
            fwd=float((full - ref).abs().max() / ref.abs().max()),
            back=float((back - x[rank * m:(rank + 1) * m]).abs().max()),
            counts=summary(c))
    return out


KEO_GRIDS = [((64, 64), 2), ((512,), 3), ((32, 64, 16), 1)]


def case_keo(rank, world, inputs, outdir):
    from pyqed_tpu_torch.parallel import make_keo_pencil
    mesh = mesh_of("grid", world)
    gen = torch.Generator().manual_seed(2)
    out = {}
    for grid, ns in KEO_GRIDS:
        K = torch.exp(-1j * 0.01 * torch.randn(grid, generator=gen,
                                               dtype=torch.float64))
        psi = crand(gen, *(grid + (ns,)))
        axes = tuple(range(len(grid)))
        ref = torch.fft.ifftn(torch.fft.fftn(psi, dim=axes) * K[..., None],
                              dim=axes)
        keo = make_keo_pencil(grid, ns, K, mesh, "grid")
        m = grid[0] // world
        with collectives() as c, plain_kernels() as k:
            got = keo(psi[rank * m:(rank + 1) * m])
        out[grid] = dict(err=float((got - ref[rank * m:(rank + 1) * m])
                                   .abs().max() / ref.abs().max()),
                         counts=summary(c), phase=k["spo_phase_multiply_ref"])
    return out


def case_not_dividing(rank, world, inputs, outdir):
    import pyqed_tpu_torch as pt
    from pyqed_tpu_torch.parallel import fft_sharded, make_keo_pencil
    mesh = mesh_of("grid", world)
    out = {}
    with collectives() as c:
        for name, call in (
                ("keo", lambda: make_keo_pencil(
                    (30, 64), 2, torch.ones(30, 64, dtype=torch.complex128),
                    mesh)),
                ("fft1d", lambda: fft_sharded(
                    torch.zeros(6, 2, dtype=torch.complex128), mesh)),
                ("spo", lambda: _spo_30(pt, mesh))):
            try:
                call()
                out[name] = "no error"
            except ValueError as e:
                out[name] = str(e)
    out["counts"] = summary(c)
    return out


def _spo_30(pt, mesh):
    x = np.linspace(-4, 4, 30, endpoint=False)
    s = pt.SPO2(x, x, masses=[1.0, 1.0], nstates=1, mesh=mesh, device="cpu")
    X, Y = np.meshgrid(x, x, indexing="ij")
    s.set_dpes(0.5 * (X ** 2 + Y ** 2))
    s.run(np.exp(-X ** 2 - Y ** 2).astype(complex), dt=0.01, nt=2)


def _heom_solver(kernel=None):
    import pyqed_tpu_torch as pt
    H, Q, rho0, e_ops = heom_model()
    bath = pt.DrudeBath(temperature=1.0, cutoff=0.5, reorg=0.1)
    c, nu = bath.matsubara(1)
    return pt.HEOMSolver(H, bath=[(Q, c, nu)], lmax=4, kernel=kernel,
                         device="cpu"), rho0, e_ops


def _heom_fields(r):
    return {f: host(getattr(r, f)) for f in ("observables", "states", "rho",
                                              "ado", "times")}


def case_heom(rank, world, inputs, outdir):
    mesh = mesh_of("ado", world)
    out = {}
    for kernel in ("einsum", "cuda", "levels", "matmul"):
        sol, rho0, e_ops = _heom_solver(kernel)
        with plain_kernels() as k, collectives() as c:
            rs = sol.run(rho0, e_ops=e_ops, mesh=mesh, **HEOM_RUN)
        with plain_kernels() as k0:
            ru = sol.run(rho0, e_ops=e_ops, **HEOM_RUN)
        out[kernel] = dict(sharded=_heom_fields(rs), unsharded=_heom_fields(ru),
                           launches=k["heom_coupling_ref"],
                           launches_unsharded=k0["heom_coupling_ref"],
                           counts=summary(c))
    # a mesh given to the solver, a drive and checkpoints
    sol, rho0, e_ops = _heom_solver("cuda")
    sol.mesh = mesh
    pulse = lambda t: 0.05 * np.cos(1.0 * t)            # noqa: E731
    ck = str(Path(outdir) / "heom_ck.npz")
    rs = sol.run(rho0, e_ops=e_ops, edip=EDIP, pulse=pulse, checkpoint=ck,
                 checkpoint_every=3, **HEOM_DRIVE)
    rr = sol.run(rho0, e_ops=e_ops, edip=EDIP, pulse=pulse, resume=ck,
                 **dict(HEOM_DRIVE, nt=2 * HEOM_DRIVE["nt"]))
    sol.mesh = None
    ru = sol.run(rho0, e_ops=e_ops, edip=EDIP, pulse=pulse, **HEOM_DRIVE)
    ru2 = sol.run(rho0, e_ops=e_ops, edip=EDIP, pulse=pulse,
                  **dict(HEOM_DRIVE, nt=2 * HEOM_DRIVE["nt"]))
    out["driven"] = dict(sharded=_heom_fields(rs), unsharded=_heom_fields(ru),
                         resumed=host(rr.states),
                         resumed_ref=host(ru2.states[-len(rr.states):]))
    return out


def _spo_solvers(kind, mesh):
    import pyqed_tpu_torch as pt
    if kind == "linear":
        x, surfaces, cpl, psi0 = spo2_model()
        s = pt.SPO2(x, x, masses=[1.0, 1.0], nstates=2, mesh=mesh,
                    device="cpu")
        s.set_DPES(surfaces, cpl)
    elif kind == "jacobi":
        x, th, surfaces, cpl, psi0 = jacobi_model()
        s = pt.SPO2(x, th, masses=[1.0, lambda r: 1.0 * r ** 2], nstates=2,
                    coords="jacobi", mesh=mesh, device="cpu")
        s.set_DPES(surfaces, cpl)
    else:
        x, v, psi0 = spo1_model()
        s = pt.SPO(x, mass=1.0, nstates=2, mesh=mesh, device="cpu")
        s.set_dpes(v)
    return s, psi0


def case_spo(rank, world, inputs, outdir):
    mesh = mesh_of("grid", world)
    out = {}
    for kind, run in SPO_RUNS.items():
        res = {}
        for label, m in (("sharded", mesh), ("unsharded", None)):
            s, psi0 = _spo_solvers(kind, m)
            with plain_kernels() as k, collectives() as c:
                r = s.run(psi0, **run)
            res[label] = dict(psi=host(r.psi), population=host(r.population),
                              states=host(r.states), rho_el=host(r.rho_el),
                              phase=k["spo_phase_multiply_ref"],
                              potential=k["spo_potential_apply_ref"],
                              counts=summary(c))
        out[kind] = res
    # the linear SPO2 under a mesh with checkpoints, resumed to twice nt
    run = SPO_RUNS["linear"]
    ck = str(Path(outdir) / "spo_ck.npz")
    s, psi0 = _spo_solvers("linear", mesh)
    s.run(psi0, checkpoint=ck, checkpoint_every=3, **run)
    rr = s.run(psi0, resume=ck, **dict(run, nt=2 * run["nt"]))
    s, psi0 = _spo_solvers("linear", None)
    ru = s.run(psi0, **dict(run, nt=2 * run["nt"]))
    out["resumed"] = dict(states=host(rr.states), rho_el=host(rr.rho_el),
                          states_ref=host(ru.states[-len(rr.states):]),
                          rho_el_ref=host(ru.rho_el[-len(rr.rho_el):]))
    return out


def case_field2des(rank, world, inputs, outdir):
    from pyqed_tpu_torch.signal import field_2des_rephasing
    mesh = mesh_of("batch", world)
    sol, rho0, sx = f2d_setup()
    out = {}
    for label, m in (("sharded", mesh), ("unsharded", None)):
        with plain_kernels() as k, collectives() as c:
            P3, t1, t3 = field_2des_rephasing(sol, rho0, sx, F2D_T1S,
                                              kernel="cuda", mesh=m,
                                              **F2D_RUN)
        out[label] = dict(P3=host(P3), launches=k["heom_coupling_ref"],
                          counts=summary(c))
    return out


# ------------------------------------------ suite: test_torch_distributed
def case_runtime(rank, world, inputs, outdir):
    import torch.distributed as dist
    from pyqed_tpu_torch.parallel import (ensure_distributed, global_mesh,
                                          process_info)
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    g = global_mesh("data")
    return dict(info=process_info(), sum=float(x), again=ensure_distributed(),
                mesh=(tuple(g.shape), tuple(g.mesh_dim_names)),
                env=(os.environ["PYQED_NUM_PROCS"],
                     os.environ["PYQED_PROC_ID"]))


LDR_RUN = dict(dt=0.01, nt=20)


def ldr_model(pkg_ldrn, **kw):
    sol = pkg_ldrn(domains=[(-6, 6), (-6, 6)], levels=[4, 4], nstates=2,
                   **kw)
    X, Y = np.meshgrid(*[np.asarray(x) for x in sol.x], indexing="ij")
    sol.apes = np.stack([0.5 * (X ** 2 + Y ** 2),
                         0.5 * (X ** 2 + Y ** 2) + 1.0], axis=-1)
    states = np.zeros((*X.shape, 2, 2))
    theta = 0.2 * X
    states[..., 0, 0] = np.cos(theta)
    states[..., 1, 0] = np.sin(theta)
    states[..., 0, 1] = -np.sin(theta)
    states[..., 1, 1] = np.cos(theta)
    psi0 = np.zeros((*X.shape, 2), complex)
    psi0[..., 0] = np.exp(-(X - 1) ** 2 - Y ** 2)
    return sol, states, psi0


JACOBI_LDR = dict(mass=(2.0, lambda r: 2.0 * r ** 2),
                  dom=[(1.0, 5.0), (0.3, 2.8)])


def jacobi_ldr_psi0(x):
    R, TH = np.meshgrid(x[0], x[1], indexing="ij")
    v0 = 0.5 * (R - 3.0) ** 2 + 0.3 * (TH - 1.5) ** 2
    gap = 1.0 + 0.2 * (R - 3.0)
    apes = np.stack([v0 - gap / 2, v0 + gap / 2], -1)
    psi0 = np.zeros(R.shape + (2,), complex)
    g = np.exp(-((R - 2.5) ** 2 + (TH - 1.2) ** 2))
    psi0[..., 0] = g / np.sqrt((np.abs(g) ** 2).sum())
    return apes, psi0


def case_ldr(rank, world, inputs, outdir):
    from pyqed_tpu_torch.grid.ldr import LDR2Jacobi, LDRN
    mesh = mesh_of("row", world)
    out = {}
    sol, states, psi0 = ldr_model(LDRN, device="cpu")
    sol.build_ovlp(states)
    for method in ("dense", "factored"):
        with collectives() as c:
            rs = sol.run(psi0, mesh=mesh, method=method, **LDR_RUN)
        ru = sol.run(psi0, method=method, **LDR_RUN)
        out[method] = dict(sharded=host(rs.states), unsharded=host(ru.states),
                           psi=host(rs.psi), counts=summary(c))
    j = JACOBI_LDR
    t = LDR2Jacobi(j["dom"], [3, 3], nstates=2, mass=j["mass"],
                   device="cpu")
    apes, psi0 = jacobi_ldr_psi0([np.asarray(x) for x in t.x])
    t.apes = apes
    t.build_ovlp(None)
    rs = t.run(psi0, dt=0.005, nt=20, nout=10, mesh=mesh)
    ru = t.run(psi0, dt=0.005, nt=20, nout=10)
    out["jacobi"] = dict(sharded=host(rs.states), unsharded=host(ru.states))
    return out


def case_fssh(rank, world, inputs, outdir):
    from pyqed_tpu_torch.grid import fssh as tfs
    mesh = mesh_of("walker", world)
    x0, p0 = inputs["fssh_x0"], inputs["fssh_p0"]
    run = inputs["fssh_run"]
    sol = tfs.FSSH(tfs.tully_i(), mass=2000.0, device="cpu")
    fields = ("x", "p", "c", "active", "energy", "population",
              "population_wf")
    fed = sol.trajectories(sol.initial_state(x0, p0),
                           torch.as_tensor(inputs["fssh_draws"]),
                           run["dt"], run["nt"], run["nout"], mesh=mesh)
    out = {"fed": {f: host(getattr(fed, f)) for f in fields}}
    for n in (32, 30):               # 30: chunks of 8, 8, 8 and 6
        rs = sol.run(x0[:n], p0[:n], key=3, mesh=mesh, **run)
        ru = sol.run(x0[:n], p0[:n], key=3, **run)
        out[n] = {f: (host(getattr(rs, f)), host(getattr(ru, f)))
                  for f in fields}
    return out


def sos_model():
    """tests/test_parallel.py::test_photon_echo_t2series_mesh's molecule:
    (energies, dipoles, t2 delays)."""
    dip = np.random.default_rng(3).random((4, 4))
    return np.array([0.0, 1.0, 1.1, 2.05]), dip + dip.T, np.array([0.0, 10.0])


def case_sos(rank, world, inputs, outdir):
    import pyqed_tpu_torch as pt
    from pyqed_tpu_torch.signal.sos import photon_echo_t2series
    mesh = mesh_of("w", world)
    E, dip, t2 = sos_model()
    mol = pt.Mol(np.diag(E), dip)
    mol.gamma = np.full(len(E), 0.02)
    out = {}
    for n in (16, 15):
        w = np.linspace(0.8, 1.3, n)
        kw = dict(e_idx=[1, 2], f_idx=[3], device="cpu")
        out[n] = (host(photon_echo_t2series(mol, w, w, t2, mesh=mesh,
                                            **kw)),
                  host(photon_echo_t2series(mol, w, w, t2, **kw)))
    return out


def _dmc():
    from pyqed_tpu_torch.qmc import dmc as tdmc
    return tdmc.DMC(ndim=3, potential=lambda x: 0.5 * torch.sum(x ** 2))


def case_dmc(rank, world, inputs, outdir):
    mesh = mesh_of("walker", world)
    sol = _dmc()
    run = inputs["dmc_run"]
    x0, xi, u = (torch.as_tensor(a) for a in inputs["dmc_draws"])
    kw = dict(dt=run["dt"], eref=run["eref"])
    out = {}
    E, xf = sol.walk(x0, xi, u, mesh=mesh, **kw)
    Eu, xu = sol.walk(x0, xi, u, **kw)
    out["fed"] = (host(E), host(xf), host(Eu), host(xu))
    n = 250                          # chunks of 63, 63, 63 and 61
    E, xf = sol.walk(x0[:n], xi[:, :n], u, mesh=mesh, **kw)
    Eu, xu = sol.walk(x0[:n], xi[:, :n], u, **kw)
    out["uneven"] = (host(E), host(xf), host(Eu), host(xu))
    own = dict(nsteps=run["nsteps"], dt=run["dt"], eref=run["eref"],
               nequil=run["nequil"], device="cpu")
    Es, trs, xs = sol.run_sharded(5, mesh, nwalkers=run["nwalkers"], **own)
    gen = torch.Generator().manual_seed(5)
    start = torch.randn((run["nwalkers"], 3), generator=gen,
                        dtype=torch.float64) * 0.5
    Er, trr, xr = sol._run(gen, start, own["nsteps"], own["dt"],
                           own["eref"], own["nequil"], None)
    out["run_sharded"] = (host(trs), host(xs), host(trr), host(xr))
    return out


def _pimc():
    from pyqed_tpu_torch.qmc import pimc as tpimc
    return tpimc.PIMC(lambda q: 0.5 * torch.sum(q ** 2) + 0.1 * torch.sum(
        q ** 4), beta=2.0, nbeads=16, ndim=2)


PIMC_CHAIN = dict(npaths=64, nsweeps=100, ntherm=30, step=0.5)


def case_pimc(rank, world, inputs, outdir):
    from pyqed_tpu_torch.qmc import pimc as tpimc
    mesh = mesh_of("walker", world)
    sol = _pimc()
    paths0, draws = inputs["pimc_draws"]
    step = inputs["pimc_run"]["step"]
    draws = [torch.as_tensor(d) for d in draws]
    pf, ys = sol.sweeps(torch.as_tensor(paths0), draws, step=step, mesh=mesh)
    pu, yu = sol.sweeps(torch.as_tensor(paths0), draws, step=step)
    out = {"fed": (host(pf), [host(y) for y in ys], host(pu),
                   [host(y) for y in yu])}
    # independent chains: this rank's chain is the unsharded sweeps of its
    # shard on its own generator's draws, block by block as run() makes them
    c = PIMC_CHAIN
    ev, et, acc, paths = sol.run(4, mesh=mesh, use_shard_map=True,
                                 device="cpu", **c)
    m = c["npaths"] // world
    gen = torch.Generator().manual_seed(4)
    start = 0.5 * torch.randn((c["npaths"], 16, 2), generator=gen,
                              dtype=torch.float64)[rank * m:(rank + 1) * m]
    gen = torch.Generator().manual_seed(tpimc.PIMC.chain_seed(4, rank))
    blocks = [sol.draws(gen, min(tpimc.BLOCK, n - s), m, "cpu")
              for n in (c["ntherm"], c["nsweeps"])
              for s in range(0, n, tpimc.BLOCK)]
    mine = [torch.cat(parts) for parts in zip(*blocks)]
    own, trace = sol.sweeps(start, mine, step=c["step"])
    out["chains"] = dict(est=(ev, et, acc), trace=[host(t) for t in
                                                   sol.trace_],
                         paths=host(paths[rank * m:(rank + 1) * m]),
                         own=host(own),
                         own_trace=[host(t[c["ntherm"]:]) for t in trace])
    return out


def _solid():
    from pyqed_tpu_torch.qmc import qsats as tqs
    sites, box = tqs.fcc_lattice((2, 2, 2), 4.0 / 7.5 ** 3)
    return tqs.QSATS(sites, box, a=0.06, b=5.0, device="cpu")


def case_qsats(rank, world, inputs, outdir):
    mesh = mesh_of("walker", world)
    ts = _solid()
    run = inputs["qsats_run"]
    out = {}
    for mode in ("peratom",):
        q0, draws = inputs["qsats_draws", mode]
        draws = [torch.as_tensor(d) for d in draws]
        res = []
        for m in (mesh, None):
            (q, _), e, acc, eacc = ts.sweeps(
                torch.as_tensor(q0), draws, inputs["qsats_flags"],
                step=run["step"], mode=mode, mesh=m)
            res.append((host(q), host(e), host(acc), host(eacc)))
        out[mode] = res
    kw = dict(nwalkers=8, nsweeps=30, nequil=5, step=0.5, exchange_prob=0.3)
    rs = ts.run(2, mesh=mesh, **kw)
    ru = ts.run(2, **kw)
    out["run"] = (rs, ru)
    return out


SUITES = {
    "parallel": [("mesh_api", case_mesh_api), ("pencil_fft", case_pencil_fft),
                 ("keo", case_keo), ("not_dividing", case_not_dividing),
                 ("heom", case_heom), ("spo", case_spo),
                 ("field2des", case_field2des)],
    # the cases that need the parent's draws come last
    "distributed": [("runtime", case_runtime), ("ldr", case_ldr),
                    ("sos", case_sos), ("fssh", case_fssh),
                    ("dmc", case_dmc), ("pimc", case_pimc),
                    ("qsats", case_qsats)],
}

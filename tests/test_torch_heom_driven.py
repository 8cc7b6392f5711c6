"""Parity of the PyTorch port's driven-dynamics HEOM (pyqed_tpu_torch:
HEOMSolver.run with edip/pulse/t0, checkpoints and resume, the dense
Liouvillian, steady state and propagator, the correlation functions,
absorption, HEOMSolverDrude) with the JAX package, on the CPU at
complex128.

Inputs are made with numpy from a seed and handed to both packages. The
JAX references that run through HEOMSolver.run are jitted there; each is
computed once per module (fixtures) and shared. Tolerances: a driven run
of a few hundred steps rel 1e-12 against JAX, every dense form and
correlation rel 1e-12 (the propagator, built from an eig, 1e-10; the
absorption spectrum 1e-10), a zero-amplitude drive against the undriven
run 1e-14, a chunked run against the single run 1e-12.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.models.pulse import GaussianPulse as JGaussianPulse
from pyqed_tpu.open.bath import DrudeBath as JDrudeBath
from pyqed_tpu.open.heom import HEOMSolver as JHEOMSolver
from pyqed_tpu.open.heom import HEOMSolverDrude as JHEOMSolverDrude
from pyqed_tpu.core.diagnostics import load_checkpoint as j_load

import pyqed_tpu_torch as pt
from pyqed_tpu_torch.core.diagnostics import load_checkpoint
from pyqed_tpu_torch.models.pulse import GaussianPulse
from pyqed_tpu_torch.open.heom import (HEOMSolver, HEOMSolverDrude,
                                       solver_from_reference)

RTOL = 1e-12
N = 3
RNG = np.random.default_rng(21)
H3 = RNG.standard_normal((N, N))
H3 = 0.5 * (H3 + H3.T)
MU3 = RNG.standard_normal((N, N))
MU3 = MU3 + MU3.T
RHO3 = np.diag([1.0, 0.0, 0.0]).astype(complex)
EOPS3 = [np.diag(np.eye(N)[k]) for k in range(N)]
RUN = dict(dt=0.05, nt=200, nout=10, t0=0.7)
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SZ = np.diag([1.0, -1.0])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def field(t, xp=np):
    """A chirp-free Gaussian-enveloped drive, in NumPy for the port (a
    float for a float) and in jax.numpy for the JAX package."""
    return 0.4 * xp.exp(-((t - 3.0) ** 2) / 8.0) * xp.cos(1.3 * t)


def host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def rel_err(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def jax_solver3():
    """A 3-level JAX solver with site-projector couplings (so that every
    port kernel, rowcol included, applies): two Matsubara baths, lmax 2."""
    c, nu = JDrudeBath(temperature=0.5, cutoff=0.5, reorg=0.05).matsubara(1)
    Qs = [np.diag(np.eye(N)[s]) for s in (1, 2)]
    return JHEOMSolver(H3, bath=[(Q, c, nu) for Q in Qs], lmax=2)


def port_of(js, kernel=None):
    return solver_from_reference(js._H_np, js._modes, js.lmax, device="cpu",
                                 kernel=kernel)


def jax_solver2(lmax=3, nexp=1, Q=SZ, H=None):
    """The two-level solver of tests/test_heom.py:225-270."""
    H = 0.5 * SZ + 0.2 * SX if H is None else H
    b = JDrudeBath(temperature=0.5, cutoff=0.5, reorg=0.05)
    b.set_bath_ops([jnp.asarray(Q.astype(complex))])
    return JHEOMSolver(jnp.asarray(H, dtype=complex), bath=b, lmax=lmax,
                       nexp=nexp)


@pytest.fixture(scope="module")
def driven_ref():
    js = jax_solver3()
    res = js.run(RHO3, e_ops=EOPS3, edip=MU3, pulse=lambda t: field(t, jnp),
                 kernel="einsum", **RUN)
    return js, res


def compare_result(tr, jr, fields, tol):
    for f in fields:
        assert rel_err(getattr(tr, f), getattr(jr, f)) <= tol, f


# ------------------------------------------------------------- the drive
@pytest.mark.parametrize("kernel", ["einsum", "matmul", "levels", "rowcol",
                                    "cuda"])
def test_driven_run_matches_jax(driven_ref, kernel):
    """H + E(t) mu with E a plain function of t, t0 != 0: every right-hand
    side of the port against the JAX einsum run."""
    js, jr = driven_ref
    tr = port_of(js, kernel).run(RHO3, e_ops=EOPS3, edip=MU3, pulse=field,
                                 **RUN)
    compare_result(tr, jr, ("times", "observables", "states", "rho", "ado"),
                   RTOL)
    assert (tr.dt, tr.nt, tr.nout) == (jr.dt, jr.nt, jr.nout)


def test_driven_gaussian_pulse_euler_store_ados_matches_jax():
    """The port's GaussianPulse.efield drives the port as the JAX
    GaussianPulse.efield drives JAX, Euler steps, every ADO stored."""
    js = jax_solver3()
    kw = dict(omegac=1.1, tau=1.5, tc=2.0, amplitude=0.3)
    run = dict(dt=0.02, nt=120, nout=20, t0=-0.4, method="euler",
               store_ados=True)
    jr = js.run(RHO3, e_ops=EOPS3, edip=MU3, pulse=JGaussianPulse(**kw).efield,
                kernel="einsum", **run)
    tr = port_of(js).run(RHO3, e_ops=EOPS3, edip=MU3,
                         pulse=GaussianPulse(**kw).efield, **run)
    compare_result(tr, jr, ("observables", "states", "ado"), RTOL)


@pytest.mark.parametrize("kernel", ["einsum", "cuda"])
def test_zero_amplitude_drive_equals_undriven(kernel):
    ts = port_of(jax_solver3(), kernel)
    run = dict(RUN, t0=0.0)
    ref = ts.run(RHO3, e_ops=EOPS3, **run)
    res = ts.run(RHO3, e_ops=EOPS3, edip=MU3, pulse=lambda t: 0.0, **run)
    for f in ("observables", "ado"):
        assert np.max(np.abs(host(getattr(res, f))
                             - host(getattr(ref, f)))) <= 1e-14, f


def test_zero_coupling_matches_von_neumann():
    """tests/test_heom.py:21: a vanishing bath leaves the driven von
    Neumann equation, integrated here by a NumPy RK4 on the same grid."""
    I, sx, sy, sz = [np.asarray(p) for p in pt.pauli()]
    H = 0.5 * sz
    bath = pt.DrudeBath(temperature=0.5, cutoff=0.5, reorg=1e-10)
    bath.set_bath_ops([sz])
    sol = HEOMSolver(H, bath=bath, lmax=2, decomposition="pade", nexp=2,
                     device="cpu")
    rho = np.array([[1.0, 0], [0, 0]], complex)
    dt, nt = 0.002, 500
    res = sol.run(rho, dt=dt, nt=nt, e_ops=[sz], edip=sx,
                  pulse=lambda t: 0.2 * np.cos(t))
    traj = [np.trace(sz @ rho).real]

    def rhs(r, t):
        Ht = H + sx * (0.2 * np.cos(t))
        return -1j * (Ht @ r - r @ Ht)

    for k in range(nt):
        t = k * dt
        k1 = rhs(rho, t)
        k2 = rhs(rho + dt / 2 * k1, t + dt / 2)
        k3 = rhs(rho + dt / 2 * k2, t + dt / 2)
        k4 = rhs(rho + dt * k3, t + dt)
        rho = rho + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        traj.append(np.trace(sz @ rho).real)
    assert np.max(np.abs(host(res.observables[:, 0].real) - traj)) < 1e-8


def test_driven_with_bath_physical():
    """tests/test_heom.py:72: with a real bath the driven state stays a
    density matrix."""
    sol = port_of(jax_solver3())
    res = sol.run(RHO3, dt=0.02, nt=500, edip=MU3,
                  pulse=lambda t: 0.3 * np.cos(t))
    rho = host(res.rho)
    assert abs(np.trace(rho) - 1.0) < 1e-8
    assert np.max(np.abs(rho - rho.conj().T)) < 1e-8
    w = np.linalg.eigvalsh(rho)
    assert w.min() > -1e-6 and w.max() < 1.0 + 1e-6


# ----------------------------------------------------------- checkpoints
def test_chunked_equals_single_run_driven(tmp_path):
    """tests/test_heom.py:52: windows checkpointed every 7 see the absolute
    time, so the chunked run equals the single one."""
    ts = port_of(jax_solver3())
    kw = dict(e_ops=EOPS3, edip=MU3, pulse=field, **RUN)
    r1 = ts.run(RHO3, **kw)
    ck = tmp_path / "ck.npz"
    r2 = ts.run(RHO3, checkpoint=str(ck), checkpoint_every=7, **kw)
    for f in ("observables", "states", "ado"):
        assert np.max(np.abs(host(getattr(r1, f))
                             - host(getattr(r2, f)))) <= 1e-12, f
    step, (ados,), meta = load_checkpoint(ck)
    assert step == RUN["nt"] // RUN["nout"]
    assert np.max(np.abs(host(ados) - host(r1.ado))) <= 1e-12
    assert float(meta["dt"]) == RUN["dt"] and int(meta["nout"]) == RUN["nout"]


def test_run_accepts_t0_and_checkpoint_every():
    """The keywords of pyqed_tpu/open/heom.py:342-345 are accepted (they
    raised TypeError before); undriven and unchecked, they change
    nothing."""
    ts = port_of(jax_solver3())
    kw = dict(dt=0.05, nt=20, nout=5, e_ops=EOPS3)
    a = ts.run(RHO3, **kw)
    b = ts.run(RHO3, t0=3.0, checkpoint_every=3, **kw)
    assert torch.equal(a.observables, b.observables)
    assert torch.equal(a.times, b.times)


def _misc_solver():
    """The solver of tests/test_misc.py:126 (two-level, Matsubara, lmax 3)."""
    c, nu = JDrudeBath(temperature=1.0, cutoff=0.5, reorg=0.1).matsubara(1)
    return JHEOMSolver(np.array([[1.0, 0.2], [0.2, -1.0]]),
                       bath=[(np.diag([1.0, -1.0]), c, nu)], lmax=3)


@pytest.fixture(scope="module")
def misc_full():
    js = _misc_solver()
    return js, js.run(np.diag([1.0, 0.0]), dt=0.01, nt=60, nout=10,
                      e_ops=[np.diag([1.0, 0.0])])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(misc_full, tmp_path, writer):
    """tests/test_misc.py:126: a checkpoint written after 3 of 6 windows
    by one package resumes in the other and gives the full run's rows from
    window 3 on (times counted from that window)."""
    js, full = misc_full
    ts = port_of(js)
    rho0 = np.diag([1.0, 0.0])
    kw = dict(dt=0.01, nout=10, e_ops=[np.diag([1.0, 0.0])])
    ck = str(tmp_path / "heom.npz")
    if writer == "jax":
        js.run(rho0, nt=30, checkpoint=ck, checkpoint_every=2, **kw)
        step = load_checkpoint(ck)[0]
        res = ts.run(rho0, nt=60, resume=ck, **kw)
    else:
        ts.run(rho0, nt=30, checkpoint=ck, checkpoint_every=2, **kw)
        step = j_load(ck)[0]
        res = js.run(rho0, nt=60, resume=ck, **kw)
    assert step == 3
    for f in ("observables", "times"):
        assert rel_err(getattr(res, f), np.asarray(getattr(full, f))[3:]) \
            <= RTOL, f
    assert rel_err(res.rho, full.rho) <= RTOL


# ----------------------------------------------------------- dense forms
@pytest.fixture(scope="module")
def dense_ref():
    js = jax_solver2()
    return js, dict(L=np.asarray(js.liouvillian_dense()),
                    ss=np.asarray(js.steady_state()),
                    ss_full=np.asarray(js.steady_state(full=True)))


def test_liouvillian_dense_matches_jax(dense_ref):
    js, ref = dense_ref
    ts = port_of(js)
    L = ts.liouvillian_dense()
    assert L.shape == ref["L"].shape and L.dtype == torch.complex128
    assert rel_err(L, ref["L"]) <= RTOL
    assert rel_err(ts.liouvillian_dense(kernel="cuda"), ref["L"]) <= RTOL


def test_steady_state_matches_jax(dense_ref):
    js, ref = dense_ref
    ts = port_of(js)
    rho = ts.steady_state()
    assert rel_err(rho, ref["ss"]) <= RTOL
    assert abs(np.trace(host(rho)) - 1.0) < 1e-12
    assert rel_err(ts.steady_state(full=True), ref["ss_full"]) <= RTOL


def test_steady_state_warns_when_degenerate():
    """Pure dephasing ([H, Q] = 0) conserves every population."""
    js = jax_solver2(lmax=1, H=0.5 * SZ)
    with pytest.warns(UserWarning, match="degenerate"):
        port_of(js).steady_state()


def test_propagator_matches_jax_and_run():
    """The eig-built propagators against JAX's (they do not depend on how
    the eigenvectors are scaled), and the last one against run()
    (tests/test_heom.py:104)."""
    js = jax_solver2(lmax=2)
    nt, dt = 40, 0.02
    ref = np.asarray(js.propagator(dt, 3))
    ts = port_of(js)
    Us = ts.propagator(dt, 3)
    assert Us.shape == ref.shape
    assert rel_err(Us, ref) <= 1e-10
    U = host(ts.propagator(dt, nt)[-1])
    nado = U.shape[0] // 4
    ados0 = np.zeros((nado, 2, 2), complex)
    ados0[0] = np.diag([1.0, 0.0])
    res = ts.run(np.diag([1.0, 0.0]), dt=dt, nt=nt, nout=nt)
    assert np.max(np.abs(host(res.rho)
                         - (U @ ados0.ravel()).reshape(nado, 2, 2)[0])) < 1e-7


# ----------------------------------------------------------- correlations
@pytest.fixture(scope="module")
def corr_ref(dense_ref):
    js, ref = dense_ref
    rho0 = np.array([[0.7, 0.2], [0.2, 0.3]], complex)
    ops = [SX.astype(complex), SZ.astype(complex), SX.astype(complex)]
    return js, rho0, ops, dict(
        c3_1t=np.asarray(js.correlation_3op_1t(rho0, ops, dt=0.02, nt=30,
                                               nout=1)),
        c2_1t=np.asarray(js.correlation_2op_1t(rho0, SX, SZ, 0.02, 25)),
        c3_2t=np.asarray(js.correlation_3op_2t(rho0, ops, dt=0.02, nt=5,
                                               ntau=12)),
        c2_1t_ss=np.asarray(js.correlation_2op_1t(
            None, SX, SZ, 0.02, 15, ados0=jnp.asarray(ref["ss_full"]))))


def test_correlation_3op_1t_matches_jax(corr_ref):
    js, rho0, ops, ref = corr_ref
    got = port_of(js).correlation_3op_1t(rho0, ops, dt=0.02, nt=30, nout=1)
    assert rel_err(got, ref["c3_1t"]) <= RTOL


@pytest.mark.parametrize("kernel", [None, "cuda"])
def test_correlation_2op_1t_matches_jax(corr_ref, kernel):
    """Both branches: through run() from rho0, and the tau leg of
    correlation_3op_2t from the stationary stack."""
    js, rho0, ops, ref = corr_ref
    ts = port_of(js, kernel)
    assert rel_err(ts.correlation_2op_1t(rho0, SX, SZ, 0.02, 25),
                   ref["c2_1t"]) <= RTOL
    ss = ts.steady_state(full=True)
    assert rel_err(ts.correlation_2op_1t(None, SX, SZ, 0.02, 15, ados0=ss),
                   ref["c2_1t_ss"]) <= RTOL


def test_correlation_3op_2t_matches_jax(corr_ref):
    js, rho0, ops, ref = corr_ref
    got = port_of(js).correlation_3op_2t(rho0, ops, dt=0.02, nt=5, ntau=12)
    assert got.shape == (5, 12)
    assert rel_err(got, ref["c3_2t"]) <= RTOL
    # row t = 0 is the one-time correlator (tests/test_heom.py:116)
    assert rel_err(got[0], ref["c3_1t"][:12]) <= RTOL


def test_equilibrium_correlator_stationary_from_full_steady_seed():
    """tests/test_heom.py:251: seeded from the full stationary stack the
    correlator does not depend on the waiting time."""
    ts = port_of(jax_solver2())
    corr = host(ts.correlation_3op_2t(None, [SX, SZ, SX], dt=0.02, nt=30,
                                      ntau=6,
                                      ados0=ts.steady_state(full=True)))
    assert np.max(np.abs(corr[-1] - corr[0])) < 1e-12


def test_absorption_matches_jax():
    """tests/test_heom.py:331's two-level system: the same automatic dt
    (from ||H||_2 and the deepest ADO's rate) and the same spectrum."""
    E = 1.0
    js = jax_solver2(lmax=3, Q=SX, H=np.diag([0.0, E]))
    omegas = np.linspace(0.5, 1.5, 41)
    ref = np.asarray(js.absorption(omegas, SX, ntau=300))
    got = port_of(js).absorption(omegas, SX, ntau=300)
    assert isinstance(got, np.ndarray) and got.shape == omegas.shape
    assert rel_err(got, ref) <= 1e-10


# ------------------------------------------------------- HEOMSolverDrude
@pytest.mark.parametrize("method", ["euler-seq", "rk4"])
def test_heom_solver_drude_matches_jax(method):
    """The reference's high-T Drude solver: its sequential in-place Euler
    and the RK4 hierarchy with the terminator at nado - 2."""
    H = 0.5 * SZ + 0.1 * SX
    jd = JHEOMSolverDrude(jnp.asarray(H), c_ops=[jnp.asarray(SZ)])
    td = solver_from_reference(np.asarray(jd.H), None, None, device="cpu",
                               c_ops=jd.c_ops)
    assert isinstance(td, HEOMSolverDrude)
    kw = dict(dt=0.01, nt=150, temperature=0.5, cutoff=0.5,
              reorganization=0.05, nado=5, method=method,
              e_ops=[SZ.astype(complex), SX.astype(complex)])
    rho0 = np.array([[0.6, 0.3], [0.3, 0.4]], complex)
    jr = jd.run(rho0, **kw)
    tr = td.run(rho0, **kw)
    compare_result(tr, jr, ("times", "observables", "rho", "ado"), RTOL)
    assert tr.ado.shape == np.asarray(jr.ado).shape


def test_heom_solver_drude_device_default_and_root_export():
    assert pt.HEOMSolverDrude is HEOMSolverDrude
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            HEOMSolverDrude(np.eye(2), c_ops=[SZ])

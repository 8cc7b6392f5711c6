"""Parity of the PyTorch port's Lindblad/Redfield slice (pyqed_tpu_torch)
with the JAX package (pyqed_tpu), on the CPU at complex128: the time-loop
driver, LindbladSolver (both right-hand sides, the propagator method, the
time-dependent form, the steady state and the correlation suite),
LiouvilleSolver, absorption_eseries, RedfieldSolver (secular and full),
FMO.redfield, and the config #2 vibronic dimer end to end.

Inputs are made with numpy from a seed and handed to both packages.
Propagated fields are held to 1e-10. Eigenvectors are fixed only up to
phases, so the Redfield and Liouville results are compared where they do
not depend on them: in the site basis, or with operators expressed in
each solver's own eigenbasis.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.models.named import FMO as JFMO
from pyqed_tpu.open import lindblad as j_lb
from pyqed_tpu.open import redfield as j_rf
from pyqed_tpu.core import dynamics as j_dyn
from pyqed_tpu.ops import superoperator as j_sop

import pyqed_tpu_torch as pt
from pyqed_tpu_torch.core import dynamics as t_dyn
from pyqed_tpu_torch.ops import kernels as kn
from pyqed_tpu_torch.ops import superoperator as t_sop

TOL = 1e-10        # propagated fields and Result entries
RTOL = 1e-12       # exact algebra


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def crand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def close(ours, ref, tol=TOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    return np.max(np.abs(ours - ref)) <= tol


def same_spectrum(a, b, tol):
    """The two eigenvalue lists agree as sets (sorted by real, then
    imaginary part, each rounded to 1e-9 so that pairs split by rounding
    sort alike)."""
    a, b = (np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in (a, b))
    key = lambda e: e[np.lexsort((np.round(e.imag, 9), np.round(e.real, 9)))]
    return close(key(a), key(b), tol)


def system(n=4, seed=1, njump=2):
    """Random Hermitian H, jump operators, a density matrix and two
    observables."""
    rng = np.random.default_rng(seed)
    H = crand(rng, n, n)
    H = (H + H.conj().T) / 2
    cs = [0.3 * crand(rng, n, n) for _ in range(njump)]
    psi = crand(rng, n)
    rho0 = np.outer(psi, psi.conj())
    rho0 /= np.trace(rho0)
    e_ops = [np.diag(rng.random(n)), (lambda a: a + a.conj().T)(
        crand(rng, n, n))]
    return H, cs, rho0, e_ops


# ------------------------------------------------------- core/dynamics
def test_run_solver_matches_jax():
    rng = np.random.default_rng(0)
    n = 3
    A = crand(rng, n, n)
    A = (A + A.conj().T) / 2
    psi0 = crand(rng, n)
    e_ops = [np.diag([1.0, 0, 0]), A]

    def stepper(mod, M):
        step = mod.rk4_step(lambda y: -1j * (M @ y))
        return lambda y, tt: step(y, tt, 0.05)

    jr = j_dyn.run_solver(stepper(j_dyn, jnp.asarray(A)), jnp.asarray(psi0),
                          0.05, 12, e_ops=e_ops, nout=3, t0=0.5,
                          store_states=True)
    tr = t_dyn.run_solver(stepper(t_dyn, torch.as_tensor(A)),
                          torch.as_tensor(psi0), 0.05, 12, e_ops=e_ops,
                          nout=3, t0=0.5, store_states=True)
    for f in ("times", "observables", "states", "psi", "psi0"):
        assert close(getattr(tr, f), getattr(jr, f)), f
    assert tr.rho is None and (tr.dt, tr.nt, tr.nout) == (0.05, 12, 3)
    # density matrices: expect_dm, and no observables without e_ops
    rho0 = np.outer(psi0, psi0.conj())
    jr = j_dyn.run_solver(lambda y, tt: y, jnp.asarray(rho0), 0.1, 4)
    tr = t_dyn.run_solver(lambda y, tt: y, torch.as_tensor(rho0), 0.1, 4)
    assert tr.observables is None and jr.observables is None
    assert close(tr.rho, jr.rho) and close(tr.times, jr.times)
    with pytest.raises(ValueError, match="divisible"):
        t_dyn.propagate(lambda y, tt: y, torch.as_tensor(psi0), 0.0, 0.1, 5,
                        nout=2)


def test_rk4_step_t_passes_stage_times():
    seen = []

    def rhs(y, tt):
        seen.append(tt)
        return y * 0
    t_dyn.rk4_step_t(rhs)(torch.ones(1), 1.0, 0.2)
    assert seen == [1.0, 1.1, 1.1, 1.2]
    ops = torch.stack([torch.eye(2, dtype=torch.complex128)] * 2)
    psi = torch.tensor([0.6, 0.8j], dtype=torch.complex128)
    assert close(t_dyn.expect_ket(ops, psi), [1.0, 1.0], RTOL)
    assert close(t_dyn.expect_dm(ops, torch.outer(psi, psi.conj())),
                 [1.0, 1.0], RTOL)


# ------------------------------------------------------- LindbladSolver
_JAX = {}


def jax_lindblad(key, make):
    if key not in _JAX:
        _JAX[key] = make()
    return _JAX[key]


def jax_run(store_states=True, method="rk4"):
    H, cs, rho0, e_ops = system()
    return jax_lindblad(("run", store_states, method), lambda: j_lb.
                        LindbladSolver(jnp.asarray(H), [jnp.asarray(c)
                                                        for c in cs]).run(
        jnp.asarray(rho0), dt=0.01, Nt=60, nout=6, e_ops=e_ops,
        store_states=store_states, method=method))


@pytest.mark.parametrize("kernel", [None, "cuda", "pallas", "matmul"])
def test_lindblad_run_matches_jax(kernel):
    H, cs, rho0, e_ops = system()
    jr = jax_run()
    kn.liouvillian_commutator.launches = 0
    tr = pt.LindbladSolver(H, cs, kernel=kernel, device="cpu").run(
        rho0, dt=0.01, Nt=60, nout=6, e_ops=e_ops, store_states=True)
    assert kn.liouvillian_commutator.launches == 0      # CPU: plain version
    for f in ("times", "observables", "states", "rho", "rho0"):
        assert close(getattr(tr, f), getattr(jr, f)), f
    assert (tr.dt, tr.nt, tr.nout) == (jr.dt, jr.nt, jr.nout)


@pytest.mark.parametrize("store_states", [True, False])
def test_lindblad_propagator_method_matches_jax(store_states):
    H, cs, rho0, e_ops = system()
    jr = jax_run(store_states, "propagator")
    sol = pt.LindbladSolver(H, cs, device="cpu")
    tr = sol.run(rho0, dt=0.01, Nt=60, nout=6, e_ops=e_ops,
                 store_states=store_states, method="propagator")
    fields = ["times", "observables", "rho"] + (
        ["states"] if store_states else [])
    for f in fields:
        assert close(getattr(tr, f), getattr(jr, f)), f
    assert tr.rho0 is None and jr.rho0 is None
    # the same stepping as method='rk4'
    rk = sol.run(rho0, dt=0.01, Nt=60, nout=6, e_ops=e_ops)
    assert close(tr.observables, rk.observables.numpy())
    # no e_ops: an empty (Nt // nout, 0) block, as in the JAX package
    empty = sol.run(rho0, dt=0.01, Nt=60, nout=6, method="propagator")
    assert tuple(empty.observables.shape) == (10, 0)


def test_lindblad_time_dependent_matches_jax():
    H, cs, rho0, e_ops = system(njump=1)
    mu = np.array(e_ops[1])
    jr = jax_lindblad("drive", lambda: j_lb.LindbladSolver(
        [jnp.asarray(H), [jnp.asarray(mu), lambda s: 0.3 * jnp.cos(2 * s)]],
        [jnp.asarray(cs[0])]).run(jnp.asarray(rho0), dt=0.01, Nt=40, nout=4,
                                  e_ops=e_ops, t0=0.2))
    tr = pt.LindbladSolver([H, [mu, lambda s: 0.3 * np.cos(2 * s)]], cs[:1],
                           device="cpu").run(rho0, dt=0.01, Nt=40, nout=4,
                                             e_ops=e_ops, t0=0.2)
    for f in ("times", "observables", "rho"):
        assert close(getattr(tr, f), getattr(jr, f)), f


def test_driven_dissipative_dynamics_matches_jax():
    H, cs, rho0, e_ops = system(njump=1)

    class Pulse:
        def __init__(self, cos):
            self.cos = cos

        def efield(self, s):
            return 0.2 * self.cos(3 * s)

    kw = dict(c_ops=cs[:1], dt=0.02, Nt=20, obs_ops=e_ops, nout=5)
    jr = j_lb.driven_dissipative_dynamics(H, e_ops[1], rho0,
                                          Pulse(jnp.cos), **kw)
    tr = pt.driven_dissipative_dynamics(H, e_ops[1], rho0, Pulse(np.cos),
                                        device="cpu", **kw)
    assert close(tr.observables, jr.observables)


def test_lindblad_steady_state_and_liouvillian_match_jax():
    H, cs, _, _ = system()
    js = j_lb.LindbladSolver(jnp.asarray(H), [jnp.asarray(c) for c in cs])
    ts = pt.LindbladSolver(H, cs, device="cpu")
    assert close(ts.liouvillian(), js.liouvillian(), RTOL)
    ss = ts.steady_state()
    assert close(ss, js.steady_state())
    assert abs(torch.trace(ss).item() - 1) < RTOL
    L = ts.liouvillian()
    assert (L @ ss.reshape(-1)).abs().max().item() < TOL


@pytest.mark.parametrize("which", ["3op_1t", "2op_1t", "4op_1t", "3op_2t",
                                   "4op_2t"])
def test_lindblad_correlations_match_jax(which):
    H, cs, rho0, e_ops = system(n=3, njump=1)
    rng = np.random.default_rng(9)
    A, B, C, D = (crand(rng, 3, 3) for _ in range(4))
    calls = {
        "3op_1t": lambda s, X: s.correlation_3op_1t(X(rho0), [A, B, C],
                                                    dt=0.02, Nt=10),
        "2op_1t": lambda s, X: s.correlation_2op_1t(X(rho0), A, B, 0.02, 10),
        "4op_1t": lambda s, X: s.correlation_4op_1t(X(rho0), [A, B, C, D],
                                                    dt=0.02, Nt=10),
        "3op_2t": lambda s, X: s.correlation_3op_2t(X(rho0), [A, B, C],
                                                    0.02, 4, 3),
        "4op_2t": lambda s, X: s.correlation_4op_2t(X(rho0), [A, B, C, D],
                                                    0.02, 4, 3),
    }
    js = j_lb.LindbladSolver(jnp.asarray(H), [jnp.asarray(cs[0])])
    ts = pt.LindbladSolver(H, cs, device="cpu")
    ref = calls[which](js, jnp.asarray)
    out = calls[which](ts, torch.as_tensor)
    assert close(out, ref)


def test_lindblad_run_takes_strided_and_conjugate_views():
    """rho0 given as a transposed or lazily conjugated view runs as its
    dense copy (the commutator kernel takes neither view)."""
    H, cs, rho0, e_ops = system()
    sol = pt.LindbladSolver(H, cs, device="cpu")
    kw = dict(dt=0.01, Nt=6, nout=3, e_ops=e_ops)
    ref = sol.run(rho0, **kw).observables
    dense = torch.as_tensor(rho0)
    views = (dense.mT.contiguous().mT,                      # strided
             torch.as_tensor(rho0.conj()).conj(),           # lazy conj
             torch.as_tensor(rho0.conj().T.copy()).mH)      # both
    assert not views[0].is_contiguous() and views[1].is_conj()
    for view in views:
        assert close(sol.run(view, **kw).observables, ref.numpy(), 0.0)


def test_two_level_decay_is_exponential():
    """The README's CPU example: p1(t) = e^{-gamma t} through the kernel
    path (its plain version on the CPU)."""
    gamma = 0.1
    res = pt.LindbladSolver(np.diag([0.0, 1.0]),
                            [np.sqrt(gamma) * pt.sigmam()], device="cpu").run(
        pt.ket2dm(pt.basis(2, 1)), dt=0.05, Nt=200, nout=20,
        e_ops=[pt.ket2dm(pt.basis(2, 1))])
    p1 = res.observables[:, 0].real.numpy()
    assert np.max(np.abs(p1 - np.exp(-gamma * res.times.numpy()))) < 1e-8


# ------------------------------------------------------ LiouvilleSolver
@pytest.mark.parametrize("which", ["evolve", "2op_1t", "2op_1w", "3op_1t",
                                   "3op_1w", "3op_2t", "4op_2t"])
def test_liouville_solver_matches_jax(which):
    H, cs, rho0, e_ops = system(n=3, njump=1)
    rng = np.random.default_rng(4)
    A, B, C, D = (crand(rng, 3, 3) for _ in range(4))
    ts_ = np.linspace(0.0, 2.0, 5)
    ws = np.linspace(-2.0, 2.0, 6)      # w = 0 hits the steady-state pole
    calls = {
        "evolve": lambda s: s.evolve(rho0, ts_, e_ops).observables,
        "2op_1t": lambda s: s.correlation_2op_1t(rho0, [A, B], ts_),
        "2op_1w": lambda s: s.correlation_2op_1w(rho0, [A, B], ws),
        "3op_1t": lambda s: s.correlation_3op_1t(rho0, [A, B, C], ts_),
        "3op_1w": lambda s: s.correlation_3op_1w(rho0, [A, B, C], ws),
        "3op_2t": lambda s: s.correlation_3op_2t(rho0, [A, B, C], ts_[:3],
                                                 ts_[:4]),
        "4op_2t": lambda s: s.correlation_4op_2t(rho0, [A, B, C, D],
                                                 ts_[:3], ts_[:4]),
    }
    js = j_lb.LiouvilleSolver(jnp.asarray(H), [jnp.asarray(cs[0])])
    ts = pt.Lindblad_solver(H, cs, device="cpu")
    ref, out = calls[which](js), calls[which](ts)
    assert close(out, ref, 1e-9 * max(1.0, np.max(np.abs(np.asarray(ref)))))
    if which == "evolve":
        assert close(ts.L, js.L, RTOL)
        assert same_spectrum(ts.eigvals, js.eigvals, 1e-10)


def test_absorption_eseries_matches_jax():
    H = np.diag([0.0, 1.0]).astype(complex)
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    L = np.asarray(j_sop.liouvillian(H, [np.sqrt(0.1) * np.array(
        [[0.0, 1.0], [0.0, 0.0]])]))
    rho0 = np.diag([1.0, 0.0]).astype(complex)
    w = np.linspace(0.5, 1.5, 41)
    for ntrans in (None, 2):
        ref = j_lb.absorption_eseries(w, L, sx, rho0, ntrans=ntrans)
        out = pt.absorption_eseries(w, torch.tensor(L), sx, rho0,
                                    ntrans=ntrans, device="cpu")
        assert close(out, ref, 1e-9)


# ------------------------------------------------------- RedfieldSolver
def redfield_system():
    n = 3
    H = np.diag([0.0, 0.5, 1.2]) + 0.1 * (np.eye(n, k=1) + np.eye(n, k=-1))
    a_op = np.zeros((n, n))
    a_op[0, 1] = a_op[1, 0] = 1.0
    a_op[1, 2] = a_op[2, 1] = 1.0
    spectrum = lambda w: 0.1 * np.where(w > 0, 1.0, np.exp(2.0 * w)) + 0.02j
    rho0 = np.zeros((n, n), dtype=complex)
    rho0[2, 2] = 1.0
    return H, a_op, spectrum, rho0


@pytest.mark.parametrize("secular", [False, True])
def test_redfield_evolve_matches_jax_in_site_basis(secular):
    H, a_op, spectrum, rho0 = redfield_system()
    kw = dict(c_ops=[a_op], spectra=[spectrum],
              sec_cutoff=1e-6 if secular else None)
    js = j_rf.RedfieldSolver(jnp.asarray(H), **kw)
    ts = pt.RedfieldSolver(H, device="cpu", **kw)
    e_ops = [np.diag([1.0, 0, 0]), a_op]
    run = dict(dt=0.05, Nt=40, nout=8, e_ops=e_ops, store_states=True)
    jr, tr = js.evolve(jnp.asarray(rho0), **run), ts.run(rho0, **run)
    for f in ("times", "observables", "states", "rho", "rho0"):
        assert close(getattr(tr, f), getattr(jr, f)), f
    assert tr.psi is None and jr.psi is None
    assert close(ts.steady_state(), js.steady_state())
    # R itself is basis dependent; its spectrum is not
    assert same_spectrum(np.linalg.eigvals(ts.R.numpy()),
                         np.linalg.eigvals(np.asarray(js.R)), 1e-12)


def test_redfield_propagator_and_correlations_match_jax():
    H, a_op, spectrum, rho0 = redfield_system()
    js = j_rf.RedfieldSolver(jnp.asarray(H), c_ops=[a_op], spectra=[spectrum])
    ts = pt.RedfieldSolver(H, c_ops=[a_op], spectra=[spectrum], device="cpu")
    js.redfield_tensor()
    ts.redfield_tensor()
    tau = np.array([0.0, 0.4, 1.1])
    js.propagator(tau)
    ts.propagator(tau)
    e_ops = [np.diag([1.0, 0, 0]), a_op]
    assert close(ts.expect(rho0, e_ops), js.expect(jnp.asarray(rho0), e_ops))
    assert tuple(ts.gf(tau).shape) == (9, 9, 3)

    def eb(x, evecs):       # an operator in a solver's own eigenbasis
        U = np.asarray(evecs)
        return U.conj().T @ x @ U

    A, B = a_op, np.diag([0.0, 1.0, 2.0])
    for s, mod in ((js, j_sop), (ts, t_sop)):
        s._c2 = s.correlation_2op_1t(
            eb(rho0, s.evecs), np.asarray(mod.left(eb(A, s.evecs))),
            np.asarray(mod.left(eb(B, s.evecs))), tau)
        s._c4 = s.correlation_4op_3t(
            eb(rho0, s.evecs), [eb(X, s.evecs) for X in (A, B, B, A)],
            "l-+r", tau)
    assert close(ts._c2, js._c2)
    assert close(ts._c4, js._c4)
    with pytest.raises(ValueError):
        ts.correlation_4op_3t(rho0, [A, B, A], "lll", tau)


def test_redfield_a_ops_bath_and_tensor_function():
    H, a_op, spectrum, rho0 = redfield_system()
    bath = pt.DrudeBath(temperature=1.0, cutoff=0.5, reorg=0.05)
    ts = pt.RedfieldSolver(H, a_ops=[(a_op, bath)], device="cpu")
    R, evecs = pt.redfield_tensor(H, [a_op], [bath.redfield_spectrum()],
                                  device="cpu")
    assert close(ts.redfield_tensor()[0], R, 0.0)
    with pytest.raises(TypeError, match="Hermitian"):
        pt.redfield_tensor(H, [np.triu(a_op)], [spectrum], device="cpu")
    with pytest.raises(TypeError, match="spectral"):
        pt.RedfieldSolver(H, c_ops=[a_op], device="cpu").redfield_tensor()


def test_fmo_redfield_matches_jax():
    jm, m = JFMO(), pt.FMO()
    jr = jm.redfield().run(jm.initial_state(0), dt=10.0, Nt=40, nout=10,
                           e_ops=jm.site_projectors())
    tr = m.redfield(device="cpu").run(m.initial_state(0), dt=10.0, Nt=40,
                                      nout=10, e_ops=m.site_projectors())
    for f in ("times", "observables", "rho"):
        assert close(getattr(tr, f), getattr(jr, f)), f
    assert abs(tr.observables[-1].real.sum().item() - 1) < TOL


# ----------------------------------------------- config #2, end to end
def vibronic_dimer(nvib=8):
    """bench.py's _vibronic_dimer: 2 electronic states x nvib levels."""
    n = 2 * nvib
    w0, de, g = 0.2, 1.0, 0.15
    H = np.zeros((n, n))
    for s in range(2):
        for v in range(nvib):
            H[s * nvib + v, s * nvib + v] = s * de + w0 * v
    for v in range(nvib - 1):
        H[nvib + v, v + 1] = H[v + 1, nvib + v] = g
    c = np.zeros((n, n))
    for v in range(1, nvib):
        c[v - 1, v] = 0.1 * np.sqrt(v)
        c[nvib + v - 1, nvib + v] = 0.1 * np.sqrt(v)
    return H, c


@pytest.mark.parametrize("kernel", [None, "matmul"])
def test_config2_dimer_matches_jax(kernel):
    """n = 16, one jump operator, rho0 = |8><8|, 200 steps of 0.002
    (the bench's dt and nout), every level population: every Result
    field against the JAX solver."""
    H, c = vibronic_dimer()
    n = H.shape[0]
    rho0 = np.zeros((n, n))
    rho0[n // 2, n // 2] = 1.0
    e_ops = [np.diag(np.eye(n)[k]) for k in range(n)]
    run = dict(dt=0.002, Nt=200, nout=50, e_ops=e_ops, store_states=True)
    jr = jax_lindblad("dimer", lambda: j_lb.LindbladSolver(H, [c]).run(
        rho0, **run))
    tr = pt.LindbladSolver(H, [c], kernel=kernel, device="cpu").run(rho0,
                                                                    **run)
    for f in ("times", "observables", "states", "rho", "rho0", "psi",
              "psi0"):
        ours, ref = getattr(tr, f), getattr(jr, f)
        if ref is None:
            assert ours is None, f
        else:
            assert close(ours, ref), f
    assert (tr.dt, tr.nt, tr.nout, tr.description) == (
        jr.dt, jr.nt, jr.nout, jr.description)
    assert tr.rho0.dtype == torch.complex128
    assert abs(tr.observables[-1].real.sum().item() - 1) < 1e-12


# ------------------------------------------------------------ devices
def test_entry_points_default_to_the_card():
    """device=None means cuda: without a card every entry point raises."""
    H, a_op, spectrum, rho0 = redfield_system()
    if torch.cuda.is_available():
        assert pt.LindbladSolver(H, [a_op]).device.type == "cuda"
        return
    for make in (lambda: pt.LindbladSolver(H, [a_op]),
                 lambda: pt.LindbladSolver(H, device="cuda"),
                 lambda: pt.LiouvilleSolver(H, [a_op]),
                 lambda: pt.RedfieldSolver(H, [a_op], [spectrum]),
                 lambda: pt.redfield_tensor(H, [a_op], [spectrum]),
                 lambda: pt.FMO().redfield(),
                 lambda: pt.absorption_eseries([1.0], np.eye(9), a_op, rho0),
                 lambda: pt.driven_dissipative_dynamics(
                     H, a_op, rho0, type("P", (), {"efield": None})())):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_unknown_lindblad_kernel_raises():
    with pytest.raises(ValueError, match="kernel"):
        pt.LindbladSolver(np.eye(2), kernel="triton", device="cpu")
    with pytest.raises(TypeError):
        pt.LindbladSolver(np.eye(2), device="cpu").run(np.eye(2), dt=0.1)

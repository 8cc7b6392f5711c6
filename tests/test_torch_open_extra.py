"""Parity of the rest of the PyTorch port's ``open`` package
(pyqed_tpu_torch: open/tcl, open/correlation, open/mcwf, open/nrg,
open/oqs) with the JAX package, on the CPU at complex128.

Inputs are made with numpy from seeds and handed to both packages.
Tolerances: deterministic propagations and correlation functions rel
1e-12; NRG energies rel 1e-10. The quantum-jump trajectories are held to
JAX's exactly: the port's trajectory loop is fed JAX's own uniform draws
(the same PRNGKey splits and fold_in(., 1) as pyqed_tpu/open/mcwf.py),
so the jump counts agree exactly and the averages to rounding; with its
own generator the port's ensemble average is held against the Lindblad
solver within 5 standard errors.
"""
import numpy as np
import jax
import pytest
import torch

from pyqed_tpu.open import correlation as jcorr
from pyqed_tpu.open.bath import DrudeBath as JDrudeBath
from pyqed_tpu.open.mcwf import MCWFSolver as JMCWFSolver
from pyqed_tpu.open.nrg import NRG as JNRG
from pyqed_tpu.open.oqs import OQS as JOQS
from pyqed_tpu.open.tcl import TCL2Solver as JTCL2Solver

import pyqed_tpu_torch as pt
from pyqed_tpu_torch.open import correlation as tcorr
from pyqed_tpu_torch.open.bath import DrudeBath
from pyqed_tpu_torch.open.mcwf import MCWFSolver, _result, _trajectories
from pyqed_tpu_torch.open.nrg import NRG, SBM
from pyqed_tpu_torch.open.oqs import OQS
from pyqed_tpu_torch.open.tcl import TCL2Solver
from pyqed_tpu_torch.ops.expm import expm_pade

RTOL = 1e-12
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SZ = np.diag([1.0, -1.0])
SM = np.array([[0.0, 1.0], [0.0, 0.0]], complex)
P1 = np.diag([0.0, 1.0]).astype(complex)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def rel_err(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def random_system(n, seed):
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(n, n))
    H = (H + H.T) / 2
    l = rng.normal(size=(n, n)) * 0.3
    A, B, C = (rng.normal(size=(n, n)) for _ in range(3))
    rho0 = np.diag(rng.dirichlet(np.ones(n)))
    return H, l, A, B, C, rho0


# ---------------------------------------------------------------- TCL2
@pytest.mark.parametrize("source", ["bath", "corr"])
def test_tcl2_matches_jax(source):
    H = 0.5 * SZ + 0.1 * SX
    rho0 = np.diag([0.0, 1.0]).astype(complex)
    if source == "bath":
        kw_j = dict(bath=JDrudeBath(temperature=1.0, cutoff=5.0, reorg=0.01))
        kw_t = dict(bath=DrudeBath(temperature=1.0, cutoff=5.0, reorg=0.01))
    else:
        def corr(t):
            t = np.atleast_1d(t)
            return 0.02 * np.exp(-3.0 * t) * (np.cos(2.0 * t) - 0.4j)
        kw_j = kw_t = dict(corr=corr)
    j = JTCL2Solver(H, SX, **kw_j)
    t = TCL2Solver(H, SX, device="cpu", **kw_t)
    tg = np.arange(11) * 0.05

    def ref():
        r = j.run(rho0, dt=0.02, nt=300, e_ops=[SZ, SX])
        return j.lambda_op(tg), r.observables, r.rho, r.times

    lam, obs, rho, times = jax.jit(ref)()     # one program, not op by op
    assert rel_err(t.lambda_op(tg), lam) <= RTOL
    rt = t.run(rho0, dt=0.02, nt=300, e_ops=[SZ, SX])
    assert rel_err(rt.observables, obs) <= RTOL
    assert rel_err(rt.rho, rho) <= RTOL
    assert rel_err(rt.times, times) <= 1e-15


# ---------------------------------------------------------- correlations
def test_correlation_3p_1t_and_4p_2t_match_jax():
    H, l, A, B, C, rho0 = random_system(4, 3)
    tl = np.arange(1, 61) * 0.01
    D = np.eye(4) + 0.1 * A
    (tj, cj), (_, cj2), mj = jax.jit(lambda: (
        jcorr.correlation_3p_1t(H, rho0, (A, B, C), c_ops=[l], tlist=tl),
        jcorr.correlation_3p_1t(H, rho0, (A, B, C), dt=0.02, nt=30),
        jcorr.correlation_4p_2t(H, rho0, (A, B, C, D), c_ops=[l], dt=0.02,
                                nt1=3, nt2=20)))()
    tt, ct = tcorr.correlation_3p_1t(H, rho0, (A, B, C), c_ops=[l],
                                     tlist=tl, device="cpu")
    assert rel_err(ct, cj) <= RTOL and rel_err(tt, tj) <= 1e-15
    tt, ct = tcorr.correlation_3p_1t(H, rho0, (A, B, C), dt=0.02, nt=30,
                                     device="cpu")
    assert rel_err(ct, cj2) <= RTOL
    mt = tcorr.correlation_4p_2t(H, rho0, (A, B, C, D), c_ops=[l], dt=0.02,
                                 nt1=3, nt2=20, device="cpu")
    assert rel_err(mt, mj) <= RTOL


def test_user_dyn_and_g2_match_jax():
    """A user right-hand side (pure dephasing, written once for each
    package's arrays) and g2 of a damped, thermally pumped cavity."""
    def dyn_for(xp_conj):
        def dyn(rho, H, c_ops):
            out = -1j * (H @ rho - rho @ H)
            for l in c_ops:
                out = out + 0.5 * (l @ rho @ xp_conj(l) - rho)
            return out
        return dyn

    H, l, A, B, C, rho0 = random_system(3, 7)
    Z = np.diag([1.0, -1.0, 0.5])
    n = 5
    a = np.diag(np.sqrt(np.arange(1, n)), 1)
    Hc = 0.7 * a.T @ a
    c_ops = [np.sqrt(0.2 * 1.3) * a, np.sqrt(0.2 * 0.3) * a.T]
    p = 0.3 ** np.arange(n)
    rho_th = np.diag(p / p.sum())
    (_, cj), (tj, gj) = jax.jit(lambda: (
        jcorr.correlation_3p_1t(H, rho0, (A, B, C), c_ops=[Z], dt=0.02,
                                nt=30, dyn=dyn_for(lambda a: a.conj().T)),
        jcorr.g2_coherence(Hc, rho_th, a, c_ops=c_ops, dt=0.05, nt=40)))()
    _, ct = tcorr.correlation_3p_1t(H, rho0, (A, B, C), c_ops=[Z], dt=0.02,
                                    nt=30, dyn=dyn_for(lambda a: a.mH),
                                    device="cpu")
    assert rel_err(ct, cj) <= RTOL
    tt, gt = tcorr.g2_coherence(Hc, rho_th, a, c_ops=c_ops, dt=0.05, nt=40,
                                device="cpu")
    assert rel_err(gt, gj) <= RTOL and rel_err(tt, tj) <= 1e-15


# ---------------------------------------------------------------- MCWF
def jax_draws(key, ntraj, nsteps):
    """The uniforms pyqed_tpu/open/mcwf.py draws: per trajectory a split of
    the key into nsteps step keys kk, r = uniform(kk) for the jump test and
    uniform(fold_in(kk, 1)) inside random.choice for the channel."""
    def traj(k):
        ks = jax.random.split(k, nsteps)
        return jax.vmap(lambda kk: (jax.random.uniform(kk),
                                    jax.random.uniform(
                                        jax.random.fold_in(kk, 1))))(ks)

    keys = jax.random.split(jax.random.PRNGKey(key), ntraj)
    r, u2 = jax.jit(jax.vmap(traj))(keys)
    return torch.tensor(np.asarray(r)), torch.tensor(np.asarray(u2))


def qutrit_two_channels():
    H = np.array([[0.0, 0.2, 0.0], [0.2, 0.5, 0.1], [0.0, 0.1, 1.0]])
    c1 = np.zeros((3, 3), complex)
    c1[0, 2] = np.sqrt(0.3)
    c2 = np.zeros((3, 3), complex)
    c2[1, 2] = np.sqrt(0.1)
    c2[0, 1] = np.sqrt(0.05)
    psi0 = np.array([0.0, 0.3, 1.0], complex)
    eops = [np.diag([1.0, 0, 0]).astype(complex), c2 + c2.T]
    return H, [c1, c2], psi0, eops


@pytest.mark.parametrize("norm", [0.01, 0.2, 0.8, 1.5, 4.0, 40.0])
def test_expm_pade_matches_jax(norm):
    """MCWF's U_eff: the port's Padé expm against jax.scipy.linalg.expm
    at an L1 norm in each order's range (3, 5, 7, 9, 13, 13 with three
    squarings), rel 1e-13."""
    rng = np.random.default_rng(11)
    A = rng.normal(size=(5, 5)) + 1j * rng.normal(size=(5, 5))
    A *= norm / np.abs(A).sum(axis=0).max()
    ref = np.asarray(jax.scipy.linalg.expm(A))
    assert rel_err(expm_pade(torch.as_tensor(A)), ref) <= 1e-13


def test_mcwf_trajectories_exact_on_jax_draws():
    H, c_ops, psi0, eops = qutrit_two_channels()
    ntraj, nt, nout, dt = 32, 200, 20, 0.05
    rj = JMCWFSolver(H, c_ops).run(psi0, dt=dt, nt=nt, ntraj=ntraj,
                                   nout=nout, key=5, e_ops=eops)
    r, u2 = jax_draws(5, ntraj, nt)
    sol = MCWFSolver(H, c_ops, device="cpu")
    p0 = torch.as_tensor(psi0 / np.linalg.norm(psi0))
    A = torch.stack([torch.as_tensor(e) for e in eops])
    obs, nj = _trajectories(sol._u_eff(dt), sol.c_ops, p0, A, r, u2, nout)
    res = _result(obs, nj, dt, nt, nout, ntraj)
    assert int(np.asarray(rj.njumps).max()) > 1        # jumps happened
    np.testing.assert_array_equal(host(res.njumps), np.asarray(rj.njumps))
    assert rel_err(res.observables, rj.observables) <= RTOL
    assert rel_err(res.observables_std, rj.observables_std) <= 1e-10
    assert rel_err(res.times, rj.times) <= 1e-15


def test_mcwf_ensemble_matches_lindblad():
    """With its own generator (draws on the CPU, moved to the device) the
    average over 2,000 trajectories of a driven damped two-level system
    lies within 5 standard errors of the Lindblad solver's."""
    H = 0.5 * SZ + 0.3 * SX
    psi0 = np.array([0.0, 1.0], complex)
    c = [np.sqrt(0.2) * SM]
    res = pt.mcsolve(H, psi0, c_ops=c, e_ops=[P1, SX], dt=0.01, nt=400,
                     ntraj=2000, nout=20, key=0, device="cpu")
    lb = pt.LindbladSolver(H, c_ops=c, device="cpu").run(
        np.outer(psi0, psi0.conj()), dt=0.01, Nt=400, nout=20,
        e_ops=[P1, SX])
    dev = (host(res.observables) - host(lb.observables)[1:]).real
    se = host(res.observables_std).real
    assert np.all(np.abs(dev) <= 5 * se + 1e-12), np.max(np.abs(dev) / se)
    assert np.all(se > 0)
    again = MCWFSolver(H, c, device="cpu").run(psi0, dt=0.01, nt=400,
                                                ntraj=2000, nout=20, key=0,
                                                e_ops=[P1, SX])
    assert torch.equal(again.observables, res.observables)
    with pytest.raises(TypeError, match="integer"):
        pt.mcsolve(H, psi0, c_ops=c, key=jax.random.PRNGKey(0),
                   device="cpu")


def test_mcwf_unitary_and_dark_state():
    H = np.zeros((3, 3), complex)
    H[0, 1] = H[1, 0] = 0.3
    c = np.zeros((3, 3), complex)
    c[0, 2] = 1.0
    P0 = np.diag([1.0, 0, 0]).astype(complex)
    res = pt.mcsolve(H, np.array([1.0, 0, 0], complex), c_ops=[c],
                     e_ops=[P0], dt=0.05, nt=400, ntraj=8, key=3,
                     device="cpu")
    t = host(res.times)
    assert int(res.njumps.max()) == 0
    assert np.max(np.abs(host(res.observables)[:, 0].real
                         - np.cos(0.3 * t) ** 2)) < 1e-10
    r2 = MCWFSolver(0.5 * SZ + 0.3 * SX, device="cpu").run(
        np.array([0.0, 1.0], complex), dt=0.01, nt=40, ntraj=2, nout=20,
        key=1, e_ops=[P1])
    assert int(r2.njumps.max()) == 0 and r2.observables.shape == (2, 1)


# ---------------------------------------------------------------- NRG
def test_nrg_matches_jax():
    """Wilson chain and the energy flow of the spin-boson model at the
    JAX package's test parameters, two shells (the second truncated from
    32 states to nkeep = 24)."""
    Himp, kw = 0.5 * 0.1 * SX, dict(N=2, nz=4, nkeep=24, alpha=0.05)
    j, t = JNRG(Himp), NRG(Himp, device="cpu")
    ej, tj = j.discretize(12, s=1.0, omegac=1.0, alpha=0.1)
    et, tt = t.discretize(12, s=1.0, omegac=1.0, alpha=0.1)
    np.testing.assert_array_equal(et, ej)
    np.testing.assert_array_equal(tt, tj)
    fj, ft = j.run(**kw), t.run(**kw)
    assert len(ft) == len(fj) == kw["N"]
    for a, b in zip(ft, fj):
        assert np.max(np.abs(a - b)) <= 1e-10 * max(1.0, np.max(np.abs(b)))
    assert rel_err(t.energies, j.energies) <= 1e-10
    s = SBM(0.2, 0.1)
    om = np.linspace(0.0, 1.5, 7)
    assert rel_err(s.spectral_density(om, s=0.5, alpha=0.3),
                   np.where(om < 1.0, 2 * np.pi * 0.3 * om ** 0.5, 0.0)) \
        <= RTOL


# ---------------------------------------------------------------- OQS
def tls():
    H = np.array([[0.0, 0.5], [0.5, 1.0]])
    rho0 = np.diag([0.0, 1.0]).astype(complex)
    return H, SM, rho0


def test_oqs_lindblad_and_correlation():
    H, sm, rho0 = tls()
    e_ops = [np.diag([1.0, 0.0])]
    sys = OQS(H, c_ops=[0.3 * sm], e_ops=e_ops, device="cpu")
    r1 = sys.lindblad(rho0, dt=0.05, nt=40)
    r2 = pt.LindbladSolver(H, c_ops=[0.3 * sm], e_ops=e_ops,
                           device="cpu").run(rho0, 0.05, 40)
    assert torch.equal(r1.observables, r2.observables)
    rj = JOQS(H, c_ops=[0.3 * sm], e_ops=e_ops).lindblad(rho0, dt=0.05,
                                                         nt=40)
    assert rel_err(r1.observables, rj.observables) <= RTOL
    X = sm + sm.T
    cj = JOQS(H, c_ops=[0.3 * sm]).correlation_2p_1t(rho0, [X, X], dt=0.05,
                                                      nt=20)
    ct = sys.correlation_2p_1t(rho0, [X, X], dt=0.05, nt=20)
    assert rel_err(ct, cj) <= RTOL
    with pytest.raises(ValueError):
        sys.correlation_2p_1t(rho0, [X, X], dt=0.05, nt=5, method="heom")


def test_oqs_heom_tcl2_redfield():
    H, sm, rho0 = tls()
    Q = sm + sm.T
    P = [np.diag([1.0, 0.0])]
    rj = JOQS(H, c_ops=[Q]).heom(
        rho0, dt=0.02, nt=40, bath=JDrudeBath(1.0, 1.0, 0.05), lmax=2,
        e_ops=P, nout=10)
    sys = OQS(H, c_ops=[Q], device="cpu")
    rt = sys.heom(rho0, dt=0.02, nt=40, bath=DrudeBath(1.0, 1.0, 0.05),
                  lmax=2, e_ops=P, nout=10, kernel="cuda")
    assert rel_err(rt.observables, rj.observables) <= RTOL
    tj = jax.jit(lambda: JOQS(H, c_ops=[Q]).tcl2(
        rho0, dt=0.02, nt=100, e_ops=P,
        bath=JDrudeBath(1.0, 2.0, 0.02)).observables)()
    tt = sys.tcl2(rho0, dt=0.02, nt=100, e_ops=P,
                  bath=DrudeBath(1.0, 2.0, 0.02))
    assert rel_err(tt.observables, tj) <= RTOL
    # Redfield: the front door forwards to the port's RedfieldSolver, whose
    # parity with JAX tests/test_torch_lindblad.py holds
    a_ops = [(Q, DrudeBath(1.0, 2.0, 0.02))]
    ft = OQS(H, device="cpu").redfield(rho0, dt=0.05, nt=100, e_ops=P,
                                       a_ops=a_ops)
    fr = pt.RedfieldSolver(H, a_ops=a_ops, device="cpu").run(
        rho0, 0.05, 100, e_ops=P)
    assert torch.equal(ft.observables, fr.observables)


def test_oqs_setters_and_errors():
    H, sm, rho0 = tls()
    sys = OQS(np.zeros((2, 2)), device="cpu")
    sys.set_hamiltonian(np.zeros((3, 3)))
    assert sys.nstates == 3
    sys.setH(H)
    sys.configure(c_ops=[0.3 * sm], e_ops=None)
    assert sys.nstates == 2 and len(sys.c_ops) == 1
    with pytest.raises(ValueError, match="tcl2 requires"):
        OQS(H, device="cpu").tcl2(rho0, dt=0.05, nt=5)
    if not torch.cuda.is_available():
        for make in (lambda: OQS(H), lambda: MCWFSolver(H),
                     lambda: NRG(H), lambda: TCL2Solver(H, SX, corr=abs)):
            with pytest.raises(RuntimeError, match="cuda"):
                make()

"""Parity of the port's nonequilibrium Green's functions
(``pyqed_tpu_torch.negf``) with the JAX package's, on the CPU in float64.

The parameters of the JAX package's own tests: the dimer of
``tests/test_kb_gw.py`` at nt = 48 (second Born and GW), the
Bethe-lattice quenches of ``tests/test_noneq_dmft.py`` and
``examples/noneq_dmft_quench.py``, the equilibrium DMFT, GW-BSE, RT-TDHF
and Holstein cases of ``tests/test_gwbse_dmft.py``, and the grids of
``tests/test_negf.py`` and ``tests/test_contour.py``. The mean-field
cases start the port from JAX's orbitals. Tolerances: Green's functions,
self-energies, densities and spectra 1e-10 relative to their largest
entry; QP, BSE and DMFT energies 1e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqed_tpu import negf as JN
from pyqed_tpu import qchem as J
from pyqed_tpu.negf import contour as jc, eph as je, kb2t as jk

from pyqed_tpu_torch import negf as TN
from pyqed_tpu_torch import qchem as T
from pyqed_tpu_torch.negf import contour as tc, eph as te, kb2t as tk

CPU = "cpu"
DIMER = np.array([[0.0, -1.0], [-1.0, 0.5]])
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              1e-300)


# ------------------------------------------------------------- keldysh

def test_free_contour_gf_and_self_energies_match_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(3, 3))
    H = (A + A.T) / 2
    for sign in (-1, 1):
        Gj = JN.green_from_H_const(jnp.asarray(H), 5.0, 20, 4, 0.1,
                                   sign=sign, mu=-3.0 if sign == 1 else 0.1)
        Gt = TN.green_from_H_const(torch.as_tensor(H), 5.0, 20, 4, 0.1,
                                   sign=sign, mu=-3.0 if sign == 1 else 0.1)
        for name in ("retarded", "lesser", "matsubara"):
            assert rel(getattr(Gt, name), getattr(Gj, name)) < TOL, name
    assert TN.green_from_H is TN.green_from_H_const
    assert rel(Gt.get_gtr(7, 3), Gj.get_gtr(7, 3)) < TOL
    assert rel(Gt.rho(5), Gj.rho(5)) < TOL
    w = np.linspace(-1.5, 1.5, 31)
    assert rel(Gt.spectral(w), Gj.spectral(jnp.asarray(w))) < TOL
    assert rel(TN.hartree(Gt, H), JN.hartree(Gj, H)) < TOL
    assert rel(TN.fock_exchange(Gt, H), JN.fock_exchange(Gj, H)) < TOL
    for a, b in zip(TN.second_born(Gt, 0.7), JN.second_born(Gj, 0.7)):
        assert rel(a, b) < TOL
    x = np.linspace(-2, 2, 9)
    assert rel(TN.fermi(3.0, x, 0.2), JN.fermi(3.0, jnp.asarray(x), 0.2)) \
        < TOL
    assert rel(TN.bose(3.0, x + 3), JN.bose(3.0, jnp.asarray(x + 3))) < TOL


def test_kbsolver_and_volterra_int_match_jax():
    H = np.array([[0.0, -0.5], [-0.5, 0.0]])
    Gj = JN.KBSolver(jnp.asarray(H), U=1.0, beta=5.0, nt=30, dt=0.1).run(
        max_iter=30)
    Gt = TN.KBSolver(torch.as_tensor(H), U=1.0, beta=5.0, nt=30,
                     dt=0.1).run(max_iter=30)
    assert rel(Gt.retarded, Gj.retarded) < TOL
    assert rel(Gt.lesser, Gj.lesser) < TOL
    rng = np.random.default_rng(2)
    nt, n = 15, 2
    g0 = rng.normal(size=(nt + 1, n, n)) + 1j * rng.normal(size=(nt + 1, n, n))
    K = np.tril(np.ones((nt + 1, nt + 1)))[..., None, None] \
        * rng.normal(size=(nt + 1, nt + 1, n, n)) * 0.1
    assert rel(TN.volterra_int(torch.as_tensor(g0), torch.as_tensor(K), 0.05),
               JN.volterra_int(jnp.asarray(g0), jnp.asarray(K), 0.05)) < TOL


# -------------------------------------------------------------- contour

def test_equilibrium_contour_components_match_jax():
    Gj = jc.green_equilibrium(jc.semicircle_dos(2.0), 5.0, 0.05, 40, 64,
                              limit=4001, mu=0.3)
    Gt = tc.green_equilibrium(tc.semicircle_dos(2.0), 5.0, 0.05, 40, 64,
                              limit=4001, mu=0.3)
    for name in ("ret", "les", "tv", "mat"):
        assert rel(getattr(Gt, name), getattr(Gj, name)) < TOL, name
    assert rel(Gt.get_les(7, 2), Gj.get_les(7, 2)) < TOL
    w = np.linspace(-3, 3, 61)
    assert rel(Gt.spectral_function(w), Gj.spectral_function(w)) < TOL
    H = np.array([[0.1, 0.3], [0.3, -0.4]])
    Hj = jc.green_equilibrium_H(H, 5.0, 0.05, 10, 16, mu=0.05)
    Ht = tc.green_equilibrium_H(H, 5.0, 0.05, 10, 16, mu=0.05)
    for name in ("ret", "les", "tv", "mat"):
        assert rel(getattr(Ht, name), getattr(Hj, name)) < TOL, name
    assert isinstance(Gt, TN.ContourGF) and isinstance(
        tc.semicircle_dos(1.0), TN.DOS)


def test_volterra_intdiff_matches_jax():
    rng = np.random.default_rng(3)
    nt, dt = 60, 0.02
    q = np.broadcast_to(np.array([[0.0, 1.0], [-1.0, 0.0]]) * 1j,
                        (nt + 1, 2, 2))
    K = -0.3 * np.ones((nt + 1, nt + 1, 2, 2)) + 0.1 * rng.normal(
        size=(nt + 1, nt + 1, 2, 2))
    f = np.full((nt + 1, 2, 2), 0.2)
    for kw in (dict(corrector_iters=3), dict(f=f, corrector_iters=2)):
        a = tc.volterra_intdiff(q, K, np.eye(2), dt, nt, device=CPU, **kw)
        b = jc.volterra_intdiff(q, K, np.eye(2), dt, nt, **kw)
        assert rel(a, b) < TOL


# ------------------------------------------------------------------ kb2t

@pytest.mark.parametrize("selfenergy", ["2B", "GW"])
def test_kb2t_dimer_matches_jax(selfenergy):
    kw = dict(nt=48, dt=0.05, beta=5.0, mu=0.0, U=0.8,
              selfenergy=selfenergy)
    sj = JN.KBSolver2T(lambda t: DIMER, **kw)
    st = TN.KBSolver2T(lambda t: DIMER, device=CPU, **kw)
    GRj, GLj = sj.run(sc_iter=2)
    GRt, GLt = st.run(sc_iter=2)
    assert rel(GRt, GRj) < TOL and rel(GLt, GLj) < TOL
    assert rel(st.occupations(), sj.occupations()) < TOL
    for a, b in zip(st.gw_self_energy(GRt, GLt) if selfenergy == "GW"
                    else st.second_born(GRt, GLt),
                    sj.gw_self_energy(GRj, GLj) if selfenergy == "GW"
                    else sj.second_born(GRj, GLj)):
        assert rel(a, b) < TOL
    assert TN.kb2t.KeldyshSolver is TN.KBSolver2T


def test_driven_kb2t_and_greater_match_jax():
    """A time-dependent h(t) (a quench of the level offset)."""
    def h(t):
        return DIMER + (0.3 if t > 0.5 else 0.0) * np.diag([1.0, -1.0])

    GRj, GLj = JN.KBSolver2T(h, nt=30, dt=0.05, beta=5.0).run()
    GRt, GLt = TN.KBSolver2T(h, nt=30, dt=0.05, beta=5.0, device=CPU).run()
    assert rel(GRt, GRj) < TOL and rel(GLt, GLj) < TOL
    assert rel(tk._greater(GRt, GLt), jk._greater(GRj, GLj)) < TOL


# ------------------------------------------------------------------ dmft

@pytest.mark.parametrize("solver", ["ipt", "2b"])
def test_noneq_dmft_stationarity_case_matches_jax(solver):
    """n0 = 0.8, U = 1.5 at nt = 80 (8 of the test's 20 iterations)."""
    kw = dict(v=0.5, nt=80, dt=0.06, n0=0.8, solver=solver)
    dj = JN.NoneqDMFT(1.5, **kw)
    dt_ = TN.NoneqDMFT(1.5, device=CPU, **kw)
    dj.run(niter=8, mix=0.6)
    dt_.run(niter=8, mix=0.6)
    assert rel(dt_.G[0], dj.G[0]) < TOL and rel(dt_.G[1], dj.G[1]) < TOL
    for fn in ("density", "double_occupancy", "retarded_t0"):
        assert rel(getattr(dt_, fn)(), getattr(dj, fn)()) < TOL, fn
    for fn in ("kinetic_energy", "interaction_energy", "total_energy"):
        assert np.max(np.abs(getattr(dt_, fn)() - getattr(dj, fn)())) \
            < TOL, fn


def test_thermal_quench_example_matches_jax():
    """examples/noneq_dmft_quench.py at its parameters, its asserts."""
    kw = dict(v=0.5, nt=48, dt=0.08, beta=8.0, ntau=64, solver="2b")
    dj = JN.NoneqDMFTThermal(2.0, **kw)
    dt_ = TN.NoneqDMFTThermal(2.0, device=CPU, **kw)
    dj.run(niter=12, mix=0.6)
    dt_.run(niter=12, mix=0.6)
    for a, b in zip(dt_.G, dj.G):
        assert rel(a, b) < TOL
    docc, n = dt_.double_occupancy(), dt_.density()
    assert rel(docc, dj.double_occupancy()) < TOL
    for fn in ("kinetic_energy", "total_energy"):
        assert np.max(np.abs(getattr(dt_, fn)() - getattr(dj, fn)())) \
            < TOL, fn
    assert abs(docc[0] - 0.25) < 5e-3
    assert docc.min() < 0.17
    assert np.max(np.abs(n - 0.5)) < 2e-3


@pytest.mark.parametrize("U", [0.5, 2.0, 4.0])
def test_equilibrium_dmft_matches_jax(U):
    a = JN.DMFT(U=U, t=0.5, beta=16)
    b = TN.DMFT(U=U, t=0.5, beta=16, device=CPU)
    a.run()
    b.run()
    assert rel(b.G, a.G) < TOL and rel(b.Sigma, a.Sigma) < TOL
    assert abs(b.quasiparticle_weight() - a.quasiparticle_weight()) < TOL
    assert abs(b.density() - a.density()) < TOL


# ------------------------------------------------------------------- eph

def test_holstein_migdal_matches_jax():
    ws = np.linspace(-4, 2, 301)
    for T_ in (0.0, 0.3):
        assert rel(te.fan_migdal_sigma(ws, [0.0, 0.4], 0.6, 0.5, T=T_,
                                       device=CPU),
                   je.fan_migdal_sigma(ws, [0.0, 0.4], 0.6, 0.5, T=T_)) < TOL
    assert rel(te.spectral_function(ws, [0.0], g=0.6, w0=0.5, eta=2e-2,
                                    device=CPU),
               je.spectral_function(ws, [0.0], g=0.6, w0=0.5,
                                    eta=2e-2)) < TOL
    assert rel(te.gf0(ws, np.array([0.5]), eta=0.1, device=CPU),
               je.gf0(ws, np.array([0.5]), eta=0.1)) < TOL
    assert rel(te.gf0_ph(ws, 1.0, eta=0.1, device=CPU),
               je.gf0_ph(ws, 1.0, eta=0.1)) < TOL
    k = np.linspace(-np.pi, np.pi, 9)
    assert rel(te.band(k, device=CPU), je.band(k)) < TOL


# ------------------------------------------------------- GW, BSE, TDHF

def h2(basis):
    jmf = J.Molecule([("H", (0, 0, 0)), ("H", (0, 0, 1.4))],
                     basis=basis).RHF().run()
    mol = T.Molecule([("H", (0, 0, 0)), ("H", (0, 0, 1.4))], basis=basis,
                     device=CPU)
    return jmf, T.scf_from_reference(
        mol, T.RHF, mo_coeff=np.array(jmf.mo_coeff),
        mo_energy=np.array(jmf.mo_energy), dm=np.array(jmf.dm),
        nocc=jmf.nocc, e_tot=float(jmf.e_tot))


def test_g0w0_and_gwbse_match_jax():
    jmf, tmf = h2("6-31g")
    Oj, Xj = JN.rpa_modes(jmf)
    Ot, Xt = TN.rpa_modes(tmf)
    assert np.max(np.abs(Ot - Oj)) < TOL
    for a, b in zip(TN.g0w0(tmf, orbitals=[0, 1, 3]),
                    JN.g0w0(jmf, orbitals=[0, 1, 3])):
        assert np.max(np.abs(a - b)) < TOL
    gj, gt = JN.G0W0(jmf), TN.G0W0(tmf)
    assert np.max(np.abs(gt.run() - gj.run())) < TOL
    assert abs(gt.ip - gj.ip) < TOL
    bj, bt = JN.GWBSE(jmf), TN.GWBSE(tmf)
    for kw in (dict(), dict(tda=True), dict(use_gw=False, screened=False)):
        assert np.max(np.abs(np.sort(bt.run(**kw)) - np.sort(bj.run(**kw)))) \
            < TOL, kw
    for a, b in zip(bt.ab_matrices(), bj.ab_matrices()):
        assert rel(a, b) < TOL
    assert np.max(np.abs(bt.e_gw - bj.e_gw)) < TOL


def test_rttdhf_absorption_matches_jax_and_tdhf():
    """tests/test_gwbse_dmft.py's H2/STO-3G kick (nt = 6000): the spectra
    agree and the peak sits at the TDHF excitation energy."""
    jmf, tmf = h2("sto-3g")
    fa, Sa = JN.RTTDHF(jmf).absorption(dt=0.05, nt=6000, kick=1e-3)
    rt = TN.RTTDHF(tmf)
    fb, Sb = rt.absorption(dt=0.05, nt=6000, kick=1e-3)
    assert rel(Sb, Sa) < TOL and np.max(np.abs(fb - fa)) == 0.0
    e_lr = T.TDHF(tmf).run(nroots=1)[0]
    assert abs(fb[np.argmax(np.abs(Sb))] - e_lr) < 0.01
    assert abs(float(torch.trace(rt.P).real) - 2.0) < 1e-8
    def pulse(t, m=np):                 # the same field traced by JAX
        return 0.01 * m.sin(0.9 * t) * m.exp(-((t - 2.0) / 1.0) ** 2)

    _, dj = JN.RTTDHF(jmf).run(0.05, 100, efield=lambda t: pulse(t, jnp))
    _, dt_ = TN.RTTDHF(tmf).run(0.05, 100, efield=pulse)
    assert rel(dt_, dj) < TOL

"""Parity of the PyTorch port's Gaussian-wavepacket and trajectory slice
(pyqed_tpu_torch: grid/gwp, grid/nawpd, grid/vmcg, grid/qtraj) with the
JAX package, on the CPU at complex128.

The same numpy inputs (and the same ensembles: the port draws from a
torch.Generator, the JAX package from jax.random) go through both
packages. Each JAX ``run()`` compiles its own program, so every JAX
propagation is computed once per module (the ``jref`` fixture) and
shared. Tolerances: deterministic closed forms and propagations rel
1e-12; a generalized eigenproblem whose whitened pencil has a gauge
freedom is compared through E, the propagated coefficients and <x>
(1e-12); NAWPD built by each package (the Gaussian DVR's generalized
eigh amplifies the rounding of an ill-conditioned overlap) through
its populations, 1e-10; VMCG on a well-conditioned basis (every overlap
eigenvalue far above the regularization cut), 1e-10.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqed_tpu.grid import gwp as jg
from pyqed_tpu.grid import nawpd as jn
from pyqed_tpu.grid import qtraj as jq
from pyqed_tpu.grid import vmcg as jv

from pyqed_tpu_torch.grid import gwp as tg
from pyqed_tpu_torch.grid import nawpd as tn
from pyqed_tpu_torch.grid import qtraj as tq
from pyqed_tpu_torch.grid import vmcg as tv

RTOL = 1e-12


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


# ------------------------------------------------------------ models
C_AC, GAP = 0.15, 0.3          # examples/vmcg_avoided_crossing.py


def jv_pot(x):
    return jnp.array([[0.5 * (x[0] + 1.0) ** 2, C_AC],
                      [C_AC, 0.5 * (x[0] - 1.0) ** 2 + GAP]])


def tv_pot(x):
    c = torch.full_like(x[0], C_AC)
    return torch.stack([torch.stack([0.5 * (x[0] + 1.0) ** 2, c]),
                        torch.stack([c, 0.5 * (x[0] - 1.0) ** 2 + GAP])])


def np_pot(x):
    return np.array([[0.5 * (x + 1.0) ** 2, C_AC],
                     [C_AC, 0.5 * (x - 1.0) ** 2 + GAP]])


def np_pot2(x, y):
    return np.array([[0.5 * (x + 1) ** 2 + 0.5 * y ** 2, 0.1 * y],
                     [0.1 * y, 0.5 * (x - 1) ** 2 + 0.5 * y ** 2 + 0.2]])


def jd1(x):
    return jnp.array([[0.5 * x[0] ** 2, 0.15], [0.15, 0.5 * x[0] ** 2 + 1.0]])


def td1(x):
    c = torch.full_like(x[0], 0.15)
    return torch.stack([torch.stack([0.5 * x[0] ** 2, c]),
                        torch.stack([c, 0.5 * x[0] ** 2 + 1.0])])


WPDN_CENTERS = [np.linspace(-3.5, 3.5, 6)] * 2
MORSE = (0.2, 1.0)
# VMCG basis: 8 Gaussians 0.8 apart (overlap eigenvalues far above the
# 1e-10 cut)
VM_Q = np.linspace(-3.5, 2.5, 8)[:, None]
# every branch of the trajectory and width equations: Ehrenfest with
# thawed widths, and frozen widths on diabatic surface 0
VM_CASES = {"ehrenfest_thawed": dict(thawed=True), "surface0": dict(motion=0)}
VM_RUN = dict(dt=0.01, nt=40, nout=20)
NAWPD_BASIS = [(q, 1.0) for q in np.linspace(-4, 4, 16)]
NAWPD2_BASIS = [(q, 1.0) for q in np.linspace(-3, 3, 8)]


def jbasis():
    return jg.GWPBasis.grid(WPDN_CENTERS, a=0.6)


def morse_j(x):
    return MORSE[0] * (1 - jnp.exp(-MORSE[1] * x)) ** 2


def morse_t(x):
    return MORSE[0] * (1 - torch.exp(-MORSE[1] * x)) ** 2


def vm_init(sol):
    n = VM_Q.shape[0]
    p = np.zeros((n, 1))
    al = np.ones((n, 1), complex)
    C0 = sol.project(VM_Q, p, al, np.array([-1.0]), np.array([0.0]),
                     np.array([1.0 + 0j]), state=0)
    return p, al, C0


@pytest.fixture(scope="module")
def jref():
    out = {}

    # WPDN: the matrices and spectrum in one jit (eager JAX compiles every
    # op on first use), then run()
    def wpdn():
        return jg.WPDN(jbasis(), mass=1.0, nquad=12, potential=lambda x:
                       0.5 * jnp.sum(x ** 2) + 0.1 * x[0] ** 3)

    def matrices():
        w = wpdn()
        return w.overlap(), w.kinetic(), w.buildH(), w.eigenstates()

    S, T, H, (E, C) = jax.jit(matrices)()
    c0 = np.asarray(C[:, -1] + 0.3 * C[:, -2])
    w = wpdn()
    w._S, w._H = S, H
    out["wpdn"] = dict(S=S, T=T, H=H, E=E, c0=c0,
                       run=w.run(c0, 0.05, 40, nout=10))
    # thawed Gaussian on the Morse potential
    th = jg.ThawedGaussian(morse_j, mass=1.0, ndim=1)
    out["thawed"] = th.run(0.3, 0.1, a0=1.0, dt=0.01, nt=40, nout=10)
    # VMCG (the projection and the observables each in one jit)
    for name, kw in VM_CASES.items():
        sol = jv.VMCG(jv_pot, mass=1.0, nstates=2, ndim=1, **kw)
        p, al, C0 = jax.jit(lambda: vm_init(sol))()
        res = sol.run(VM_Q, p, al, C0, **VM_RUN)
        last = tuple(res[k][-1] for k in ("q", "p", "alpha", "gamma", "C"))
        out["vmcg", name] = dict(C0=C0, res=res, **jax.jit(lambda s: dict(
            x=sol.obs_nuc(s, "x"), x2=sol.obs_nuc(s, "x2"),
            p=sol.obs_nuc(s, "p"), rdm=sol.rdm_el(s),
            wf=sol.wavefunction(s, np.linspace(-3, 3, 7))))(last))
    # NAWPD / NAWPD2
    n1 = jn.NAWPD(NAWPD_BASIS, np_pot, mass=1.0)
    psi = n1.project(lambda x: np.exp(-0.5 * (x + 1) ** 2), state=0)
    r = n1.run(psi, 0.01, 40, nout=10)
    out["nawpd"] = dict(sol=n1, psi0=psi, run=r,
                        pop=n1.population(r.psi, "diabatic"))
    n2 = jn.NAWPD2(NAWPD2_BASIS, NAWPD2_BASIS, np_pot2)
    psi2 = n2.project(lambda x, y: np.exp(-0.5 * ((x + 1) ** 2 + y ** 2)))
    out["nawpd2"] = dict(sol=n2, psi0=psi2, run=n2.run(psi2, 0.01, 20,
                                                       nout=10))
    # quantum trajectories
    qt = jq.QT(500, 1, mass=[1.0])
    qt.sample(jax.random.PRNGKey(3), x0=[1.0])
    qt.set_force(lambda x: -x)
    x0 = np.asarray(qt.x)
    out["qt"] = dict(x0=x0, run=qt.run(0.01, 40, nout=10))
    qtf = jq.QTF(400, mass=1.0, order=3, friction=0.1)
    ens = qtf.sample(a0=0.5, x0=0.8)
    out["qtf"] = dict(ens=[np.asarray(v) for v in ens],
                      run=qtf.run(*ens, lambda x: (x ** 2 / 2, x), dt=0.02,
                                  nt=40, nout=10))
    dom = jq.QTF(400, qpot=functools.partial(jq.qpot_domains, xdom=[0.0]))
    out["qtf_dom"] = dom.run(*ens, lambda x: (x ** 2 / 2, x), dt=0.02,
                             nt=20, nout=10)
    na = jq.NAQT(300, 1, 2, jd1)
    x, p, c = na.sample(a=[2.0], x0=[1.0], state=1)
    out["naqt"] = dict(ens=[np.asarray(v) for v in (x, p, c)],
                       run=na.run(x, p, c, dt=0.005, nt=40, nout=10))
    return out


# --------------------------------------------------------------- gwp
def test_closed_forms_match_jax():
    rng = np.random.default_rng(0)
    aj, ak = rng.uniform(0.5, 2, (2, 5, 1))
    qj, qk = rng.uniform(-1, 1, (2, 5, 1))
    args = (aj, qj, ak.T, qk.T)
    assert rel_err(tg.overlap_real(*args), jg.overlap_real(*args)) < RTOL
    for n in (1, 2):
        assert rel_err(tg.moment_real(*args, n=n),
                       jg.moment_real(*args, n=n)) < RTOL
    assert rel_err(tg.kinetic_real(*args, mass=2.0),
                   jg.kinetic_real(*args, mass=2.0)) < RTOL
    g = jg.GWP(q=0.3, p=0.5, a=1.5, phase=0.2)
    x = np.linspace(-2, 2, 9)
    assert rel_err(tg.GWP(0.3, 0.5, 1.5, 0.2).evaluate(x), g.evaluate(x)) \
        < RTOL


def test_wpd_1d_matches_jax():
    """Fixed real Gaussians (tests/test_gwp_smolyak.py's harmonic basis):
    H, S, eigenvalues, projection and propagation."""
    centers = np.linspace(-4, 4, 15)
    V = lambda x: 0.5 * x ** 2 + 0.05 * x ** 4
    j = jg.WPD(centers, widths=2.0, mass=1.0)
    t = tg.WPD(centers, widths=2.0, mass=1.0, device="cpu")
    jH, jS = j.buildH(V)
    tH, tS = t.buildH(V)
    assert rel_err(tH, jH) < RTOL and rel_err(tS, jS) < RTOL
    assert rel_err(t.eigenstates(k=4)[0], j.eigenstates(k=4)[0]) < 1e-10
    xg = np.linspace(-6, 6, 601)
    psi = lambda x: np.exp(-(x - 0.5) ** 2)
    c0 = j.project(psi, xg)
    assert rel_err(t.project(psi, xg), c0) < 1e-10
    jr = j.run(c0, 0.05, 20, nout=5)
    tr = t.run(host(c0), 0.05, 20, nout=5)
    assert rel_err(tr.states, jr.states) < 1e-10
    assert rel_err(t.wavefunction(tr.psi, xg), j.wavefunction(jr.psi, xg)) \
        < 1e-10


def test_wpdn_matches_jax(jref):
    ref = jref["wpdn"]
    basis = tg.GWPBasis.from_reference(jbasis(), device="cpu")
    w = tg.WPDN(basis, mass=1.0, nquad=12,
                potential=lambda x: 0.5 * torch.sum(x ** 2) + 0.1 * x[0] ** 3)
    assert rel_err(w.overlap(), ref["S"]) < RTOL
    assert rel_err(w.kinetic(), ref["T"]) < RTOL
    assert rel_err(w.buildH(), ref["H"]) < RTOL
    # the whitened pencil's eigenvectors carry a gauge: compare E, the
    # propagated coefficients and <x>
    assert rel_err(w.eigenstates()[0], ref["E"]) < RTOL
    times, cs, xs = w.run(ref["c0"], 0.05, 40, nout=10)
    jt, jcs, jxs = ref["run"]
    assert rel_err(times, jt) < 1e-15
    assert rel_err(cs, jcs) < RTOL and rel_err(xs, jxs) < RTOL
    x = np.random.default_rng(1).uniform(-2, 2, (5, 2))
    assert rel_err(basis.evaluate(x), jbasis().evaluate(jnp.asarray(x))) \
        < RTOL
    grid = tg.GWPBasis.grid(WPDN_CENTERS, a=0.6, device="cpu")
    assert rel_err(grid.q, jbasis().q) == 0.0
    jw = jg.WPDN(jbasis(), mass=2.0, nquad=12)
    tw = tg.WPDN.from_reference(jw, device="cpu")
    assert tw.nquad == 12 and rel_err(tw.mass, jw.mass) == 0.0
    assert rel_err(tw.basis.a, jw.basis.a) == 0.0


def test_wpdn_potential_chunks_agree(monkeypatch):
    """The pair chunks of potential_matrix do not change its value."""
    basis = tg.GWPBasis.from_reference(jbasis(), device="cpu")
    V = lambda x: torch.cos(x[0]) * x[1] ** 2
    whole = tg.WPDN(basis, nquad=6).potential_matrix(V)
    monkeypatch.setattr(tg, "POTENTIAL_CHUNK", 6 ** 2 * 7)
    assert rel_err(tg.WPDN(basis, nquad=6).potential_matrix(V), whole) \
        < 1e-15


def test_thawed_gaussian_matches_jax(jref):
    th = tg.ThawedGaussian(morse_t, mass=1.0, ndim=1, device="cpu")
    out = th.run(0.3, 0.1, a0=1.0, dt=0.01, nt=40, nout=10)
    for a, b in zip(out, jref["thawed"]):
        assert rel_err(a, b) < RTOL
    # the norm of the Heller wavepacket is conserved (to RK4's error at
    # dt = 0.01)
    assert np.ptp(host(out[5])) < 1e-8


# -------------------------------------------------------------- vmcg
@pytest.mark.parametrize("name", list(VM_CASES))
def test_vmcg_matches_jax(jref, name):
    ref = jref["vmcg", name]
    sol = tv.VMCG(tv_pot, mass=1.0, nstates=2, ndim=1, device="cpu",
                  **VM_CASES[name])
    p, al, C0 = vm_init(sol)
    assert rel_err(C0, ref["C0"]) < 1e-10
    res = sol.run(VM_Q, p, al, host(C0), **VM_RUN)
    for k in ("q", "p", "alpha", "gamma", "C", "populations", "times"):
        if np.abs(host(ref["res"][k])).max() > 0:
            assert rel_err(res[k], ref["res"][k]) < 1e-10, k
    last = tuple(res[k][-1] for k in ("q", "p", "alpha", "gamma", "C"))
    for which in ("x", "x2", "p"):
        assert rel_err(sol.obs_nuc(last, which), ref[which]) < 1e-10
    assert rel_err(sol.rdm_el(last), ref["rdm"]) < 1e-10
    assert rel_err(sol.wavefunction(last, np.linspace(-3, 3, 7)),
                   ref["wf"]) < 1e-10


def test_vmcg_matrix_elements_match_jax():
    rng = np.random.default_rng(2)
    q, p = rng.standard_normal((2, 4, 2))
    al = rng.uniform(0.5, 1.5, (4, 2)) + 0.2j * rng.standard_normal((4, 2))
    g = rng.standard_normal(4)
    t = lambda a: torch.as_tensor(a)
    J, T = jv.GWPMatrixElements, tv.GWPMatrixElements
    assert rel_err(T.overlap(t(q), t(p), t(al), t(g)),
                   J.overlap(q, p, al, g)) < RTOL
    assert rel_err(T.kinetic(t(q), t(p), t(al), t(g), t(np.array([1., 2.]))),
                   J.kinetic(q, p, al, g, np.array([1., 2.]))) < RTOL
    assert rel_err(T.moment1(t(q), t(p), t(al), t(g)),
                   J.moment1(q, p, al, g)) < RTOL


# ------------------------------------------------------------- nawpd
def test_nawpd_matches_jax(jref):
    ref = jref["nawpd"]
    sol = tn.NAWPD.from_reference(ref["sol"], device="cpu")
    psi0 = sol.project(lambda x: np.exp(-0.5 * (x + 1) ** 2), state=0)
    assert rel_err(psi0, ref["psi0"]) < RTOL
    r = sol.run(host(psi0), 0.01, 40, nout=10)
    assert rel_err(r.states, ref["run"].states) < RTOL
    assert rel_err(r.times, ref["run"].times) < 1e-15
    pop = sol.population(r.psi, "diabatic")
    assert rel_err(pop, ref["pop"]) < RTOL
    assert rel_err(sol.population(r.psi), ref["sol"].population(
        ref["run"].psi)) < RTOL
    # built by the port itself (its own eigenvector phases): the same
    # physics
    own = tn.NAWPD(NAWPD_BASIS, np_pot, mass=1.0, device="cpu")
    r2 = own.run(own.project(lambda x: np.exp(-0.5 * (x + 1) ** 2),
                             state=0), 0.01, 40, nout=10)
    assert rel_err(own.population(r2.psi, "diabatic"), ref["pop"]) < 1e-10


def test_nawpd2_matches_jax(jref):
    ref = jref["nawpd2"]
    sol = tn.NAWPD2.from_reference(ref["sol"], device="cpu")
    psi0 = sol.project(lambda x, y: np.exp(-0.5 * ((x + 1) ** 2 + y ** 2)))
    assert rel_err(psi0, ref["psi0"]) < 1e-12
    r = sol.run(host(psi0), 0.01, 20, nout=10)
    assert rel_err(r.states, ref["run"].states) < RTOL
    assert rel_err(sol.population(r.psi, "diabatic"),
                   ref["sol"].population(ref["run"].psi, "diabatic")) < RTOL


# ------------------------------------------------------------ qtraj
def test_qt_matches_jax(jref):
    ref = jref["qt"]
    qt = tq.QT(500, 1, mass=[1.0], device="cpu")
    qt.sample(0, x0=[1.0])
    qt.x = torch.as_tensor(ref["x0"])      # JAX's ensemble
    qt.set_force(lambda x: -x)
    r = qt.run(0.01, 40, nout=10)
    for a, b in ((r.x, ref["run"].x), (r.p, ref["run"].p),
                 (r.xAve, ref["run"].xAve),
                 (r.observables, ref["run"].observables)):
        assert rel_err(a, b) < RTOL


def test_qtf_matches_jax(jref):
    ref = jref["qtf"]
    sol = tq.QTF(400, mass=1.0, order=3, friction=0.1, device="cpu")
    ens = sol.sample(a0=0.5, x0=0.8)
    # the same quadrature ensemble, up to linspace's rounding
    for a, b in zip(ens, ref["ens"]):
        np.testing.assert_allclose(host(a), b, rtol=0,
                                   atol=1e-15 * max(1.0, np.abs(b).max()))
    r = sol.run(*ref["ens"], lambda x: (x ** 2 / 2, x), dt=0.02, nt=40,
                nout=10)
    assert rel_err(r.observables, ref["run"].observables) < RTOL
    assert rel_err(r.x, ref["run"].x) < RTOL
    dom = tq.QTF(400, qpot=functools.partial(tq.qpot_domains, xdom=[0.0]),
                 device="cpu")
    r = dom.run(*ref["ens"], lambda x: (x ** 2 / 2, x), dt=0.02, nt=20,
                nout=10)
    assert rel_err(r.observables, jref["qtf_dom"].observables) < RTOL


def test_naqt_matches_jax(jref):
    ref = jref["naqt"]
    sol = tq.NAQT(300, 1, 2, td1, device="cpu")
    r = sol.run(*ref["ens"], dt=0.005, nt=40, nout=10)
    for k in ("population", "xave", "x", "p", "c"):
        assert rel_err(getattr(r, k), getattr(ref["run"], k)) < RTOL, k


def test_quantum_forces_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 0.6, 2000)
    w = np.full(x.size, 1.0 / x.size)
    r = -(x - 0.5) / 0.72 + 0.05 * (x - 0.5) ** 2
    p = 0.7 + 0.2 * (x - 0.5) + 0.03 * x ** 3
    # the JAX references each in one jit (eager JAX compiles every op)
    for tf_, jf_ in ((tq.qpot, jq.qpot),
                     (functools.partial(tq.qpot_poly, order=4),
                      functools.partial(jq.qpot_poly, order=4)),
                     (functools.partial(tq.qpot_domains, xdom=[0.0, 0.8]),
                      functools.partial(jq.qpot_domains, xdom=[0.0, 0.8]))):
        ref = jax.jit(lambda *a: jf_(*a, mass=2.0))(x, p, r, w)
        for a, b in zip(tf_(x, p, r, w, mass=2.0), ref):
            assert rel_err(a, b) < 1e-10
    X = rng.standard_normal((300, 2))
    ref = jax.jit(jq.lqf)(jnp.asarray(X), jnp.asarray(w[:300]),
                          jnp.asarray([1.0, 2.0]))
    for a, b in zip(tq.lqf(torch.as_tensor(X), torch.as_tensor(w[:300]),
                           torch.as_tensor([1.0, 2.0])), ref):
        assert rel_err(a, b) < 1e-10
    rr = np.linspace(5, 12, 30)
    assert rel_err(tq.vpot_ph2(rr), jax.jit(jq.vpot_ph2)(rr)) < 1e-13


def test_draws_have_the_requested_moments():
    """The port's own draws (a torch.Generator seeded by key, made on the
    CPU): sample moments within 5 standard errors, the same key the same
    ensemble."""
    n = 20000
    qt = tq.QT(n, 2, device="cpu")
    x = host(qt.sample(7, x0=[1.0, -2.0], sigma=[0.5, 2.0]))
    assert np.all(np.abs(x.mean(0) - [1.0, -2.0]) < 5 * np.array([0.5, 2.0])
                  / np.sqrt(n))
    assert np.all(np.abs(x.std(0) / [0.5, 2.0] - 1) < 5 / np.sqrt(2 * n))
    np.testing.assert_array_equal(host(qt.sample(7, x0=[1.0, -2.0],
                                                 sigma=[0.5, 2.0])), x)
    xs, _, c = tq.NAQT(n, 1, 2, td1, device="cpu").sample(a=[2.0], x0=[1.0],
                                                          state=1)
    assert abs(host(xs).mean() - 1.0) < 5 * 0.5 / np.sqrt(n)
    assert abs(host(xs).std() / 0.5 - 1) < 5 / np.sqrt(2 * n)
    assert np.all(host(c)[:, 1] == 1.0)
    xm, _, _, w = tq.QTF(n, device="cpu").sample(a0=0.5, x0=0.8, key=3)
    assert abs(host(xm).mean() - 0.8) < 5 / np.sqrt(n)
    assert np.all(host(w) == 1.0 / n)

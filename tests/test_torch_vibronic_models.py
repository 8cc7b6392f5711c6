"""Parity of the PyTorch port's vibronic and conical-intersection models
(pyqed_tpu_torch: models/vibronic, models/lvc, models/pyrrole,
models/phenol, models/shinmetiu2d, models/polariton_grid) with the JAX
package, on the CPU at complex128.

The same numpy grids and parameters go through both packages; the
``from_reference`` constructors carry the JAX objects' arrays across.
Tolerances: potentials, surfaces and Hamiltonians rel 1e-12 (closed
forms); batched eigenvalues rel 1e-12; propagations (split operator, RK4)
rel 1e-10; eigenvectors only through sign- and phase-free quantities
(|<u|u'>|, projectors, populations), since LAPACK may pick other signs
in the two packages. The SPO runs of the models go through the
split-operator kernels' wrappers, which run their plain versions here.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.models import lvc as jlvc
from pyqed_tpu.models import phenol as jphenol
from pyqed_tpu.models import polariton_grid as jpg
from pyqed_tpu.models import pyrrole as jpyrrole
from pyqed_tpu.models import shinmetiu2d as jsm2
from pyqed_tpu.models import vibronic as jvib
from pyqed_tpu.models.cavity import Cavity as JCavity

from pyqed_tpu_torch.models import lvc as tlvc
from pyqed_tpu_torch.models import phenol as tphenol
from pyqed_tpu_torch.models import polariton_grid as tpg
from pyqed_tpu_torch.models import pyrrole as tpyrrole
from pyqed_tpu_torch.models import shinmetiu2d as tsm2
from pyqed_tpu_torch.models import vibronic as tvib
from pyqed_tpu_torch.models.cavity import Cavity

CPU = "cpu"


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


def J(fn, *args):
    """A JAX reference computed under one ``jax.jit`` (one compilation
    instead of one per eager operation); ``fn`` must not keep tracers,
    so methods that store results on their object run on a copy."""
    return jax.jit(fn)(*args)


def fresh(obj):
    return copy.copy(obj)


def gauss2(x, y, x0=0.0, y0=0.0, ns=3, state=0):
    X, Y = np.meshgrid(x, y, indexing="ij")
    psi = np.zeros(X.shape + (ns,), complex)
    g = np.exp(-((X - x0) ** 2 + (Y - y0) ** 2) / 2)
    dv = (x[1] - x[0]) * (y[1] - y[0])
    psi[..., state] = g / np.sqrt((g ** 2).sum() * dv)
    return psi


# ----------------------------------------------------- vibronic models
def test_pyrazine_matches_jax():
    x = np.linspace(-5, 5, 16)
    y = np.linspace(-6, 4, 12)
    jm, tm = jvib.Pyrazine(x, y), tvib.Pyrazine(x, y, device=CPU)
    V, A, D = J(lambda: (fresh(jm).buildV(), fresh(jm).apes(),
                         jm.dpes(0.3, -0.2)))
    assert rel_err(tm.buildV(), V) < 1e-14
    assert rel_err(tm.apes(), A) < 1e-12
    assert rel_err(tm.dpes(0.3, -0.2), D) < 1e-14
    X = torch.as_tensor(np.meshgrid(x, y, indexing="ij")[0])
    assert tm.dpes(X, 0.5).shape == (3, 3, 16, 12)
    psi0 = gauss2(x, y, state=2)
    kw = dict(dt=40.0, nt=20, nout=5)
    rj = jm.spo().run(jnp.asarray(psi0), **kw)
    rt = tm.spo().run(psi0, **kw)
    assert rel_err(rt.psi, rj.psi) < 1e-10
    assert rel_err(rt.population, rj.population) < 1e-10


def test_jahn_teller_matches_jax():
    x = np.linspace(-2, 2, 9)
    jm = jvib.JahnTeller(omega=1.0, kappa=0.5, delta=0.1)
    tm = tvib.JahnTeller(omega=1.0, kappa=0.5, delta=0.1, device=CPU)
    V, A, D = J(lambda: (jm.buildV(x, x), jm.apes(x, x),
                         jm.dpes(0.4, -0.7)))
    assert rel_err(tm.buildV(x, x), V) < 1e-14
    assert rel_err(tm.apes(x, x), A) < 1e-14
    assert rel_err(tm.dpes(0.4, -0.7), D) < 1e-14
    for c in ((0.0, 0.0), (2.0, 0.0)):
        assert abs(tm.geometric_phase(r=1.0, center=c, npts=64)
                   - jm.geometric_phase(r=1.0, center=c, npts=64)) < 1e-12


@pytest.mark.parametrize("field", [0.0, 0.01])
def test_shin_metiu_1d_matches_jax(field):
    kw = {} if field == 0.0 else {"E": field}
    jm = (jvib.ShinMetiu(nstates=3) if not kw
          else jvib.ShinMetiuInField(nstates=3, **kw))
    tm = (tvib.ShinMetiu(nstates=3, device=CPU) if not kw
          else tvib.ShinMetiuInField(nstates=3, device=CPU, **kw))
    for m in (jm, tm):
        m.create_grid(nx=48)
    R = np.linspace(-1.5, 1.5, 5)
    Ej, Uj, Aj = J(lambda: jm.pes(R) + (jm.overlap_matrix(jm.pes(R)[1]),))
    Et, Ut = tm.pes(R)
    assert rel_err(Et, Ej) < 1e-12
    ov = np.abs(np.einsum("mia, mia -> ma", host(Ut), np.asarray(Uj)))
    assert np.max(np.abs(ov - 1)) < 1e-10
    A = tm.overlap_matrix(Ut)
    assert rel_err(A.abs(), np.abs(np.asarray(Aj))) < 1e-10


def test_pyrazine4_and_spin_vibronic_match_jax():
    jm, tm = jvib.Pyrazine4(), tvib.Pyrazine4(device=CPU)
    args = (0.2, -0.4, 0.6, 0.3)
    assert rel_err(tm.dpes(*args), J(jm.dpes, *args)) < 1e-14
    for a, b in zip(tm.lvc()[2], jm.lvc()[2]):
        assert np.array_equal(a, b)
    # tn/vibronic is ported: JAX parity is in tests/test_torch_tn.py
    times, pops = tm.spectral_dynamics(nb=2, chi_max=4, nt=1, nout=1)
    assert pops.shape == (2, 3) and times.shape == (2,)
    assert rel_err(pops.sum(1), np.ones(2)) < 1e-10
    x = np.linspace(-4, 4, 12)
    js, ts = jvib.SpinVibronic(), tvib.SpinVibronic(device=CPU)
    V, A, P = J(lambda: (js.buildV(x, x), js.apes(x, x),
                         js.single_point(0.3, -0.5)))
    assert rel_err(ts.buildV(x, x), V) < 1e-14
    assert rel_err(ts.apes(x, x), A) < 1e-12
    assert rel_err(ts.single_point(0.3, -0.5), P) < 1e-14
    psi0 = gauss2(x, x, x0=1.0, ns=4, state=1)
    kw = dict(dt=0.05, nt=12, nout=4)
    rj = js.spo(x, x).run(jnp.asarray(psi0), **kw)
    rt = ts.spo(x, x).run(psi0, **kw)
    assert rel_err(rt.psi, rj.psi) < 1e-10
    assert rel_err(rt.rho_el, rj.rho_el) < 1e-10


def test_triazine_matches_jax():
    x = np.linspace(-1, 1, 5)
    jm, tm = jvib.Triazine(x, x), tvib.Triazine(x, x, device=CPU)
    V, D, A = J(lambda: (fresh(jm).dpes_global(), jm.dpes((0.3, 0.1)),
                         jm.apes((0.3, 0.1))[0]))
    assert rel_err(tm.dpes_global(), V) < 1e-14
    assert rel_err(tm.dpes((0.3, 0.1)), D) < 1e-14
    assert rel_err(tm.apes((0.3, 0.1))[0], A) < 1e-12
    assert abs(abs(tm.berry_phase(npts=24))
               - abs(jm.berry_phase(npts=24))) < 1e-10
    assert abs(abs(tm.wilson_loop(npts=24))
               - abs(jm.wilson_loop(npts=24))) < 1e-10


def crossing_1d(nx=64):
    x = np.linspace(-10, 10, nx, endpoint=False)
    e1 = 0.01 * np.tanh(x / 2.0)
    c = 0.005 * np.exp(-(x ** 2) / 8.0)
    dpes = np.zeros((nx, 2, 2))
    dpes[:, 0, 0], dpes[:, 1, 1] = e1, -e1
    dpes[:, 0, 1] = dpes[:, 1, 0] = c
    psi0 = np.zeros((nx, 2), complex)
    psi0[:, 0] = (1 / np.pi) ** 0.25 * np.exp(-(x + 4) ** 2 / 2 + 10j * x)
    return x, dpes, psi0


def test_vibronic_adiabatic_matches_jax():
    x, dpes, psi0 = crossing_1d()
    jm = jvib.VibronicAdiabatic.from_diabatic(x, dpes, mass=1000.0)
    tm = tvib.VibronicAdiabatic.from_diabatic(x, dpes, mass=1000.0,
                                              device=CPU)
    kw = dict(dt=0.5, nt=40, nout=20)
    rj = jm.run(jnp.asarray(psi0), order=1, **kw)
    rt = tm.run(psi0, order=1, **kw)
    assert rel_err(rt.states, rj.states) < 1e-10
    tr = tvib.VibronicAdiabatic.from_reference(jm, device=CPU)
    assert np.array_equal(tr.nac, np.asarray(jm.nac))
    assert rel_err(tr.run(psi0, **kw).states, jm.run(jnp.asarray(psi0),
                                                      **kw).states) < 1e-10


# ------------------------------------------------------------------ LVC
def lvc_pair():
    modes = [([((0, 1), 0.05), ((1, 1), 0.1)], 0.2, 6),
             ([((0, 0), -0.03), ((0, 1), 0.02)], 0.12, 6)]
    E = [0.0, 0.3]
    jm = jlvc.LVC(E, [jlvc.Mode(w, c, n) for c, w, n in modes])
    tm = tlvc.LVC(E, [tlvc.Mode(w, c, n) for c, w, n in modes])
    return jm, tm


def test_lvc_matches_jax():
    jm, tm = lvc_pair()

    def coupled(m):
        m.buildH()
        return m.add_coupling(((0, 1), 0.01))

    H, A, vert, X1, B01, B1, Hc, mm = J(lambda: (
        fresh(jm).buildH(), jm.APES([0.3, -0.2]), jm.vertical(1),
        fresh(jm).coordinate(1), jm.buildop(0, 1), jm.buildop(1),
        coupled(fresh(jm)),
        jlvc.multimode([0.1, 0.2], 2, J=0.05, truncate=3)[0]))
    assert rel_err(tm.buildH(), H) < 1e-14
    assert rel_err(tm.APES([0.3, -0.2], device=CPU), A) < 1e-12
    assert rel_err(tm.vertical(1), vert) == 0
    assert rel_err(tm.coordinate(1), X1) < 1e-14
    assert rel_err(tm.buildop(0, 1), B01) < 1e-14
    jm.H = H
    rj = jm.run(dt=0.5, nt=40, nout=10, e_ops=[B1])
    rt = tm.run(device=CPU, dt=0.5, nt=40, nout=10, e_ops=[tm.buildop(1)])
    assert rel_err(rt.observables, rj.observables) < 1e-10
    assert rel_err(tm.rdm_el(rt.psi), J(jm.rdm_el, rj.psi)) < 1e-10
    tm.add_coupling(((0, 1), 0.01))
    assert rel_err(tm.H, Hc) < 1e-14
    jm.H = Hc
    back = tlvc.LVC.from_reference(jm)
    assert rel_err(back.H, Hc) < 1e-15
    assert rel_err(tlvc.multimode([0.1, 0.2], 2, J=0.05, truncate=3)[0],
                   mm) < 1e-14


# ------------------------------------------------------ pyrrole, phenol
def test_pyrrole_and_phenol_match_jax():
    r = np.linspace(2.0, 6.0, 11)
    q = np.linspace(-0.5, 0.5, 7)
    rr = np.linspace(1.5, 4.0, 9)
    th = np.linspace(0.0, np.pi, 6)
    jp, tp = jpyrrole.Pyrrole(), tpyrrole.Pyrrole(device=CPU)
    jc, tc = jpyrrole.PyrroleCation(), tpyrrole.PyrroleCation(device=CPU)
    jph, tph = jphenol.Phenol(rr, th), tphenol.Phenol(rr, th, device=CPU)
    ref = J(lambda: (jp.dpes(r, q), jp.apes(r, q), jp.S0(r, 0.2),
                     jp.eigenstates(npts=48)[0], jc.apes(r, 0.1, n=0),
                     jc.apes(r, 0.1, n=1), fresh(jph).buildV(),
                     fresh(jph).apes()))
    got = (tp.dpes(r, q), tp.apes(r, q), tp.S0(r, 0.2),
           tp.eigenstates(npts=48)[0], tc.apes(r, 0.1, n=0),
           tc.apes(r, 0.1, n=1), tph.buildV(), tph.apes())
    for a, b in zip(got, ref):
        assert rel_err(a, b) < 1e-12


# ---------------------------------------------------------- ShinMetiu2D
@pytest.mark.parametrize("kind", ["base", "magnetic", "electric"])
def test_shinmetiu2d_matches_jax(kind):
    make = {"base": lambda m, **kw: m.ShinMetiu2D(nstates=3, **kw),
            "magnetic": lambda m, **kw: m.ShinMetiu2DMagnetic(
                nstates=3, B=2.0e4, **kw),
            "electric": lambda m, **kw: m.ShinMetiu2DElectric(
                nstates=3, E=(0.01, -0.02), **kw)}
    jm = make[kind](jsm2)
    tm = make[kind](tsm2, device=CPU)
    for m in (jm, tm):
        m.create_grid([(-3.0, 3.0), (-3.0, 3.0)], 9)
    Rs = np.array([[-0.5, 0.1], [0.0, 0.0], [0.4, -0.2]])
    Ej, Uj = jm.pes(Rs)
    Et, Ut = tm.pes(Rs)
    assert rel_err(Et, Ej) < 1e-12
    ov = np.abs(np.einsum("pia, pia -> pa", host(Ut).conj(), Uj))
    assert np.max(np.abs(ov - 1)) < 1e-10
    nj = jm.nonadiabatic_coupling(Ej[0], Uj[0], Rs[0])
    nt = tm.nonadiabatic_coupling(Et[0], Ut[0], Rs[0])
    assert rel_err(np.abs(host(nt)), np.abs(nj)) < 1e-10
    assert rel_err(tm.electronic_overlap().abs(),
                   np.abs(jm.electronic_overlap())) < 1e-10
    if kind == "magnetic":            # complex states: a U(1) transport
        Ep, Up = tm.parallel_transport(Rs[:2])
        Epj, Upj = jm.parallel_transport(Rs[:2])
        assert rel_err(Ep, Epj) < 1e-12
        # after transport, consecutive overlaps are real and positive
        for U in (host(Up), Upj):
            ovs = np.einsum("ia, ia -> a", U[0].conj(), U[1])
            assert np.all(np.abs(ovs.imag) < 1e-10) and np.all(ovs.real > 0)


# ------------------------------------------------------- grid polaritons
def polariton_pair(nx=48, ncav=3):
    x = np.linspace(-6, 6, nx, endpoint=False)
    v = np.zeros((nx, 2, 2))
    v[:, 0, 0] = 0.5 * 0.2 * x ** 2
    v[:, 1, 1] = 0.5 * 0.2 * (x - 1.0) ** 2 + 0.4
    v[:, 0, 1] = v[:, 1, 0] = 0.01 * np.exp(-x ** 2)
    edip = np.array([[0.0, 1.0], [1.0, 0.0]])
    jm = jpg.VibronicPolariton(jpg.GridMol(x, v, edip, mass=20.0),
                               JCavity(0.4, ncav))
    tm = tpg.VibronicPolariton(tpg.GridMol(x, v, edip, mass=20.0),
                               Cavity(0.4, ncav), device=CPU)
    return x, jm, tm


def test_vibronic_polariton_matches_jax():
    x, jm, tm = polariton_pair()
    d = np.einsum("x, ab -> xab", 1 + 0.1 * x, [[0.0, 1.0], [1.0, 0.0]])

    def refs():
        m = fresh(jm)
        V = m.dpes(0.05)
        A, N = m.ppes(), m.photon_number_surface()
        m.mol = fresh(jm.mol)
        m.mol.edip = jnp.asarray(d)
        return V, A, N, m.dpes(0.05)

    V, A, N, Vd = J(refs)
    assert rel_err(tm.dpes(0.05), V) < 1e-14
    assert rel_err(tm.ppes(), A) < 1e-12
    assert rel_err(tm.photon_number_surface(), N) < 1e-10
    # a coordinate-dependent dipole
    tm.mol.edip = torch.as_tensor(d)
    assert rel_err(tm.dpes(0.05), Vd) < 1e-14
    jm.v = Vd
    psi0 = np.zeros((x.size, tm.nstates), complex)
    psi0[:, 0] = np.exp(-(x + 1) ** 2) / (np.pi / 2) ** 0.25 / np.sqrt(
        x[1] - x[0])
    kw = dict(dt=0.5, nt=20, nout=5)
    rj = jm.run(jnp.asarray(psi0), **kw)
    rt = tm.run(psi0, **kw)
    assert rel_err(rt.psi, rj.psi) < 1e-10
    back = tpg.VibronicPolariton.from_reference(jm, device=CPU)
    assert rel_err(back.v, jm.v) == 0


def test_vsc_and_tdh_match_jax():
    x = np.linspace(-5, 5, 32, endpoint=False)
    v = 0.5 * x ** 2
    jv = jpg.VSC(x, v, JCavity(1.0, 3), mass=1.0, g=0.05)
    tv = tpg.VSC(x, v, Cavity(1.0, 3), mass=1.0, g=0.05, device=CPU)
    psi0 = np.zeros((32, 3), complex)
    psi0[:, 0] = np.exp(-(x - 0.5) ** 2 / 2) / np.pi ** 0.25 / np.sqrt(
        x[1] - x[0])
    S, Hp = J(lambda: (jv.spectrum(k=5), jv.hpsi(jnp.asarray(psi0))))
    assert rel_err(tv.spectrum(k=5), S) < 1e-12
    assert rel_err(tv.hpsi(psi0), Hp) < 1e-12
    kw = dict(dt=0.05, nt=20, nout=5)
    assert rel_err(tv.run(psi0, **kw).psi,
                   jv.run(jnp.asarray(psi0), **kw).psi) < 1e-10
    back = tpg.VSC.from_reference(jv, device=CPU)
    assert rel_err(back.hpsi(psi0), tv.hpsi(psi0)) == 0
    jt = jpg.TDH(x, v, JCavity(1.0, 3), mass=1.0, g=0.05)
    tt = tpg.TDH(x, v, Cavity(1.0, 3), mass=1.0, g=0.05, device=CPU)
    chi0 = psi0[:, 0] * np.sqrt(x[1] - x[0])
    phi0 = np.array([0.0, 1.0, 0.0])
    oj = jt.run(jnp.asarray(chi0), jnp.asarray(phi0), 0.05, 30)
    ot = tt.run(chi0, phi0, 0.05, 30)
    for k in ("chi", "phi", "xave", "nave"):
        assert rel_err(ot[k], oj[k]) < 1e-10, k


def test_vibronic_polariton_2d_matches_jax():
    x = np.linspace(-3, 3, 8)
    y = np.linspace(-3, 3, 7)
    X, Y = np.meshgrid(x, y, indexing="ij")
    v = np.zeros((8, 7, 2, 2))
    v[..., 0, 0] = 0.5 * (X ** 2 + Y ** 2)
    v[..., 1, 1] = 0.5 * (X ** 2 + Y ** 2) + 0.5 + 0.2 * X
    v[..., 0, 1] = v[..., 1, 0] = 0.2 * Y
    edip = np.array([[0.0, 1.0], [1.0, 0.0]])
    jm = jpg.VibronicPolariton2(jpg.GridMol2(x, y, v, edip), JCavity(0.5, 2),
                                g=0.05)
    tm = tpg.VibronicPolariton2(tpg.GridMol2(x, y, v, edip), Cavity(0.5, 2),
                                g=0.05, device=CPU)
    V = jm.dpes_global()                      # a NumPy build in JAX too
    assert rel_err(tm.dpes_global(), V) < 1e-14
    assert rel_err(tm.ppes(), J(lambda: fresh(jm).ppes())) < 1e-12
    e_t, g_t = tm.ground_state()
    e_j, g_j = jm.ground_state()
    assert abs(e_t - e_j) < 1e-12 * abs(e_j)
    assert abs(abs(np.vdot(g_t, g_j)) - 1) < 1e-10
    # plaquette curvature of a vortex spinor (1, (x + i y)/2), normalized
    u = np.stack([np.ones_like(X), 0.5 * (X + 1j * Y)], -1)
    u = u / np.linalg.norm(u, axis=-1, keepdims=True)
    assert rel_err(tpg.berry_curvature_field(u, device=CPU),
                   jpg.berry_curvature_field(u)) < 1e-12
    assert rel_err(tm.promote_op(edip), jm.promote_op(edip)) == 0
    rt = tm.run(dt=0.1, nt=6, nout=3)
    rj = jm.run(dt=0.1, nt=6, nout=3)
    assert rel_err(rt.population, rj.population) < 1e-10

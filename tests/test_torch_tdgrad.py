"""Parity of the port's analytic excited-state and correlated gradients
and relaxed dipoles (``pyqed_tpu_torch.qchem.tdgrad``) with the JAX
package's, on the CPU in float64.

The molecules of ``tests/test_tdgrad.py``: symmetry-free water, LiH and
the OH radical in STO-3G. The port starts from the JAX package's own
state — orbitals (``scf_from_reference``), TDA/TDHF/UCIS vectors
(``tdscf_from_reference``) and CCSD amplitudes (``ccsd_from_reference``)
— so degenerate rotations and signs do not enter. Every JAX reference is
computed once, in the module fixture ``jref``: there the JAX engines'
autodiff transforms (``jax.grad``, ``jax.jacobian``, ``jax.jacfwd`` as
the JAX module calls them) are jitted for the fixture only (eager JAX
compiles op by op), and the same engine gives both the gradient and the
dipole. Tolerances: gradients, relaxed dipoles and single-coordinate dω
1e-9 absolute.
"""
import types

import jax
import numpy as np
import pytest
import torch

from pyqed_tpu import qchem as J
from pyqed_tpu.qchem import tdgrad as jt
from pyqed_tpu.qchem.grad import rhf_gradient as j_rhf_gradient

from pyqed_tpu_torch import qchem as T
from pyqed_tpu_torch.qchem import tdgrad as tt

CPU = "cpu"
H2O = [("O", (0.02, 0.0, 0.0)), ("H", (0.1, -1.4, 1.0)),
       ("H", (0.0, 1.43, 1.15))]     # deliberately symmetry-free
LIH = [("Li", (0, 0, 0.0)), ("H", (0, 0, 3.0))]
OH = [("O", (0.0, 0.0, 0.0)), ("H", (0.0, 0.3, 1.83))]
TOL = 1e-9


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


def err(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def arr(x):
    if isinstance(x, (tuple, list)):
        return tuple(np.array(y) for y in x)
    return np.array(x)


def ported(jmf, atoms, cls, **kw):
    """The port's mean field on the CPU from a JAX one's orbitals."""
    mol = T.Molecule(atoms, basis="sto-3g", device=CPU,
                     spin=jmf.mol.spin)
    return T.scf_from_reference(
        mol, cls, mo_coeff=arr(jmf.mo_coeff), mo_energy=arr(jmf.mo_energy),
        dm=arr(jmf.dm), nocc=jmf.nocc, e_tot=float(jmf.e_tot),
        converged=jmf.converged, **kw)


def pair_vectors(jtd):
    return [tuple(np.array(z) for z in p) for p in jtd.xy]


def field_dipole(eng, mf, mu_ref):
    """JAX's own dipole assembly (μ_ref − dω/dF) on a JAX engine."""
    from pyqed_tpu.qchem.basis import dipole_matrix
    mu_ao = np.asarray(dipole_matrix(mf.mol.bfs), float)
    zS = np.zeros_like(mu_ao[0])
    return np.asarray(mu_ref) - np.array(
        [eng.domega(zS, mu_ao[x]) for x in range(3)])


def uhf_dipole(mf):
    from pyqed_tpu.qchem.basis import dipole_matrix
    mu_ao = np.asarray(dipole_matrix(mf.mol.bfs), float)
    Da, Db = (np.asarray(d) for d in mf.dm)
    Z = np.asarray(mf.mol.atom_charges(), float)
    return Z @ np.asarray(mf.mol.atom_coords()) - np.einsum(
        "kpq, qp -> k", mu_ao, Da + Db)


@pytest.fixture(scope="module")
def jref():
    jitted = types.SimpleNamespace(
        grad=lambda f, **kw: jax.jit(jax.grad(f, **kw)),
        jacobian=lambda f, **kw: jax.jit(jax.jacobian(f, **kw)),
        jacfwd=lambda f, **kw: jax.jit(jax.jacfwd(f, **kw)))
    mp = pytest.MonkeyPatch()
    mp.setattr(jt, "jax", jitted)
    out = {}
    try:
        w = J.Molecule(H2O, basis="sto-3g").RHF().run()
        g_hf = np.asarray(j_rhf_gradient(w), float)
        tda, trip, tdhf = J.TDA(w), J.TDA(w, singlet=False), J.TDHF(w)
        tda.run(nroots=4)
        trip.run(nroots=3)
        tdhf.run(nroots=3)
        mu_w = np.asarray(w.dip_moment())
        out["water"] = dict(mf=w, tda=tda, trip=trip, tdhf=tdhf)
        for key, eng in (("cis1", jt._cis_engine(tda, 1)),
                         ("cis2", jt._cis_engine(tda, 2)),
                         ("trip1", jt._cis_engine(trip, 1)),
                         ("tdhf1", jt._tdhf_engine(tdhf, 1)),
                         ("mp2", jt.ResponseEngine(
                             w, *jt._mp2_omega(w)[:1],
                             check_value=jt._mp2_omega(w)[1]))):
            out[key] = (g_hf + eng.nuclear_gradient(),
                        field_dipole(eng, w, mu_w))
            if key == "cis1":
                derivs = jt._ao_derivative_mats(w.mol)
                out["domega"] = {ax: (derivs[ax[0]][ax[1]],
                                      eng.domega(*derivs[ax[0]][ax[1]]))
                                 for ax in ((0, 0), (2, 1))}
        lih = J.Molecule(LIH, basis="sto-3g").RHF().run()
        cc = J.CCSD(lih).run()
        eng = jt._ccsd_engine(cc)
        out["lih"] = dict(mf=lih, cc=cc)
        out["ccsd"] = (np.asarray(j_rhf_gradient(lih), float)
                       + eng.nuclear_gradient(),
                       field_dipole(eng, lih, lih.dip_moment()))
        oh = J.Molecule(OH, spin=1, basis="sto-3g").UHF().run()
        ucis = J.UCIS(oh)
        ucis.run(nroots=3)
        out["oh"] = dict(mf=oh, ucis=ucis)
        g_u = np.asarray(j_rhf_gradient(oh), float)
        for key, eng in (("ump2", jt._ump2_engine(oh)),
                         ("ucis2", jt._ucis_engine(ucis, 2))):
            out[key] = (g_u + eng.nuclear_gradient(),
                        field_dipole(eng, oh, uhf_dipole(oh)))
    finally:
        mp.undo()
    return out


# ----------------------------------------------------------- RHF family

@pytest.fixture(scope="module")
def water(jref):
    r = jref["water"]
    mf = ported(r["mf"], H2O, T.RHF)
    tds = {k: T.tdscf_from_reference(mf, T.TDA, e=r[k].e, xy=r[k].xy,
                                     singlet=(k == "tda"))
           for k in ("tda", "trip")}
    tds["tdhf"] = T.tdscf_from_reference(mf, T.TDHF, e=r["tdhf"].e,
                                         xy=pair_vectors(r["tdhf"]))
    return mf, tds


@pytest.mark.parametrize("state", [1, 2])
def test_cis_gradient_and_dipole_match_jax(water, jref, state):
    mf, tds = water
    g = T.cis_gradient(tds["tda"], state)
    assert err(g, jref[f"cis{state}"][0]) < TOL
    assert err(T.cis_dipole(tds["tda"], state), jref[f"cis{state}"][1]) < TOL
    # translational invariance of the analytic forces
    assert np.max(np.abs(g.sum(axis=0))) < 1e-6
    assert err(T.tda_gradient(tds["tda"], state), g) == 0.0


def test_cis_triplet_gradient_matches_jax(water, jref):
    _, tds = water
    assert err(T.cis_gradient(tds["trip"], 1), jref["trip1"][0]) < TOL


def test_tdhf_gradient_and_dipole_match_jax(water, jref):
    _, tds = water
    assert err(T.tdhf_gradient(tds["tdhf"], 1), jref["tdhf1"][0]) < TOL
    assert err(T.tdhf_dipole(tds["tdhf"], 1), jref["tdhf1"][1]) < TOL


def test_mp2_gradient_and_dipole_match_jax(water, jref):
    mf, _ = water
    assert err(T.mp2_gradient(mf), jref["mp2"][0]) < TOL
    assert err(T.mp2_dipole(mf), jref["mp2"][1]) < TOL


@pytest.mark.parametrize("coord", [(0, 0), (2, 1)])
def test_domega_one_coordinate_with_jax_dA(water, jref, coord):
    """The per-perturbation route on JAX's own (dS, dh, dA) of one
    (atom, axis) equals JAX's, and the fused contraction of
    ``nuclear_gradient`` gives the same number for that coordinate."""
    _, tds = water
    (dS, dh, dA), ref = jref["domega"][coord]
    eng = tt._cis_engine(tds["tda"], 1)
    assert abs(eng.domega(dS, dh, dA) - ref) < TOL
    assert abs(eng.nuclear_gradient()[coord] - ref) < TOL


def test_response_gradient_is_the_engine(water):
    """``response_gradient`` on a user functional (the Hylleraas MP2
    functional of the port) equals its engine's nuclear gradient."""
    mf, _ = water
    omega, e2 = tt._mp2_omega(mf)
    g = T.response_gradient(mf, omega, check_value=e2)
    assert err(g, tt.ResponseEngine(mf, omega).nuclear_gradient()) < 1e-12


# ------------------------------------------------------------- CCSD

def test_ccsd_gradient_and_dipole_match_jax(jref):
    r = jref["lih"]
    mf = ported(r["mf"], LIH, T.RHF)
    cc = T.ccsd_from_reference(mf, t1=r["cc"].t1, t2=r["cc"].t2,
                               e_corr=r["cc"].e_corr)
    g = T.ccsd_gradient(cc)
    assert err(g, jref["ccsd"][0]) < TOL
    assert np.max(np.abs(g.sum(axis=0))) < 1e-10
    assert err(T.ccsd_dipole(cc), jref["ccsd"][1]) < TOL


# ------------------------------------------------------------- UHF

@pytest.fixture(scope="module")
def radical(jref):
    r = jref["oh"]
    mf = ported(r["mf"], OH, T.UHF)
    ucis = T.tdscf_from_reference(mf, T.UCIS, e=r["ucis"].e,
                                  xy=pair_vectors(r["ucis"]))
    return mf, ucis


def test_ump2_gradient_and_dipole_match_jax(radical, jref):
    mf, _ = radical
    g = T.ump2_gradient(mf)
    assert err(g, jref["ump2"][0]) < TOL
    assert np.max(np.abs(g.sum(axis=0))) < 1e-10
    assert err(T.ump2_dipole(mf), jref["ump2"][1]) < TOL


def test_ucis_gradient_and_dipole_match_jax(radical, jref):
    _, ucis = radical
    assert err(T.ucis_gradient(ucis, 2), jref["ucis2"][0]) < TOL
    assert err(T.ucis_dipole(ucis, 2), jref["ucis2"][1]) < TOL


# ---------------------------------------------------------- the guards

def test_engine_guards_raise(water, jref):
    mf, tds = water
    stale = T.tdscf_from_reference(mf, T.TDA, e=np.asarray(tds["tda"].e)
                                   + 1e-3, xy=jref["water"]["tda"].xy)
    with pytest.raises(RuntimeError, match="stale"):
        T.cis_gradient(stale, 1)
    C = mf.mo_coeff
    no = mf.nocc

    def not_stationary(kappa, h, eri):
        # an occupied-occupied rotation changes it: the oo Lagrangian
        # block is not symmetric
        return torch.sum((C + C @ kappa)[:, :no] ** 3)

    with pytest.raises(RuntimeError, match="not symmetric"):
        T.ResponseEngine(mf, not_stationary)
    r = jref["lih"]
    lmf = ported(r["mf"], LIH, T.RHF)
    loose = T.ccsd_from_reference(lmf, t1=np.array(r["cc"].t1) + 1e-4,
                                  t2=r["cc"].t2, e_corr=r["cc"].e_corr)
    with pytest.raises(RuntimeError, match="residual"):
        T.ccsd_gradient(loose)
    ks = T.Molecule(LIH, basis="sto-3g", device=CPU).RKS(
        xc="pbe", n_rad=16, n_theta=6).run()
    td = T.TDA(ks)
    td.run(nroots=2)
    with pytest.raises(NotImplementedError, match="tail"):
        T.tddft_tda_gradient(td, 1)


def test_gradient_needs_the_derivative_engine(water, monkeypatch):
    """The nuclear gradient takes dERI from the native C++ code and raises when
    it cannot be built (no fallback to the Python recursion)."""
    from pyqed_tpu_torch.qchem import basis
    mf = T.Molecule(H2O, basis="sto-3g", device=CPU).RHF().run()
    td = T.TDA(mf)
    td.run(nroots=2)

    def broken(bfs, native=True):
        raise RuntimeError("derivative-ERI build failed")

    monkeypatch.setattr(basis, "eri_deriv", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        T.cis_gradient(td, 1)

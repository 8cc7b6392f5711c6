"""Parity of the port's analytic TDDFT/TDA (LDA) excited-state gradient
and relaxed dipole, and of ``ExcitedGeometryOptimizer``'s analytic
default, with the JAX package's, on the CPU in float64.

LiH/STO-3G with SVWN on a 16 x 6 Becke grid (the molecule of
``tests/test_tdgrad.py``). The port's RKS mean field and TDA vectors are
handed to a JAX ``RKS`` and ``TDA`` of the same molecule, so both engines
start from one state; the JAX TDDFT engine (nested autodiff through the
Becke grid, about half a minute of eager JAX) is computed once per
module. The public gradient is the port's ``ks_gradient`` (held to
JAX's in ``tests/test_torch_qchem_ksgrad.py``) plus the engine's dω/dR,
which is compared with JAX's. Tolerances: gradients and dipoles 1e-9
absolute; the optimizer's end energy 1e-10 Eh and geometry 1e-8 bohr.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqed_tpu import qchem as J
from pyqed_tpu.qchem import tdgrad as jt
from pyqed_tpu.qchem.grad import ExcitedGeometryOptimizer as JOpt

from pyqed_tpu_torch import qchem as T
from pyqed_tpu_torch.qchem import tdgrad as tt
from pyqed_tpu_torch.qchem.grad import ks_gradient

CPU = "cpu"
LIH = [("Li", (0, 0, 0.0)), ("H", (0, 0, 3.0))]
KS = dict(xc="svwn", n_rad=16, n_theta=6)
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


@pytest.fixture(scope="module")
def lda():
    """(port TDA, JAX engine's dω/dR and dipole correction)."""
    mf = T.Molecule(LIH, basis="sto-3g", device=CPU).RKS(**KS).run()
    td = T.TDA(mf)
    td.run(nroots=3)
    jm = J.Molecule(LIH, basis="sto-3g")
    jmf = J.RKS(jm, **KS)
    S, Tk, V, eri = jm.intor()
    for name in ("mo_coeff", "mo_energy", "dm"):
        setattr(jmf, name, jnp.asarray(host(getattr(mf, name))))
    jmf.nocc, jmf.e_tot, jmf.converged = mf.nocc, mf.e_tot, True
    jmf.hcore, jmf.eri, jmf.S = Tk + V, eri, S
    jtd = J.TDA(jmf)
    jtd.e, jtd.xy = td.e, jnp.asarray(host(td.xy))
    eng = jt._tddft_tda_engine(jtd, 1)
    from pyqed_tpu.qchem.basis import dipole_matrix
    mu_ao = np.asarray(dipole_matrix(jm.bfs), float)
    corr = np.array([eng.domega(np.zeros_like(mu_ao[0]), mu_ao[x])
                     for x in range(3)])
    return td, eng.nuclear_gradient(), corr


def test_tddft_tda_gradient_matches_jax(lda):
    td, g_eng, _ = lda
    eng = tt._tddft_tda_engine(td, 1)
    assert err(eng.nuclear_gradient(), g_eng) < TOL
    g = T.tddft_tda_gradient(td, 1)
    assert err(g, ks_gradient(td.mf) + g_eng) < TOL
    assert np.max(np.abs(g.sum(axis=0))) < 1e-10   # translational inv.


def test_tddft_tda_dipole_matches_jax(lda):
    td, _, corr = lda
    assert err(T.tddft_tda_dipole(td, 1), td.mf.dip_moment() - corr) < TOL


def test_excited_optimizer_default_matches_jax():
    """The analytic default (RHF: cis_gradient) lands where JAX's does,
    and the default is the analytic Jacobian for RHF and RKS/SVWN only."""
    jo = JOpt(LIH, state=1, maxiter=30).run()
    to = T.ExcitedGeometryOptimizer(LIH, state=1, maxiter=30,
                                    device=CPU).run()
    assert to.analytic and to.converged
    assert abs(to.e_tot - jo.e_tot) < 1e-10
    assert max(np.max(np.abs(a[1] - b[1]))
               for a, b in zip(to.atoms_opt, jo.atoms_opt)) < 1e-8
    assert T.ExcitedGeometryOptimizer(LIH, method="RKS").analytic
    assert not T.ExcitedGeometryOptimizer(LIH, method="RKS",
                                          xc="pbe").analytic
    assert not T.ExcitedGeometryOptimizer(LIH, analytic=False).analytic

"""Parity of the port's unrestricted Kohn-Sham SCF and of the analytic KS
nuclear gradients (``ks_gradient``: the HF-like core plus autograd through
the Becke grid) with the JAX package's, on the CPU in float64.

Water/STO-3G (and its cation for UKS) on a 20 x 6 Becke grid; the JAX RKS
mean fields are computed once per module and the port starts from their
orbitals. Tolerances: energies 1e-10 Eh, densities 1e-8, V_xc 1e-10,
gradients 1e-9 Eh/bohr.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu import qchem as J
from pyqed_tpu.qchem.grad import ks_gradient as j_ks_gradient

from pyqed_tpu_torch import qchem as T
from pyqed_tpu_torch.qchem.grad import ks_gradient as t_ks_gradient

CPU = "cpu"
WATER = [("O", (0.0, 0.0, 0.0)), ("H", (0.0, -1.43, 1.11)),
         ("H", (0.0, 1.43, 1.11))]
GRID = dict(n_rad=20, n_theta=6)


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
def mols():
    return (J.Molecule(WATER, basis="sto-3g"),
            T.Molecule(WATER, basis="sto-3g", device=CPU))


@pytest.fixture(scope="module")
def jks(mols):
    jm, _ = mols
    return {xc: J.RKS(jm, xc=xc, **GRID).run() for xc in ("svwn", "b3lyp")}


def ported(jmf, mol, xc):
    return T.scf_from_reference(
        mol, T.RKS, mo_coeff=np.array(jmf.mo_coeff),
        mo_energy=np.array(jmf.mo_energy), dm=np.array(jmf.dm),
        nocc=jmf.nocc, e_tot=float(jmf.e_tot), converged=jmf.converged,
        xc=xc, **GRID)


@pytest.mark.parametrize("xc", ["svwn", "pbe"])
def test_uks_matches_jax(xc):
    kw = dict(basis="sto-3g", charge=1, spin=1)
    jmf = J.UKS(J.Molecule(WATER, **kw), xc=xc, **GRID).run()
    tmf = T.UKS(T.Molecule(WATER, device=CPU, **kw), xc=xc, **GRID).run()
    assert tmf.converged
    assert abs(tmf.e_tot - jmf.e_tot) < 1e-10
    for a, b in zip(tmf.dm, jmf.dm):
        assert err(a, b) < 1e-8
    Da, Db = (np.array(d) for d in jmf.dm)
    for a, b in zip(tmf._xc_uks(torch.as_tensor(Da), torch.as_tensor(Db)),
                    jmf._xc_uks(jnp.asarray(Da), jnp.asarray(Db))):
        assert err(a, b) < 1e-10


@pytest.mark.parametrize("xc", ["svwn", "b3lyp"])
def test_ks_gradient_matches_jax(xc, mols, jks):
    jmf = jks[xc]
    tmf = ported(jmf, mols[1], xc)
    assert err(t_ks_gradient(tmf), j_ks_gradient(jmf)) < 1e-9

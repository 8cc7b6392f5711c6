"""Every functional of the port's Kohn-Sham registry
(pyqed_tpu_torch.qchem.dft.FUNCTIONALS) against the JAX package's: the
converged RKS energy and density of water/STO-3G on a 20 x 6 Becke grid,
on the CPU in float64 (energies 1e-10 Eh, densities 1e-8).

The JAX package retraces its ``vmap(grad(...))`` in every SCF cycle,
which costs it seconds a functional on a CPU, so this file holds the full
SCF of each functional and ``test_torch_qchem_dft.py`` the rest of the
KS layer.
"""
import numpy as np
import pytest
import torch

from pyqed_tpu import qchem as J
from pyqed_tpu.qchem import dft as jdft

from pyqed_tpu_torch import qchem as T

WATER = [("O", (0.0, 0.0, 0.0)), ("H", (0.0, -1.43, 1.11)),
         ("H", (0.0, 1.43, 1.11))]
GRID = dict(n_rad=20, n_theta=6)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mols():
    return (J.Molecule(WATER, basis="sto-3g"),
            T.Molecule(WATER, basis="sto-3g", device="cpu"))


@pytest.mark.parametrize("xc", sorted(jdft.FUNCTIONALS))
def test_rks_every_functional_matches_jax(xc, mols):
    jm, tm = mols
    jmf = J.RKS(jm, xc=xc, **GRID).run()
    tmf = T.RKS(tm, xc=xc, **GRID).run()
    assert tmf.converged and jmf.converged
    assert tmf.hfx == jmf.hfx
    assert abs(tmf.e_tot - jmf.e_tot) < 1e-10
    assert abs(tmf.e_xc - jmf.e_xc) < 1e-10
    assert np.max(np.abs(tmf.dm.numpy() - np.asarray(jmf.dm))) < 1e-8

"""Parity of the PyTorch port's Kohn-Sham layer (pyqed_tpu_torch.qchem:
dft, the TDDFT kernel of tdscf, the KS gradients of grad) with the JAX
package's, on the CPU in float64.

The same atoms, grids and densities go through both packages. The JAX
package runs its KS layer eagerly and retraces its ``vmap(grad(...))``
every cycle, so its mean fields are computed once per module (the ``jks``
fixture) on water/STO-3G with a 20 x 6 Becke grid, and the port starts
from their orbitals where a test needs them. Tolerances: grid points and
AO values 1e-14 (weights 1e-13 relative), pointwise functionals 1e-12
relative, SCF energies 1e-10 Eh, densities 1e-8, V_xc and
``xc_kernel_ov`` 1e-10, excitation energies 1e-10. Every functional's
full SCF is in ``test_torch_qchem_ks.py``, UKS and the KS gradients in
``test_torch_qchem_ksgrad.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu import qchem as J
from pyqed_tpu.qchem import dft as jdft
from pyqed_tpu.qchem.tdscf import xc_kernel_ov as j_kernel

from pyqed_tpu_torch import qchem as T
from pyqed_tpu_torch.qchem import dft as tdft
from pyqed_tpu_torch.qchem.tdscf import xc_kernel_ov as t_kernel

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
    """JAX RKS mean fields, one per functional that the tests use."""
    jm, _ = mols
    return {xc: J.RKS(jm, xc=xc, **GRID).run() for xc in ("svwn", "blyp")}


def ported(jmf, mol, xc):
    return T.scf_from_reference(
        mol, T.RKS, mo_coeff=np.array(jmf.mo_coeff),
        mo_energy=np.array(jmf.mo_energy), dm=np.array(jmf.dm),
        nocc=jmf.nocc, e_tot=float(jmf.e_tot), converged=jmf.converged,
        xc=xc, **GRID)


def test_becke_grid_and_ao_values_match_jax():
    jm = J.Molecule(WATER, basis="6-31g*")
    pj, wj = (np.asarray(x) for x in jdft.becke_grid(jm.atoms))
    pt, wt = tdft.becke_grid(jm.atoms, device=CPU)
    assert err(pt, pj) < 1e-14
    assert err(wt, wj) / np.max(np.abs(wj)) < 1e-13
    vj, gj = jdft.ao_values_grad(jm.bfs, pj[::7])
    vt, gt = tdft.ao_values_grad(jm.bfs, pt[::7])
    # relative to the largest amplitude: the core functions' gradients
    # reach O(100) near the nuclei
    for a, b in ((vt, vj), (gt, gj),
                 (tdft.ao_values(jm.bfs, pt[::7]),
                  jdft.ao_values(jm.bfs, pj[::7]))):
        assert err(a, b) / np.max(np.abs(np.asarray(b))) < 1e-14


@pytest.mark.parametrize("xc", sorted(jdft.FUNCTIONALS))
def test_functionals_pointwise_match_jax(xc):
    rng = np.random.default_rng(11)
    n = 64
    ra, rb = 10.0 ** rng.uniform(-14, 1, (2, n))
    ra[:4] = 0.0                              # dead points and channels
    rb[2:6] = 0.0
    saa, sbb = 10.0 ** rng.uniform(-10, 1, (2, n))
    sab = np.sqrt(saa * sbb) * rng.uniform(-1, 1, n)
    f = jdft.FUNCTIONALS[xc][0]
    ref = [np.asarray(x) for x in jdft.gga_exc_vxc(
        f, *(jnp.asarray(v) for v in (ra, rb, saa, sab, sbb)))]
    out = tdft.gga_exc_vxc(tdft.FUNCTIONALS[xc][0],
                           *(torch.as_tensor(v) for v in (ra, rb, saa, sab,
                                                          sbb)))
    for a, b in zip(out, ref):
        assert np.all(np.isfinite(host(a)))
        assert err(a, b) / max(1.0, np.max(np.abs(b))) < 1e-12
    ref = [np.asarray(x) for x in jdft.lda_exc_vxc(jnp.asarray(ra),
                                                   jnp.asarray(rb))]
    for a, b in zip(tdft.lda_exc_vxc(torch.as_tensor(ra),
                                     torch.as_tensor(rb)), ref):
        assert np.all(np.isfinite(host(a)))
        assert err(a, b) / max(1.0, np.max(np.abs(b))) < 1e-12


@pytest.mark.parametrize("xc", ["svwn", "blyp"])
def test_rks_energy_density_and_vxc_match_jax(xc, mols, jks):
    jm, tm = mols
    jmf = jks[xc]
    tmf = T.RKS(tm, xc=xc, **GRID).run()
    assert tmf.converged
    assert abs(tmf.e_tot - jmf.e_tot) < 1e-10
    assert err(tmf.dm, jmf.dm) < 1e-8
    assert abs(tmf.nelec_on_grid() - jmf.nelec_on_grid()) < 1e-10
    D = np.array(jmf.dm)
    Ej, Vj = jmf._xc(jnp.asarray(D))
    Et, Vt = tmf._xc(torch.as_tensor(D))
    assert abs(float(Et) - float(Ej)) < 1e-10 and err(Vt, Vj) < 1e-10


@pytest.mark.parametrize("case", ["svwn-singlet", "svwn-triplet",
                                  "blyp-singlet", "blyp-triplet"])
def test_xc_kernel_and_tddft_match_jax(case, mols, jks):
    xc, spin = case.split("-")
    singlet = spin == "singlet"
    jmf = jks[xc]
    tmf = ported(jmf, mols[1], xc)
    assert err(t_kernel(tmf, singlet), j_kernel(jmf, singlet)) < 1e-10
    if singlet:         # the JAX TDA builds the kernel again: once per xc
        assert err(T.TDA(tmf).run(4), J.TDA(jmf).run(4)) < 1e-10


def test_qchem_water_pipeline_matches_jax(mols, jks):
    """examples/qchem_water.py: RHF/6-31G, LDA/STO-3G, TDA, the O K-edge."""
    jmf = J.Molecule(WATER, basis="6-31g").RHF().run()
    tmf = T.Molecule(WATER, basis="6-31g", device=CPU).RHF().run()
    assert abs(tmf.e_tot - jmf.e_tot) < 1e-10
    tks = T.RKS(mols[1], **GRID).run()
    assert abs(tks.e_tot - jks["svwn"].e_tot) < 1e-10
    jt, tt = J.TDA(jmf), T.TDA(tmf)
    assert err(tt.run(4), jt.run(4)) < 1e-10
    assert err(tt.oscillator_strength(), jt.oscillator_strength()) < 1e-8
    wj, _ = J.RXS(jmf, occidx=[0]).core_excitation(nstates=3)
    wt, _ = T.RXS(tmf, occidx=[0]).core_excitation(nstates=3)
    assert err(wt, wj) < 1e-10

"""Parity of the rest of the port's quantum chemistry with the JAX
package's, on the CPU in float64: cube files (``utils.io``), real-space
densities (``qchem.density``), spin-orbit integrals (``qchem.soc``),
qubit Hamiltonians (``qchem.qubit``), ab initio LVC models
(``qchem.vibronic``), DVR electronic structure (``qchem.dvr``) and the
Shin-Metiu models (``models.shinmetiu2e``).

The sizes are those of the JAX package's own tests (water/STO-3G, LiH
for ``LVCBuilder``, the H2 and He DVR molecules, the 13³ grid of
``tests/test_electron_dvr3d.py``). Post-SCF quantities start from the
JAX package's orbitals. Tolerances: SCF, CI and model energies 1e-10;
densities, currents and cube data 1e-10 relative to their largest
entry; SOC and one-electron matrices 1e-12; qubit Hamiltonians 1e-12;
LVC frequencies and couplings 1e-8 (finite differences of 1e-10
energies over dq = 0.05).
"""
import io

import numpy as np
import pytest
import torch

from pyqed_tpu import qchem as J
from pyqed_tpu.qchem import density as jd, dvr as jv, qubit as jq, soc as js
from pyqed_tpu.models import shinmetiu2e as jsm
from pyqed_tpu.utils import io as jio

from pyqed_tpu_torch import qchem as T
from pyqed_tpu_torch.qchem import density as td, qubit as tq, soc as ts
from pyqed_tpu_torch.qchem import dvr as tv
from pyqed_tpu_torch import models as tmodels
from pyqed_tpu_torch import utils as tutils

CPU = "cpu"
WATER = [("O", (0.0, 0.0, 0.0)), ("H", (0.0, -1.43, 1.11)),
         ("H", (0.0, 1.43, 1.11))]


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


def rel(a, b):
    return err(a, b) / max(float(np.max(np.abs(host(b)))), 1e-300)


@pytest.fixture(scope="module")
def water():
    jmf = J.Molecule(WATER, basis="sto-3g").RHF().run()
    mol = T.Molecule(WATER, basis="sto-3g", device=CPU)
    tmf = T.scf_from_reference(
        mol, T.RHF, mo_coeff=np.array(jmf.mo_coeff),
        mo_energy=np.array(jmf.mo_energy), dm=np.array(jmf.dm),
        nocc=jmf.nocc, e_tot=float(jmf.e_tot))
    return jmf, tmf


# ------------------------------------------------------------ utils.io

def test_cube_files_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(4, 3, 5))
    atoms = [("O", (0.1, 0.2, 0.3)), (1, (0.9, -0.4, 0.0))]
    cell = np.diag([2.0, 1.5, 2.5])
    texts = []
    for mod in (jio, tutils):
        buf = io.StringIO()
        mod.write_cube(buf, atoms, cell, data=data, origin=(0.5, 0, 0))
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    p = tmp_path / "d.cube"
    p.write_text(texts[1])
    ref, got = jio.read_cube(str(p)), tutils.read_cube(str(p))
    assert err(got[2], ref[2]) == 0.0 and err(got[1], ref[1]) == 0.0
    assert err(got[3], ref[3]) == 0.0
    assert [a[0] for a in got[0]] == [8, 1]


# ------------------------------------------------------------- density

def test_densities_match_jax(water):
    jmf, tmf = water
    pts = jd.cube_grid(WATER, 9, 8, 7)[0]
    assert all(err(a, b) == 0.0 for a, b in zip(
        jd.cube_grid(WATER, 9, 8, 7)[:3], td.cube_grid(WATER, 9, 8, 7)[:3]))
    rho = td.charge_density(tmf.mol.bfs, tmf.dm, pts)
    assert rho.device.type == "cpu"
    assert rel(rho, jd.charge_density(jmf.mol.bfs, jmf.dm, pts)) < 1e-10
    assert T.transition_charge_density is T.charge_density
    rng = np.random.default_rng(1)
    n = tmf.mol.nao
    g = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    sub = pts[::7]
    for fn, arg in (("transition_current_density", g),
                    ("current_density_wavefunction", g[0])):
        assert rel(getattr(td, fn)(tmf.mol.bfs, arg, sub, device=CPU),
                   getattr(jd, fn)(jmf.mol.bfs, arg, sub)) < 1e-10, fn
    assert rel(td.ao_gradients(tmf.mol.bfs, sub, device=CPU),
               jd.ao_gradients(jmf.mol.bfs, sub)) < 1e-10
    assert rel(td.ao_on_grid(tmf.mol, sub),
               jd.ao_on_grid(jmf.mol, sub)) < 1e-10


def test_density_and_mo_cubes_match_jax(water, tmp_path):
    jmf, tmf = water
    kw = dict(nx=6, ny=5, nz=4)
    files = {}
    for tag, mod, mf in (("j", jd, jmf), ("t", td, tmf)):
        files[tag] = (tmp_path / f"{tag}_rho.cube", tmp_path / f"{tag}_mo.cube")
        rho = mod.write_density_cube(str(files[tag][0]), WATER, mf.mol.bfs,
                                     mf.dm, **kw)
        mo = mod.write_mo_cube(str(files[tag][1]), mf.mol,
                               mf.mo_coeff[:, 4], **kw)
        files[tag] += (rho, mo)
    assert rel(files["t"][2], files["j"][2]) < 1e-10
    assert rel(files["t"][3], files["j"][3]) < 1e-10
    for k in (0, 1):
        a = jio.read_cube(str(files["j"][k]))[2]
        b = tutils.read_cube(str(files["t"][k]))[2]
        assert rel(b, a) < 1e-5          # five significant digits on disk


# ----------------------------------------------------------------- soc

def test_soc_matches_jax(water):
    jmf, tmf = water
    W = ts.soc_integrals(tmf.mol.bfs, WATER)
    Wj = js.soc_integrals(jmf.mol.bfs, WATER)
    assert err(W, Wj) < 1e-12
    assert err(W, -W.transpose(0, 2, 1)) < 1e-14     # antisymmetric
    assert err(ts.soc_integrals(tmf.mol.bfs, WATER, effective_charge=False),
               js.soc_integrals(jmf.mol.bfs, WATER,
                                effective_charge=False)) < 1e-12
    C = np.array(jmf.mo_coeff)
    assert err(T.soc_mo(W, tmf.mo_coeff), js.soc_mo(Wj, C)) < 1e-12
    assert err(T.soc_matrix(tmf.mol.bfs, WATER, tmf.mo_coeff),
               js.soc_matrix(jmf.mol.bfs, WATER, C)) < 1e-12
    assert err(T.soc_matrix(tmf.mol.bfs, WATER),
               js.soc_matrix(jmf.mol.bfs, WATER)) < 1e-12


# --------------------------------------------------------------- qubit

@pytest.mark.parametrize("enc", ["jw", "bk"])
def test_qubit_hamiltonian_matches_jax_and_casci(water, enc):
    jmf, tmf = water
    H = tq.qubitize(tmf, 4, 4, enc)
    assert H.device.type == "cpu"
    assert err(H, jq.qubitize(jmf, 4, 4, enc)) < 1e-12
    e_cas = T.CASCI(tmf, 4, 4).run()[0]
    Hp = tq.fix_nelec_penalty(H, 8, 2, 2, encoding=enc)
    assert err(Hp, jq.fix_nelec_penalty(np.asarray(jq.qubitize(
        jmf, 4, 4, enc)), 8, 2, 2, encoding=enc)) < 1e-12
    assert abs(float(torch.linalg.eigvalsh(Hp)[0]) - e_cas) < 1e-10
    for spin in (None, "alpha", "beta"):
        assert err(tq.number_operator(6, spin, enc, device=CPU),
                   jq.number_operator(6, spin, enc)) == 0.0


def test_active_space_and_pauli_strings_match_jax(water):
    jmf, tmf = water
    ours = tq.active_space_integrals(tmf, 4, 4)
    ref = jq.active_space_integrals(jmf, 4, 4)
    assert err(ours[0], ref[0]) < 1e-12 and err(ours[1], ref[1]) < 1e-12
    assert abs(ours[2] - ref[2]) < 1e-10
    full = tq.active_space_integrals(tmf, 2, 2)
    assert err(full[0], jq.active_space_integrals(jmf, 2, 2)[0]) < 1e-12
    p = tq.pauli_string_hamiltonian(tmf, 2, 2)
    q = jq.pauli_string_hamiltonian(jmf, 2, 2)
    assert set(p) == set(q)
    assert max(abs(p[k] - q[k]) for k in q) < 1e-12
    H = tq.qubitize(tmf, 2, 2)
    assert tq.pauli_decompose(H, 4) == pytest.approx(
        jq.pauli_decompose(np.asarray(H), 4), abs=1e-13)


# ------------------------------------------------------------ vibronic

def test_lvc_builder_matches_jax():
    from pyqed_tpu.qchem.vibronic import LVCBuilder as JB
    atoms = [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 2.8550264))]
    jb, tb = JB(atoms, nstates=3, dq=0.05), T.LVCBuilder(
        atoms, nstates=3, dq=0.05, device=CPU)
    jb.run()
    lvc = tb.run()
    assert err(tb.omegas, jb.omegas) < 1e-8 * np.max(jb.omegas)
    assert err(tb.kappa, jb.kappa) < 1e-8
    # interstate couplings: the CIS phases of the reference point may
    # differ by a sign
    assert err(np.abs(tb.lam), np.abs(jb.lam)) < 1e-8
    assert err(lvc.e_fc, jb.lvc.e_fc) < 1e-10
    assert abs(tb.e_scf0 - jb.e_scf0) < 1e-10
    assert err(tb.ab_initio_apes(0, 0.1), jb.ab_initio_apes(0, 0.1)) < 1e-10
    assert T.LVC_DFT is T.LVCBuilder


# ----------------------------------------------------------------- dvr

@pytest.fixture(scope="module")
def h2_dvr():
    jm = jv.MoleculeDVR([(1, [-1.0]), (1, [1.0])], Rf=1.5, Re=1.0)
    tm = tv.MoleculeDVR([(1, [-1.0]), (1, [1.0])], Rf=1.5, Re=1.0,
                        device=CPU)
    jmf, tmf = jv.RHF1D(jm, domain=(-12, 12), nx=40), tv.RHF1D(
        tm, domain=(-12, 12), nx=40)
    jmf.run()
    tmf.run()
    return jmf, tmf


def test_soft_coulomb_and_potential_match_jax(h2_dvr):
    r = np.array([0.0, 1e-13, 0.3, 2.0, 50.0])
    assert err(tv.soft_coulomb(r, 1.5), jv.soft_coulomb(r, 1.5)) < 1e-15
    jmf, tmf = h2_dvr
    x = np.linspace(-3, 3, 7)[:, None]
    assert err(tmf.mol.v_en(x), jmf.mol.v_en(x)) < 1e-14
    assert abs(tmf.mol.energy_nuc() - jmf.mol.energy_nuc()) < 1e-15


def test_rhf1d_and_ci_match_jax(h2_dvr):
    jmf, tmf = h2_dvr
    assert tmf.converged and jmf.converged
    assert abs(tmf.e_tot - jmf.e_tot) < 1e-10
    assert err(tmf.mo_energy, jmf.mo_energy) < 1e-10
    assert err(tmf.hcore, jmf.hcore) < 1e-12 and err(tmf.eri, jmf.eri) < 1e-12
    assert err(tv.get_veff(tmf.eri, tmf.dm),
               jv.get_veff(jmf.eri, jmf.dm)) < 1e-10
    assert abs(tmf.FCI().run()[0] - jmf.FCI().run()[0]) < 1e-10
    assert abs(tmf.CISD().run()[0] - jmf.CISD().run()[0]) < 1e-10
    assert err(tmf.CASCI(ncas=6).run(2), jmf.CASCI(ncas=6).run(2)) < 1e-10
    assert err(tv.exact_2e(tmf, 2), jv.exact_2e(jmf, 2)) < 1e-10


def test_rks1d_and_rhf2d_match_jax():
    jm = jv.MoleculeDVR([(1, [-1.0]), (1, [1.0])], Rf=1.5, Re=1.0)
    tm = tv.MoleculeDVR([(1, [-1.0]), (1, [1.0])], Rf=1.5, Re=1.0,
                        device=CPU)
    assert abs(tv.RKS1D(tm, domain=(-12, 12), nx=40).run()
               - jv.RKS1D(jm, domain=(-12, 12), nx=40).run()) < 1e-10
    jm2 = jv.MoleculeDVR([(2, [0.0, 0.0])], Rf=1.5, Re=1.0)
    tm2 = tv.MoleculeDVR([(2, [0.0, 0.0])], Rf=1.5, Re=1.0, device=CPU)
    a = tv.RHF2D(tm2, domains=[(-8, 8), (-8, 8)], nxs=[15, 15])
    b = jv.RHF2D(jm2, domains=[(-8, 8), (-8, 8)], nxs=[15, 15])
    assert abs(a.run() - b.run()) < 1e-10 and a.converged


def test_electron_dvr3d_matches_jax():
    args = ([(1.0, (0, 0, 0))], [(-6, 6)] * 3, [13] * 3)
    a = tv.ElectronDVR3D(*args, soft=0.5, device=CPU)
    b = jv.ElectronDVR3D(*args, soft=0.5)
    assert err(a.Vg, b.Vg) < 1e-12
    e = a.run(neig=2, tol=1e-9)
    assert err(e, b.run(neig=2, tol=1e-9)) < 1e-10
    assert abs(a.total_energy(nelec=2) - b.total_energy(nelec=2)) < 1e-10


# ---------------------------------------------------------- shinmetiu2e

def test_shinmetiu2e1d_matches_jax():
    a, b = tmodels.ShinMetiu2e1d(device=CPU), jsm.ShinMetiu2e1d()
    a.create_grid((-8, 8), 24)
    b.create_grid((-8, 8), 24)
    Rs = np.linspace(-2.0, 2.0, 5)
    assert err(a.pes(Rs), b.pes(Rs)) < 1e-10
    (wa, ua), (wb, ub) = a.single_point(0.5), b.single_point(0.5)
    assert err(wa, wb) < 1e-10
    assert err(a.exchange_symmetry(ua), b.exchange_symmetry(ub)) == 0.0
    assert abs(a.scf(0.5).e_tot - b.scf(0.5).e_tot) < 1e-10


def test_shinmetiu3d_matches_jax():
    a, b = tmodels.ShinMetiu3d(device=CPU), jsm.ShinMetiu3d()
    for m in (a, b):
        m.create_grid([(-4, 4)] * 3, 11)
    R = [np.array([0.3, 0.0, 0.0]), np.array([-0.2, 0.1, 0.0])]
    assert err(a.pes(R), b.pes(R)) < 1e-10

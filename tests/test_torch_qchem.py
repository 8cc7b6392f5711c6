"""Parity of the PyTorch port's GTO quantum chemistry (pyqed_tpu_torch.qchem)
with the JAX package's, on the CPU in float64.

The same atoms and basis sets go through both packages. Each molecule's
JAX mean field is computed once per module (the ``ref`` fixtures); the
post-HF tests start the port from JAX's own orbitals through
``scf_from_reference``, so degenerate rotations and MO signs do not enter.
Tolerances: integrals 1e-12 abs; SCF, MP2, CC, CI, EOM and excitation
energies 1e-10 Eh; densities and oscillator strengths 1e-8; analytic
gradients 1e-9 Eh/bohr; Hessian frequencies 1e-6 relative; the geometry
optimizer's end energy 1e-8; CPHF polarizabilities 1e-8; ``spinorb_ints``
exactly. Localised orbitals are compared through invariants.
"""
import numpy as np
import pytest
import torch

from pyqed_tpu import qchem as J
from pyqed_tpu.qchem import basis as jbasis
from pyqed_tpu.qchem import engine as jengine
from pyqed_tpu.qchem.ci import CASSCF as JCASSCF
from pyqed_tpu.qchem.grad import rhf_gradient as j_rhf_gradient
from pyqed_tpu.qchem.hessian import Hessian as JHessian

from pyqed_tpu_torch import qchem as T
from pyqed_tpu_torch.qchem import basis as tbasis
from pyqed_tpu_torch.qchem import engine as tengine
from pyqed_tpu_torch.qchem.ci import CASSCF as TCASSCF
from pyqed_tpu_torch.qchem.grad import derivative_integrals
from pyqed_tpu_torch.qchem.grad import rhf_gradient as t_rhf_gradient
from pyqed_tpu_torch.qchem.hessian import Hessian as THessian

CPU = "cpu"
WATER = [("O", (0.0, 0.0, 0.0)), ("H", (0.0, -1.43, 1.11)),
         ("H", (0.0, 1.43, 1.11))]
H2 = [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.4))]
HEH = [("He", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.46))]
H4 = [("H", (0.0, 0.0, 1.8 * i)) for i in range(4)]


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
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def ported(jmf, mol, cls):
    """The port's mean field from a JAX one's orbitals."""
    def arr(x):
        if isinstance(x, (tuple, list)):
            return tuple(np.array(y) for y in x)
        return np.array(x)
    return T.scf_from_reference(
        mol, cls, mo_coeff=arr(jmf.mo_coeff), mo_energy=arr(jmf.mo_energy),
        dm=arr(jmf.dm), nocc=jmf.nocc, e_tot=float(jmf.e_tot),
        converged=jmf.converged)


def pair(atoms, basis, **kw):
    """(JAX molecule, port molecule on the CPU)."""
    return (J.Molecule(atoms, basis=basis, **kw),
            T.Molecule(atoms, basis=basis, device=CPU, **kw))


@pytest.fixture(scope="module")
def water_sto():
    jm, tm = pair(WATER, "sto-3g")
    jmf = jm.RHF().run()
    return jmf, ported(jmf, tm, T.RHF)


@pytest.fixture(scope="module")
def water_631gs():
    jm, tm = pair(WATER, "6-31g*")
    jmf = jm.RHF().run()
    return jmf, ported(jmf, tm, T.RHF)


@pytest.fixture(scope="module")
def cation_uhf():
    jm, tm = pair(WATER, "sto-3g", charge=1, spin=1)
    jmf = jm.UHF().run()
    return jmf, tm.UHF().run()


# ----------------------------------------------------------- integrals

@pytest.mark.parametrize("atoms,basis", [(WATER, "6-31g**"), (HEH, "sto-3g")])
def test_one_electron_integrals_match_jax(atoms, basis):
    bj = jbasis.build_basis(atoms, basis)
    bt = tbasis.build_basis(atoms, basis)
    for name in ("overlap_matrix", "kinetic_matrix", "overlap_deriv_bra",
                 "kinetic_deriv_bra"):
        assert err(getattr(tbasis, name)(bt),
                   getattr(jbasis, name)(bj)) < 1e-12, name
    assert err(tbasis.nuclear_matrix(bt, atoms),
               jbasis.nuclear_matrix(bj, atoms)) < 1e-12
    C = atoms[-1][1]
    assert err(tbasis.nuclear_deriv_bra(bt, C),
               jbasis.nuclear_deriv_bra(bj, C)) < 1e-12
    assert err(tbasis.dipole_matrix(bt, (0.1, -0.2, 0.3)),
               jbasis.dipole_matrix(bj, (0.1, -0.2, 0.3))) < 1e-12
    S = tbasis.overlap_matrix(bt)
    assert np.array_equal(S, S.T)


def test_eri_engine_matches_jax_engine_and_python_oracle():
    bt = tbasis.build_basis(WATER, "sto-3g")
    bj = jbasis.build_basis(WATER, "sto-3g")
    assert err(tbasis.eri_tensor(bt), jengine.eri_tensor_native(bj)) < 1e-12
    assert err(tbasis.eri_deriv(bt), jengine.eri_deriv_native(bj)) < 1e-12
    # the port's derivative builder against the engine's own dERI, with
    # d functions on O and p functions on H
    polar = tbasis.build_basis(WATER, "6-31g**")
    assert err(tengine.eri_deriv_pairs(polar),
               tengine.eri_deriv_native(polar)) < 1e-12
    small = tbasis.build_basis(HEH, "sto-3g")
    assert err(tbasis.eri_tensor(small),
               tbasis.eri_tensor(small, native=False)) < 1e-12
    assert err(tbasis.eri_deriv(small),
               tbasis.eri_deriv(small, native=False)) < 1e-12
    assert err(tbasis.eri_tensor(small, native=False),
               jbasis.eri_tensor(jbasis.build_basis(HEH, "sto-3g"),
                                 native=False)) < 1e-12
    assert tengine.library_path().parent == tengine.BUILD


def test_failed_engine_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "eri_engine.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tengine, "SRC", bad)
    monkeypatch.setattr(tengine, "DERIV_SRC", bad)
    monkeypatch.setattr(tengine, "BUILD", tmp_path / "build")
    tengine._lib.cache_clear()
    tengine._deriv_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tbasis.eri_tensor(tbasis.build_basis(H2, "sto-3g"))
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tbasis.eri_deriv(tbasis.build_basis(H2, "sto-3g"))
        assert not tengine.available()
    finally:
        tengine._lib.cache_clear()
        tengine._deriv_lib.cache_clear()


def test_molecule_from_reference_and_dispatch():
    jm = J.Molecule(WATER, basis="6-31g*", charge=1, spin=1,
                    spherical=True)
    tm = T.molecule_from_reference(jm, device=CPU)
    assert (tm.nao, tm.nelec, tm.charge, tm.spin, tm.spherical) == \
        (jm.nao, jm.nelec, 1, 1, True)
    assert abs(tm.energy_nuc() - jm.energy_nuc()) < 1e-12
    assert err(tm.intor()[0], jm.intor()[0]) < 1e-12
    h2 = T.Molecule(H2, basis="sto-3g", device=CPU)
    assert isinstance(h2.RKS(), T.RKS) and isinstance(h2.UHF(), T.UHF)
    assert abs(h2.FCI().run()[0] - J.Molecule(H2).FCI().run()[0]) < 1e-10


def test_molecule_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        T.Molecule(H2)


# ------------------------------------------------------------ mean fields

@pytest.mark.parametrize("case", ["rhf-water-631gs", "rhf-heh+",
                                  "rhf-water-spherical", "uhf-h-atom",
                                  "uhf-water+"])
def test_scf_energies_and_densities_match_jax(case):
    kind, name = case.split("-", 1)
    atoms, basis, kw = {
        "water-631gs": (WATER, "6-31g*", {}),
        "heh+": (HEH, "sto-3g", dict(charge=1)),
        "water-spherical": (WATER, "6-31g*", dict(spherical=True)),
        "h-atom": ([("H", (0.0, 0.0, 0.0))], "6-31g", dict(spin=1)),
        "water+": (WATER, "sto-3g", dict(charge=1, spin=1)),
    }[name]
    # HeH+ has two basis functions: its DIIS error vectors span one
    # direction and the B matrix is singular to rounding, so with DIIS the
    # two packages stop (|dE| < 1e-10) at densities up to 1e-6 apart; it
    # runs the plain Roothaan iteration (diis_size=1) instead
    scf_kw = dict(diis_size=1) if name == "heh+" else {}
    jm, tm = pair(atoms, basis, **kw)
    jmf = getattr(jm, kind.upper())(**scf_kw).run()
    tmf = getattr(tm, kind.upper())(**scf_kw).run()
    assert tmf.converged and jmf.converged
    assert abs(tmf.e_tot - jmf.e_tot) < 1e-10
    if kind == "rhf":
        assert err(tmf.dm, jmf.dm) < 1e-8
        assert err(tmf.mo_energy, jmf.mo_energy) < 1e-8
    else:
        for a, b in zip(tmf.dm, jmf.dm):
            assert err(a, b) < 1e-8
        assert abs(tmf.spin_square() - jmf.spin_square()) < 1e-8


def test_mo_integrals_dipoles_and_finite_field(water_sto):
    jmf, tmf = water_sto
    for a, b in zip(tmf.mo_ints(), jmf.mo_ints()):
        assert err(a, b) < 1e-12
    assert err(T.get_eri_mo(tmf), J.get_eri_mo(jmf)) < 1e-12
    assert err(T.get_hcore_mo(tmf), J.get_hcore_mo(jmf)) < 1e-12
    assert err(tmf.dip_moment(), jmf.dip_moment()) < 1e-10
    assert err(tmf.transition_dipoles(), jmf.transition_dipoles()) < 1e-12
    assert err(tmf.polarizability(), jmf.polarizability()) < 1e-8


def test_mp2_and_ump2_match_jax(water_631gs, cation_uhf):
    jmf, tmf = water_631gs
    j, t = J.MP2(jmf).run(), T.MP2(tmf).run()
    for k in ("e_corr", "e_corr_os", "e_corr_ss", "e_scs"):
        assert abs(getattr(t, k) - getattr(j, k)) < 1e-10, k
    ju, tu = cation_uhf
    j, t = J.UMP2(ju).run(), T.UMP2(tu).run()
    assert abs(t.e_corr - j.e_corr) < 1e-10


# --------------------------------------------------------- correlated

@pytest.fixture(scope="module")
def ccsd_pair(water_sto):
    jmf, tmf = water_sto
    return J.CCSD(jmf).run(), T.CCSD(tmf).run()


def test_ccsd_and_triples_match_jax(ccsd_pair):
    jc, tc = ccsd_pair
    assert tc.converged and tc.conv_tol == 1e-10
    assert abs(tc.e_mp2 - jc.e_mp2) < 1e-10
    assert abs(tc.e_corr - jc.e_corr) < 1e-10
    assert abs(tc.ccsd_t() - jc.ccsd_t()) < 1e-10


def test_ccsd_is_exact_for_two_electrons():
    mol = T.Molecule(H2, basis="sto-3g", device=CPU)
    mf = mol.RHF().run()
    cc = T.CCSD(mf).run()
    assert abs(cc.e_tot - T.FCI(mf).run()[0]) < 1e-9
    assert cc.ccsd_t() == 0.0


def test_eom_ccsd_matches_jax():
    jm, tm = pair(H4, "sto-3g")
    jmf = jm.RHF().run()
    jc, tc = J.CCSD(jmf).run(), T.CCSD(ported(jmf, tm, T.RHF)).run()
    je, te = J.EOMCCSD(jc), T.EOMCCSD(tc)
    assert err(te.run(4), je.run(4)) < 1e-10
    assert abs(te.e_cc_check - tc.e_tot) < 1e-10


def test_spinorb_ints_equal_jax_exactly(water_sto):
    jmf, _ = water_sto
    hmo, eri = (np.asarray(x) for x in jmf.mo_ints())
    for a, b in zip(T.spinorb_ints(hmo, eri), J.spinorb_ints(hmo, eri)):
        assert np.array_equal(host(a), np.asarray(b))


@pytest.mark.parametrize("method", ["fci-h4", "fci-heh+", "cisd-water",
                                    "casci-water"])
def test_ci_energies_match_jax(method, water_sto):
    kind, name = method.split("-", 1)
    if name == "water":
        jmf, tmf = water_sto
    else:
        atoms, kw = (H4, {}) if name == "h4" else (HEH, dict(charge=1))
        jm, tm = pair(atoms, "sto-3g", **kw)
        jmf = jm.RHF().run()
        tmf = ported(jmf, tm, T.RHF)
    if kind == "casci":
        j, t = J.CASCI(jmf, 4, 4), T.CASCI(tmf, 4, 4)
    else:
        j, t = getattr(J, kind.upper())(jmf), getattr(T, kind.upper())(tmf)
    assert err(t.run(nroots=2), j.run(nroots=2)) < 1e-10
    assert err(t.make_rdm1(), j.make_rdm1()) < 1e-8


def test_casscf_matches_jax():
    jm, tm = pair(H2, "6-31g")
    jmf = jm.RHF().run()
    tmf = ported(jmf, tm, T.RHF)
    j, t = JCASSCF(jmf, 2, 2), TCASSCF(tmf, 2, 2)
    assert abs(t.run() - j.run()) < 1e-10
    assert t.converged
    assert t.e_tot <= T.CASCI(tmf, 2, 2).run()[0] + 1e-12


# ------------------------------------------------------- excited states

def test_tda_tdhf_cis_match_jax(water_631gs):
    jmf, tmf = water_631gs
    for singlet in (True, False):
        jt, tt = J.TDA(jmf, singlet), T.TDA(tmf, singlet)
        assert err(tt.run(5), jt.run(5)) < 1e-10
        assert err(T.TDHF(tmf, singlet).run(5),
                   J.TDHF(jmf, singlet).run(5)) < 1e-10
    jt, tt = J.TDA(jmf), T.CIS(tmf)
    jt.run(5), tt.run(5)
    assert err(tt.oscillator_strength(), jt.oscillator_strength()) < 1e-8
    from pyqed_tpu.qchem.tdscf import tda_density_matrix as jdm
    from pyqed_tpu_torch.qchem.tdscf import tda_density_matrix as tdm
    assert err(tdm(tt, 1), jdm(jt, 1)) < 1e-8


def test_ucis_matches_jax(cation_uhf):
    ju, tu = cation_uhf
    j, t = J.UCIS(ju), T.UCIS(tu)
    assert err(t.run(5), j.run(5)) < 1e-10
    assert err(t.oscillator_strength(), j.oscillator_strength()) < 1e-8


def test_rxs_core_excitation_matches_jax(water_631gs):
    jmf, tmf = water_631gs
    jr, tr = J.RXS(jmf, occidx=[0]), T.RXS(tmf, occidx=[0])
    wj, _ = jr.core_excitation(nstates=3)
    wt, _ = tr.core_excitation(nstates=3)
    assert err(wt, wj) < 1e-10
    assert err(tr.oscillator_strength(), jr.oscillator_strength()) < 1e-8
    for a, b in zip(T.get_ab_ras(tmf, [0], [5, 6]),
                    J.get_ab_ras(jmf, [0], [5, 6])):
        assert err(a, b) < 1e-12


def test_cphf_polarizabilities_match_jax(water_sto):
    jmf, tmf = water_sto
    assert err(T.polarizability_cphf(tmf),
               J.polarizability_cphf(jmf)) < 1e-8
    w = [0.0, 0.05, 0.1]
    assert err(T.polarizability_dynamic(tmf, w),
               J.polarizability_dynamic(jmf, w)) < 1e-8


# ------------------------------------------------------------ gradients

def test_rhf_and_uhf_gradients_match_jax(water_631gs, cation_uhf):
    jmf, tmf = water_631gs
    assert err(t_rhf_gradient(tmf), j_rhf_gradient(jmf)) < 1e-9
    ju, tu = cation_uhf
    assert err(T.scf_gradient(tu), J.scf_gradient(ju)) < 1e-9


def test_molecule_to_takes_over_the_integrals(water_sto):
    jmf, tmf = water_sto
    mol = tmf.mol
    dints = derivative_integrals(mol)
    twin = mol.to(CPU)
    assert twin is not mol and twin.device == torch.device(CPU)
    assert twin.intor()[3] is mol.intor()[3]
    assert derivative_integrals(twin)[3] is dints[3]
    assert err(t_rhf_gradient(ported(jmf, twin, T.RHF)),
               j_rhf_gradient(jmf)) < 1e-9
    twin.molecular_frame()          # a new geometry drops both caches
    assert twin._ints is None and twin._deriv_ints is None
    assert mol._deriv_ints is dints


def test_hessian_frequencies_match_jax():
    jf = JHessian(H2, basis="sto-3g").vibrational_frequencies(linear=True)
    tf = THessian(H2, basis="sto-3g",
                  device=CPU).vibrational_frequencies(linear=True)
    assert np.max(np.abs(tf - jf) / np.abs(jf)) < 1e-6


def test_geometry_optimizer_matches_jax():
    atoms0 = [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.8))]
    j = J.GeometryOptimizer(atoms0, basis="sto-3g", gtol=1e-5).run()
    t = T.GeometryOptimizer(atoms0, basis="sto-3g", gtol=1e-5,
                            device=CPU).run()
    assert t.converged and abs(t.e_tot - j.e_tot) < 1e-8
    re = np.linalg.norm(t.atoms_opt[1][1] - t.atoms_opt[0][1])
    assert abs(re - 1.346) < 1e-2


def test_finite_difference_grad_and_scan_match_jax():
    # central differences of SCF energies: a tight SCF keeps their noise
    # (conv_tol / step) below the tolerance
    g = T.Grad(atoms=H2, basis="6-31g", conv_tol=1e-13, device=CPU).run()
    j = J.Grad(atoms=H2, basis="6-31g", conv_tol=1e-13).run()
    assert err(g.de, j.de) < 1e-8
    s = T.scan_pes(lambda r: [("H", (0, 0, 0)), ("H", (0, 0, r))],
                   [1.2, 1.4], device=CPU)
    assert err(s, J.scan_pes(lambda r: [("H", (0, 0, 0)),
                                        ("H", (0, 0, r))], [1.2, 1.4])) < 1e-10


# ------------------------------------------------ localisation, analysis

def test_localisation_and_populations_match_jax(water_sto):
    jmf, tmf = water_sto
    for name in ("boys", "pipek_mezey", "ibo"):
        Ct, Cj = getattr(T, name)(tmf), getattr(J, name)(jmf)
        # invariants: the localisation objective and the sorted centres
        assert abs(T.lo.orbital_spread(tmf, Ct)
                   - J.lo.orbital_spread(jmf, Cj)) < 1e-8, name
        ct = np.sort(T.orbital_centers(tmf, Ct), axis=0)
        cj = np.sort(J.orbital_centers(jmf, Cj), axis=0)
        assert err(ct, cj) < 1e-6, name
    assert err(T.mulliken_charges(tmf), J.mulliken_charges(jmf)) < 1e-10
    assert err(T.iao_charges(tmf), J.iao_charges(jmf)) < 1e-10
    A_t, A_j = T.iao(tmf), J.iao(jmf)
    assert err(A_t @ A_t.T, A_j @ A_j.T) < 1e-10
    assert T.find_homo_lumo(tmf) == pytest.approx(J.find_homo_lumo(jmf),
                                                  abs=1e-12)
    S = host(tmf.S)
    V = T.vec_lowdin(host(tmf.mo_coeff)[:, :3], S)
    assert err(V.T @ S @ V, np.eye(3)) < 1e-12


def test_ci_overlap_and_nonadiabatic_coupling_match_jax():
    bj = jbasis.build_basis(H2, "6-31g")
    bt = tbasis.build_basis([("H", (0, 0, 0.1)), ("H", (0, 0, 1.4))],
                            "6-31g")
    bj2 = jbasis.build_basis([("H", (0, 0, 0.1)), ("H", (0, 0, 1.4))],
                             "6-31g")
    assert err(T.cross_overlap_ao(tbasis.build_basis(H2, "6-31g"), bt),
               J.cross_overlap_ao(bj, bj2)) < 1e-12

    def make(m):
        return lambda R: m([("H", (0, 0, 0)), ("H", (0, 0, R))],
                           basis="6-31g")

    # the first excited root of H2 belongs to a degenerate triplet, whose
    # rotation is arbitrary, so only the ground state's row is defined
    tau_j = J.nonadiabatic_coupling(make(J.Molecule), 1.4, None, nroots=2)
    tau_t = T.nonadiabatic_coupling(
        make(lambda a, basis: T.Molecule(a, basis=basis, device=CPU)),
        1.4, None, nroots=2)
    assert err(tau_t[0], tau_j[0]) < 1e-8
    # the batched determinant overlap itself, on random CI vectors
    rng = np.random.default_rng(7)
    dets = J.ci.enumerate_dets(8, 2)
    cb, ck = rng.standard_normal((2, len(dets), 3))
    smo = np.eye(4) + 0.1 * rng.standard_normal((4, 4))
    assert err(T.ci_overlap(dets, cb, dets, ck, smo, device=CPU),
               J.ci_overlap(dets, cb, dets, ck, smo)) < 1e-12


def test_geometry_helpers_match_jax(tmp_path):
    from pyqed_tpu.qchem import geometry as jg
    from pyqed_tpu_torch.qchem import geometry as tg
    z = [("O",), ("H", 0, 1.8), ("H", 0, 1.8, 1, 1.82),
         ("H", 0, 1.9, 1, 1.7, 2, 2.0)]
    assert err(tg.zmatrix_to_cartesian(z), jg.zmatrix_to_cartesian(z)) == 0
    mol = T.Molecule(WATER, device=CPU)
    assert err(tg.grad_nuc(mol), jg.grad_nuc(J.Molecule(WATER))) < 1e-14
    rng = np.random.default_rng(3)
    ref = mol.atom_coords()
    cur = ref @ np.linalg.qr(rng.standard_normal((3, 3)))[0] + 0.3
    m = mol.atom_mass_list()
    for a, b in zip(tg.eckart_frame(ref, cur, m), jg.eckart_frame(ref, cur, m)):
        assert err(a, b) < 1e-12
    assert err(tg.quasi_angular_momentum(m, ref, cur),
               jg.quasi_angular_momentum(m, ref, cur)) < 1e-12
    mol.tofile(tmp_path / "w.xyz")
    back = tg.read_xyz(tmp_path / "w.xyz")
    assert err(np.array([x for _, x in back]), ref) < 1e-9
    assert mol.zmat() == J.Molecule(WATER).zmat()

    def geom_t(q):                       # a bent triatomic, torch ops
        r, th = q[0], q[1]
        zero = torch.zeros_like(r)
        return torch.stack([torch.stack([zero, zero, zero]),
                            torch.stack([zero, zero, r]),
                            torch.stack([r * torch.sin(th), zero,
                                         r * torch.cos(th)])])

    import jax.numpy as jnp

    def geom_j(q):
        r, th = q[0], q[1]
        return jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0, 0, 0]]) * 0 \
            + jnp.stack([jnp.zeros(3), jnp.array([0.0, 0.0, 1.0]) * r,
                         jnp.array([jnp.sin(th), 0.0, jnp.cos(th)]) * r])

    q = np.array([1.8, 1.9])
    for a, b in zip(tg.gmatrix(geom_t, q, m, device=CPU),
                    jg.gmatrix(geom_j, q, m)):
        assert err(a, b) < 1e-12
    qs = np.array([[1.8, 1.9], [1.7, 2.0]])
    for a, b in zip(tg.gmatrix_grid(geom_t, qs, m, device=CPU),
                    jg.gmatrix_grid(geom_j, qs, m)):
        assert err(a, b) < 1e-12

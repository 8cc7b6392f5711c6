"""Parity of the PyTorch port's tensor networks (pyqed_tpu_torch.tn) with
the JAX package's, on the CPU at complex128.

Inputs are made with NumPy from seeds and handed to both packages;
``mps_from_reference``/``mpo_from_reference`` carry JAX MPS and MPO
tensors across. The JAX DMRG, TDVP and TT runs compile per shape, so
each is run once per module (the ``jref`` fixture) on short chains.
Tolerances: NumPy-built MPOs agree exactly; DMRG is compared through
invariants (energies 1e-10; Schmidt spectra, expectation values,
entropies, the dense state up to a global phase 1e-8), because the SVD
gauges of the two backends differ; TDVP (positive-diagonal QR gauge) and
TT-LDR directly at 1e-10.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu import tn as jtn
from pyqed_tpu.grid import LDRN as JLDRN
from pyqed_tpu.models.vibronic import Pyrazine4 as JPyrazine4
from pyqed_tpu.tn import autompo as jauto
from pyqed_tpu.tn import chemps as jchem
from pyqed_tpu.tn import ttspo as jtts
from pyqed_tpu.tn.mps import apply_mpo as japply_mpo

import pyqed_tpu_torch as pt
from pyqed_tpu_torch import tn
from pyqed_tpu_torch.models.vibronic import Pyrazine4
from pyqed_tpu_torch.tn import autompo as tauto
from pyqed_tpu_torch.tn import chemps as tchem
from pyqed_tpu_torch.tn.mps import apply_mpo, mpo_from_reference, \
    mps_from_reference

CPU = "cpu"
RTOL = 1e-10
SX = np.array([[0.0, 1.0], [1.0, 0.0]], complex)
SZ = np.diag([1.0, -1.0]).astype(complex)


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


def err(a, b):
    """max|a - b| / max(1, max|b|)."""
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b)))


def phase_err(a, b):
    """|1 - |<a|b>|| for normalized dense states (global phase free)."""
    a, b = host(a).ravel(), host(b).ravel()
    return abs(1.0 - abs(np.vdot(a, b)) / np.linalg.norm(a)
               / np.linalg.norm(b))


def dense_state(Ms):
    psi = host(Ms[0])
    for M in Ms[1:]:
        psi = np.einsum("a...b, bpc -> a...pc", psi, host(M))
    return psi.reshape(-1)


def mps_of(jmps):
    return mps_from_reference([np.asarray(B) for B in jmps.Bs],
                              [np.asarray(S) for S in jmps.Ss], device=CPU)


def mf_h2():
    """A duck-typed DVR mean field: 3 grid points, soft-Coulomb diagonal
    ERI, 2 electrons (the attributes DMRGElectronicDVR reads)."""
    x = np.linspace(-1.5, 1.5, 3)
    h = -0.5 * (np.diag(np.full(2, 1.0), 1) + np.diag(np.full(2, 1.0), -1))
    h += np.diag(-1.0 / np.sqrt((x - 0.7) ** 2 + 1) - 1.0
                 / np.sqrt((x + 0.7) ** 2 + 1))
    eri = 1.0 / np.sqrt(np.subtract.outer(x, x) ** 2 + 1.0)

    class Mol:
        nelec = 2

        @staticmethod
        def energy_nuc():
            return 1.0 / np.sqrt(1.4 ** 2 + 1.0)

    class MF:
        hcore, mol = h, Mol()

    MF.eri = eri
    return MF()


def ldr_model():
    """tests/test_ttspo.py's 2-D two-state model at level 3 (7 x 7 x 2)."""
    domains = [(-4.0, 4.0), (-4.0, 4.0)]
    ldr = JLDRN(domains, [3, 3], nstates=2, mass=[1.0, 1.2])
    X, Y = np.meshgrid(ldr.x[0], ldr.x[1], indexing="ij")
    v = np.stack([0.5 * (X ** 2 + Y ** 2),
                  0.5 * ((X - 1) ** 2 + Y ** 2) + 0.5], axis=-1)
    th = 0.3 * np.exp(-(X ** 2 + Y ** 2))
    states = np.stack([np.stack([np.cos(th), np.sin(th)], -1),
                       np.stack([-np.sin(th), np.cos(th)], -1)], -2)
    psi0 = np.zeros((*X.shape, 2), complex)
    psi0[..., 0] = np.exp(-((X + 0.5) ** 2 + Y ** 2))
    psi0 /= np.linalg.norm(psi0)
    ldr.set_apes(v)
    A = np.array(ldr.build_ovlp(states))
    return domains, v, A, psi0, states


VIB = dict(H_el=np.diag([0.0, 1.0]), omegas=[0.2, 0.4],
           couplings=[np.diag([0.1, -0.1]),
                      np.array([[0.0, 0.15], [0.15, 0.0]])])
PYR = dict(nb=2, chi_max=4, nt=2, nout=1)
TT_RUN = dict(rank_state=64, rank_pes=64, rank_ovlp=256, nout=1)
BOND = -np.kron(SZ, SZ) - 0.5 * (np.kron(SX, np.eye(2))
                                 + np.kron(np.eye(2), SX))


@pytest.fixture(scope="module")
def jref():
    """Every JAX run of this module, once (eager JAX compiles each new
    shape, so the chains are short)."""
    out = {}
    L = 4
    out["dmrg"] = jtn.two_site_dmrg(
        jtn.mpo_tfim(L, J=1.0, h=0.7), jtn.MPS.random(L, chi=4, seed=1),
        chi_max=4, sweeps=2)
    rnd = jtn.MPS.random(L, chi=4, seed=3)
    td = jtn.TDVP(jtn.mpo_tfim(L, J=1.0, h=2.0), rnd, krylov_dim=8)
    td.run(0.05, 2)
    out["tdvp"] = (rnd, td, td.expect_mpo(), td.expect_local([SX] * L))
    out["tebd"] = jtn.tebd(jtn.MPS.from_product_state([[1.0, 0.0]] * L),
                           BOND, 0.05, 4, chi_max=16)
    domains, v, A, psi0, _ = ldr_model()
    tt = jtts.TT_LDR(domains, [3, 3], nstates=2, mass=[1.0, 1.2])
    tt.set_apes(v)
    tt.set_ovlp(A)
    out["ttldr"] = tt.run(psi0, 0.02, 2, **dict(TT_RUN, e_ops=[v]))
    out["pyr"] = JPyrazine4().spectral_dynamics(**PYR)
    return out


# ------------------------------------------------------------ builders

@pytest.mark.parametrize("name", ["tfim", "heisenberg", "nn"])
def test_mpo_builders_match_jax(name):
    if name == "tfim":
        j, t = jtn.mpo_tfim(5, 1.0, 0.7), tn.mpo_tfim(5, 1.0, 0.7, device=CPU)
    elif name == "heisenberg":
        j = jtn.mpo_heisenberg(4, J=0.8, h=0.3)
        t = tn.mpo_heisenberg(4, J=0.8, h=0.3, device=CPU)
    else:
        hs, hl, hr = 0.3 * SX, SZ, 0.5 * SZ
        j = jtn.mpo_nearest_neighbor(4, hs, hl, hr)
        t = tn.mpo_nearest_neighbor(4, hs, hl, hr, device=CPU)
    for Wj, Wt in zip(j.Ws, t.Ws):
        assert err(Wt, Wj) == 0.0
    assert err(t.to_dense(), j.to_dense()) <= 1e-14
    H = host(t.to_dense())
    assert err((t @ t).to_dense(), H @ H) <= 1e-13


def _rand_herm(n, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n))
    return t + t.T, np.triu(rng.standard_normal((n, n)), 1)


def test_autompo_builders_match_jax():
    t, v = _rand_herm(4, 0)
    pairs = [(jauto.autompo_fermion(t, v),
              tauto.autompo_fermion(t, v, device=CPU)),
             (jauto.autoMPO(t + 0.2j * np.triu(t, 1) - 0.2j * np.tril(t, -1),
                            v),
              tauto.autoMPO(t + 0.2j * np.triu(t, 1) - 0.2j * np.tril(t, -1),
                            v, device=CPU)),
             (jauto.hubbard_mpo(2, t=1.0, U=4.0, mu=0.5),
              tauto.hubbard_mpo(2, t=1.0, U=4.0, mu=0.5, device=CPU)),
             (jauto.spin_squared_mpo(2), tauto.spin_squared_mpo(2, device=CPU))]
    j, p = pairs[2]
    pairs.append((jauto.fix_spin_mpo(j, 2, shift=0.5, ss=0.0),
                  tauto.fix_spin_mpo(p, 2, shift=0.5, ss=0.0)))
    pairs.append((jauto.fix_nelec_mpo(j, 2, shift=2.0),
                  tauto.fix_nelec_mpo(p, 2, shift=2.0)))
    pairs.append((jauto.mpo_scale(jauto.mpo_add(j, j), -0.3),
                  tauto.mpo_scale(tauto.mpo_add(p, p), -0.3)))
    pairs.append((jauto.mpo_shift(j, 1.7), tauto.mpo_shift(p, 1.7)))
    for j, p in pairs:
        for Wj, Wt in zip(j.Ws, p.Ws):
            assert err(Wt, Wj) == 0.0
        assert err(p.to_dense(), j.to_dense()) <= 1e-13
    for a, b in zip(jauto.spinful_to_sites(t[:2, :2], t[:2, :2], 3.0),
                    tauto.spinful_to_sites(t[:2, :2], t[:2, :2], 3.0)):
        assert err(b, a) == 0.0
    for a, b in zip(jauto.number_penalty(4, 2, 1.5)[:2],
                    tauto.number_penalty(4, 2, 1.5)[:2]):
        assert err(b, a) == 0.0


def test_chemps_builders_match_jax():
    rng = np.random.default_rng(4)
    L = 4
    h = rng.standard_normal((L, L))
    h = h + h.T
    g = rng.standard_normal((L, L, L, L))
    g = g - g.transpose(1, 0, 2, 3)
    g = g - g.transpose(0, 1, 3, 2)
    g = g + g.transpose(2, 3, 0, 1)
    for kind in ("c", "cdag"):
        assert err(tchem.jw_op(kind, 2, L), jchem.jw_op(kind, 2, L)) == 0.0
    cj, oj = jchem.spin_orbital_terms(h, g)
    ct, ot = tchem.spin_orbital_terms(h, g)
    assert err(ct, cj) == 0.0 and err(ot, oj) == 0.0
    for j, t in ((jchem.qc_mpo(h, g, nelec=2), tchem.qc_mpo(h, g, nelec=2,
                                                             device=CPU)),
                 (jchem.number_mpo(L), tchem.number_mpo(L, device=CPU)),
                 (jchem.mpo_from_product_terms(cj[:7], oj[:7]),
                  tchem.mpo_from_product_terms(ct[:7], ot[:7], device=CPU))):
        for Wj, Wt in zip(j.Ws, t.Ws):
            assert err(Wt, Wj) == 0.0
    hf = tchem._hartree_fock_mps(L, [0, 1], device=CPU)
    assert err(hf.to_dense(), jchem._hartree_fock_mps(L, [0, 1]).to_dense()) \
        == 0.0


def test_dmrgqc_h4_matches_jax_and_fci():
    """examples/ab_initio_dmrg.py: H4/STO-3G, 8 spin orbitals, bond 16
    (exact for 8 sites); the port starts from JAX's orbitals."""
    from pyqed_tpu import qchem as jq
    from pyqed_tpu_torch import qchem as tq
    atoms = [("H", (0.0, 0.0, 1.8 * i)) for i in range(4)]
    jmf = jq.Molecule(atoms, basis="sto-3g").RHF().run()
    tmf = tq.scf_from_reference(
        tq.Molecule(atoms, basis="sto-3g", device=CPU), tq.RHF,
        mo_coeff=np.array(jmf.mo_coeff), mo_energy=np.array(jmf.mo_energy),
        dm=np.array(jmf.dm), nocc=jmf.nocc, e_tot=float(jmf.e_tot))
    j = jtn.DMRGQC(jmf, D=16)
    t = tn.DMRGQC(tmf, D=16)
    # the integrals agree to rounding; the SVD-compressed MPO tensors then
    # differ by gauge, so the energies are compared
    assert err(t.h, j.h) < 1e-12 and err(t.g, j.g) < 1e-12
    e_t, e_j = t.run(sweeps=6), j.run(sweeps=6)
    assert abs(e_t - e_j) < 1e-8
    assert abs(e_t - tq.FCI(tmf).run()[0]) < 1e-8


# ----------------------------------------------------------------- MPS

def test_mps_random_and_pad_noise_match_jax():
    j = jtn.MPS.random(6, d=2, chi=4, seed=5)
    t = tn.MPS.random(6, d=2, chi=4, seed=5, device=CPU)
    for a, b in zip(t.Ss, j.Ss):
        assert err(a, b) <= 1e-12
    assert phase_err(t.to_dense(), j.to_dense()) <= 1e-12
    jp = jtn.MPS.from_product_state([[1.0, 0.0], [0.6, 0.8]] * 3) \
        .pad_noise(4, noise=1e-3, seed=1)
    tp = tn.MPS.from_product_state([[1.0, 0.0], [0.6, 0.8]] * 3,
                                   device=CPU).pad_noise(4, noise=1e-3,
                                                         seed=1)
    assert tp.get_bond_dimensions() == [int(B.shape[2]) for B in jp.Bs]
    assert phase_err(tp.to_dense(), jp.to_dense()) <= 1e-12


def test_mps_algebra_against_dense_and_jax():
    """The MPS algebra against dense NumPy truths of the same state, and
    the compression and MPO application against JAX (gauge-free)."""
    rng = np.random.default_rng(6)
    L = 4
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi /= np.linalg.norm(psi)
    t = tn.MPS.from_dense(psi, [2] * L, device=CPU)
    assert err(t.to_dense(), psi) <= 1e-12
    assert err(t.norm(), 1.0) <= 1e-12

    def site(op, k):
        ops = [np.eye(2)] * L
        ops[k] = op
        out = ops[0]
        for o in ops[1:]:
            out = np.kron(out, o)
        return out

    assert err(t.site_expectation_value(SZ),
               [psi.conj() @ site(SZ, k) @ psi for k in range(L)]) <= 1e-12
    XZ = np.kron(SX, SZ)
    assert err(t.bond_expectation_value(XZ), [
        psi.conj() @ np.kron(np.kron(np.eye(2 ** k), XZ),
                             np.eye(2 ** (L - k - 2))) @ psi
        for k in range(L - 1)]) <= 1e-12
    assert err(t.correlation_function(SZ, 0, SX, 3),
               psi.conj() @ site(SZ, 0) @ site(SX, 3) @ psi) <= 1e-12
    ent = []
    for k in range(1, L):
        p = np.linalg.svd(psi.reshape(2 ** k, -1), compute_uv=False) ** 2
        ent.append(-np.sum(p * np.log(p)))
    assert err(t.entanglement_entropy(), ent) <= 1e-12
    other = tn.MPS.random(L, chi=4, seed=8, device=CPU)
    assert err(t.overlap(other),
               np.vdot(psi, host(other.to_dense()))) <= 1e-12
    mpo = tn.mpo_tfim(L, device=CPU)
    H = host(mpo.to_dense())
    assert err(mpo.expect(t), psi.conj() @ H @ psi) <= 1e-12
    assert phase_err((mpo @ t).to_dense(), H @ psi) <= 1e-12

    j = jtn.MPS.from_dense(jnp.asarray(psi), [2] * L)
    (tc, te), (jc, je) = (t.compress(2, return_error=True),
                          j.compress(2, return_error=True))
    assert abs(te - je) <= 1e-12
    assert phase_err(tc.to_dense(), jc.to_dense()) <= 1e-12
    assert phase_err(apply_mpo(mpo, t, chi_max=3).to_dense(),
                     japply_mpo(jtn.mpo_tfim(L), j, chi_max=3).to_dense()) \
        <= 1e-12
    B = rng.standard_normal((3, 2, 3)) * 0.5
    T = np.einsum("apb, cpd -> acbd", B, B).reshape(9, 9)
    lam = np.sort(np.abs(np.linalg.eigvals(T)))[::-1]
    assert abs(tn.MPS([B], bc="infinite").correlation_length()
               + 1.0 / np.log(lam[1] / lam[0])) <= 1e-10


def test_ncon_matches_jax():
    rng = np.random.default_rng(9)
    A, B, C = (rng.standard_normal(s) for s in ((3, 4, 5), (5, 4, 2),
                                                  (2, 6)))
    labels = [[-1, 1, 2], [2, 1, 3], [3, -2]]
    assert err(tn.ncon([A, B, C], labels),
               jtn.ncon([A, B, C], labels)) <= 1e-13
    assert err(tn.ncon([A, B, C], labels, forder=[-2, -1]),
               jtn.ncon([A, B, C], labels, forder=[-2, -1])) <= 1e-13


# ---------------------------------------------------------------- DMRG

def test_dmrg_invariants_match_jax(jref):
    mpo = tn.mpo_tfim(4, J=1.0, h=0.7, device=CPU)
    jE, jgs = jref["dmrg"]
    E, gs = tn.two_site_dmrg(mpo, tn.MPS.random(4, chi=4, seed=1,
                                                device=CPU),
                             chi_max=4, sweeps=2)
    assert np.max(np.abs(np.subtract(E, jE))) <= RTOL * abs(jE[-1])
    for a, b in zip(gs.Ss[1:], jgs.Ss[1:]):
        assert err(a, b) <= 1e-8
    assert err(gs.entanglement_entropy(), jgs.entanglement_entropy()) <= 1e-8
    assert err(gs.site_expectation_value(SZ),
               jgs.site_expectation_value(jnp.asarray(SZ))) <= 1e-8
    assert phase_err(gs.to_dense(), jgs.to_dense()) <= 1e-10
    assert abs(E[-1] - np.linalg.eigvalsh(host(mpo.to_dense()))[0]) <= 1e-8


@pytest.mark.parametrize("model", ["heisenberg", "hubbard"])
def test_dmrg_reaches_the_dense_ground_energy(model):
    """DMRG of the JAX tests' models against exact diagonalisation of
    the JAX package's own MPO (tests/test_tn.py, test_tdvp_autompo.py)."""
    if model == "heisenberg":
        jmpo = jtn.mpo_heisenberg(6, J=1.0, h=0.1)
        mpo, L = tn.mpo_heisenberg(6, J=1.0, h=0.1, device=CPU), 6
    else:
        jmpo = jauto.hubbard_mpo(3, t=1.0, U=4.0, mu=2.0)
        mpo, L = tauto.hubbard_mpo(3, t=1.0, U=4.0, mu=2.0, device=CPU), 6
    E0 = np.linalg.eigvalsh(np.asarray(jmpo.to_dense()))[0]
    E, gs = tn.two_site_dmrg(mpo, tn.MPS.random(L, chi=8, seed=0,
                                                device=CPU),
                             chi_max=16, sweeps=6)
    assert abs(E[-1] - E0) <= 1e-8
    assert abs(complex(mpo.expect(gs)) - E[-1]) <= 1e-10


def test_dmrg_class_and_device_checks():
    mpo = tn.mpo_tfim(4, device=CPU)
    solver = tn.DMRG(mpo, tn.MPS.random(4, chi=4, seed=0, device=CPU),
                     chi_max=8)
    E, gs = solver.run(sweeps=3)
    assert gs is solver.psi and len(E) <= 3
    meta = tn.MPO([W.to("meta") for W in mpo.Ws])
    for make in (lambda: tn.DMRG(meta, gs), lambda: tn.TDVP(meta, gs)):
        with pytest.raises(ValueError, match="MPO is on meta"):
            make()
    assert tn.MatrixProductState is tn.MPS


def test_tebd_matches_jax_and_dense(jref):
    psi0 = tn.MPS.from_product_state([[1.0, 0.0]] * 4, device=CPU)
    psi = tn.tebd(psi0, BOND, 0.05, 4, chi_max=16)
    jpsi = jref["tebd"]
    assert phase_err(psi.to_dense(), jpsi.to_dense()) <= 1e-12
    for a, b in zip(psi.Ss[1:], jpsi.Ss[1:]):
        assert err(a, b) <= 1e-10
    # first-order TEBD on 4 sites: even then odd bonds, dense
    psi1 = host(tn.tebd(psi0, BOND, 0.05, 1, order=1).to_dense())
    w, V = np.linalg.eigh(BOND)
    U = (V * np.exp(-0.05j * w)) @ V.conj().T
    I2 = np.eye(2)
    ref = np.kron(I2, np.kron(U, I2)) @ np.kron(U, U) @ host(psi0.to_dense())
    assert phase_err(psi1, ref) <= 1e-12


def test_dmrg_electronic_dvr_against_dense():
    """DMRGElectronicDVR on a duck-typed mean field: its energy equals the
    lowest eigenvalue of the JAX package's penalized MPO, plus the
    penalty constant and the nuclear repulsion."""
    mf = mf_h2()
    e = tauto.DMRGElectronicDVR(mf, lam=4.0, chi_max=16,
                                device=CPU).run(sweeps=4)
    ts, V = jauto.spinful_to_sites(mf.hcore, v_spatial=mf.eri)
    tsh, vsh, const = jauto.number_penalty(6, 2, 4.0)
    H = np.asarray(jauto.autompo_fermion(ts + tsh, V + vsh).to_dense())
    ref = np.linalg.eigvalsh(H)[0] + const + mf.mol.energy_nuc()
    assert abs(e - ref) <= 1e-8 * abs(ref)


# ---------------------------------------------------------------- TDVP

def test_tdvp_matches_jax(jref):
    rnd, jtd, jE, jloc = jref["tdvp"]
    td = tn.TDVP(tn.mpo_tfim(4, J=1.0, h=2.0, device=CPU), mps_of(rnd),
                 krylov_dim=8)
    td.run(0.05, 2)
    for a, b in zip(td.Ms, jtd.Ms):
        assert err(a, b) <= RTOL
    assert abs(td.expect_mpo() - jE) <= RTOL * abs(jE)
    # <sx_i>: site 0 as JAX's; every site as the dense state's (JAX's
    # snapshot skips the QR sweep, so its values past site 0 are not
    # the state's)
    loc = td.expect_local([SX] * 4)
    assert abs(loc[0] - jloc[0]) <= RTOL
    psi = host(td.to_mps().to_dense())
    for i in range(4):
        op = np.kron(np.kron(np.eye(2 ** i), SX), np.eye(2 ** (3 - i)))
        assert abs(loc[i] - psi.conj() @ op @ psi) <= 1e-12
    assert phase_err(psi, dense_state(jtd.Ms)) <= 1e-12


def test_tdvp2_against_dense_quench():
    """TDVP2 from |up...up> against exact propagation with the JAX
    package's dense TFIM (tests/test_tdvp_autompo.py's quench)."""
    L = 6
    td2 = tn.TDVP2(tn.mpo_tfim(L, J=1.0, h=1.0, device=CPU),
                   tn.MPS.from_product_state([[1.0, 0.0]] * L, device=CPU),
                   chi_max=32, krylov_dim=12)
    td2.run(0.05, 20)
    w, V = np.linalg.eigh(np.asarray(jtn.mpo_tfim(L, J=1.0, h=1.0)
                                     .to_dense()))
    psi0 = np.zeros(2 ** L)
    psi0[0] = 1.0
    psit = V @ (np.exp(-1j * w) * (V.conj().T @ psi0))
    assert phase_err(dense_state(td2.Ms), psit) <= 1e-6


def test_mps_mpo_from_reference_round_trip(jref):
    _, jgs = jref["dmrg"]
    gs = mps_of(jgs)
    jmpo = jtn.mpo_tfim(4, J=1.0, h=0.7)
    mpo = mpo_from_reference([np.asarray(W) for W in jmpo.Ws], device=CPU)
    assert err(gs.to_dense(), jgs.to_dense()) <= 1e-14
    assert abs(complex(mpo.expect(gs)) - complex(jmpo.expect(jgs))) <= 1e-12


# ---------------------------------------------------------------- TT

def test_tt_algebra_against_dense_and_jax():
    rng = np.random.default_rng(10)
    T = rng.standard_normal((4, 5, 3)) + 1j * rng.standard_normal((4, 5, 3))
    V = rng.standard_normal((4, 5, 3))
    p, v = tn.tt_svd(T, max_rank=8, device=CPU), tn.tt_svd(V, device=CPU)
    assert abs(tn.tt_norm(p) - np.linalg.norm(T)) <= 1e-12
    assert abs(tn.tt_inner(v, p) - np.vdot(V, T)) <= 1e-12
    assert err(tn.tt_to_dense(tn.hadamard_apply(v, p)), V * T) <= 1e-12
    W = [rng.standard_normal(s) for s in ((1, 4, 4, 2), (2, 5, 5, 2),
                                          (2, 3, 3, 1))]
    Wd = np.einsum("aijb, bklc, cmnd -> ikmjln", *W).reshape(60, 60)
    assert err(tn.tt_to_dense(tn.mpo_apply(W, p)).reshape(-1),
               Wd @ T.reshape(-1)) <= 1e-12
    jp = jtn.tt_svd(T, max_rank=8)
    for a, b in ((tn.tt_compress(p, 2), jtn.tt_compress(jp, 2)),
                 (tn.tt_compress(p, 8, eps=0.3),
                  jtn.tt_compress(jp, 8, eps=0.3))):
        assert [int(G.shape[2]) for G in a] == [int(G.shape[2]) for G in b]
        assert err(tn.tt_to_dense(a), jtts.tt_to_dense(b)) <= 1e-12


def test_ttldr_matches_jax(jref):
    domains, v, A, psi0, states = ldr_model()
    tt = tn.TT_LDR(domains, [3, 3], nstates=2, mass=[1.0, 1.2], device=CPU)
    tt.set_apes(v)
    tt.set_ovlp(A)
    out = tt.run(psi0, 0.02, 2, **dict(TT_RUN, e_ops=[v]))
    ref = jref["ttldr"]
    for cs, jcs in zip(out["cores_list"], ref["cores_list"]):
        assert err(tn.tt_to_dense(cs), jtts.tt_to_dense(jcs)) <= RTOL
    for key in ("rdm_el", "norms", "expect"):
        assert err(out[key], ref[key]) <= RTOL
    assert err(tt.population(out["cores_list"][-1]),
               np.diag(ref["rdm_el"][-1]).real) <= RTOL


def test_ttldr_diabatic_equals_dense_strang():
    """Diabatic TT-SPO at full rank against a dense NumPy Strang loop
    with the same DVR kinetic factors (tests/test_ttspo.py's check)."""
    domains, v, _, psi0, _ = ldr_model()
    tt = tn.TT_LDR(domains, [3, 3], nstates=2, mass=[1.0, 1.2], device=CPU)
    tt.set_apes(v)
    out = tt.run(psi0, 0.02, 4, rank_state=128, rank_pes=128, nout=2)
    K0, K1 = (host(K) for K in tt.exp_K)
    expV2 = np.exp(-0.01j * v)
    psi = psi0.copy()
    for _ in range(4):
        psi = expV2 * psi
        psi = np.einsum("im, mjs -> ijs", K0, psi)
        psi = np.einsum("jn, ins -> ijs", K1, psi)
        psi = expV2 * psi
    assert err(tn.tt_to_dense(out["cores_list"][-1]), psi) <= 1e-10
    assert err(out["norms"], np.ones(3)) <= 1e-10


def test_ttldr_full_rank_equals_dense_ldrn():
    """Full-rank TT-LDR against the port's own dense LDRN stepping
    (tests/test_ttspo.py's check, in the port)."""
    domains, v, A, psi0, states = ldr_model()
    ldr = pt.LDRN(domains, [3, 3], nstates=2, mass=[1.0, 1.2], device=CPU)
    ldr.set_apes(v)
    A_port = ldr.build_ovlp(states)
    assert err(A_port, A) <= 1e-14
    U = host(ldr.short_time_propagator(0.02))
    psi = psi0.reshape(-1)
    for _ in range(4):
        psi = U @ psi
    tt = tn.TT_LDR(domains, [3, 3], nstates=2, mass=[1.0, 1.2], device=CPU)
    tt.set_apes(v)
    tt.set_ovlp(A_port)
    out = tt.run(psi0, 0.02, 4, rank_state=256, rank_pes=256, rank_ovlp=256,
                 nout=4)
    assert err(tn.tt_to_dense(out["cores_list"][-1]), psi.reshape(
        7, 7, 2)) <= 1e-8


# ------------------------------------------------------------ vibronic

def test_vibronic_mps_against_dense():
    """VibronicMPS against exact propagation of its dense MPO
    (tests/test_tdvp_autompo.py's two-mode model), and its MPO against
    the JAX package's."""
    nb = 4
    vm = tn.VibronicMPS(**VIB, nb=nb, chi_max=16, device=CPU)
    for Wj, Wt in zip(jtn.lvc_mpo(**VIB, nb=nb).Ws, vm.mpo.Ws):
        assert err(Wt, Wj) == 0.0
    times, pops = vm.run(el_state=1, dt=0.1, nt=20, nout=10)
    w, V = np.linalg.eigh(host(vm.mpo.to_dense()))
    psi0 = np.zeros(2 * nb * nb)
    psi0[np.ravel_multi_index((1, 0, 0), (2, nb, nb))] = 1.0
    for t, p in zip(host(times), host(pops)):
        psit = V @ (np.exp(-1j * w * t) * (V.conj().T @ psi0))
        pe = np.sum(np.abs(psit.reshape(2, nb, nb)) ** 2, axis=(1, 2))
        assert np.max(np.abs(p - pe)) < 1e-6
    E0, _ = vm.ground_state(sweeps=4)
    assert abs(E0 - w[0]) <= 1e-9


def test_pyrazine4_spectral_dynamics_matches_jax(jref):
    times, pops = Pyrazine4(device=CPU).spectral_dynamics(**PYR)
    jt, jp = jref["pyr"]
    assert err(times, jt) <= 1e-15
    assert err(pops, jp) <= RTOL
    assert err(pops.sum(1), np.ones(len(jt))) <= 1e-8

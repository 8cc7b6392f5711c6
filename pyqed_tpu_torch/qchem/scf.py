"""Self-consistent field: restricted and unrestricted Hartree-Fock with
DIIS.

PyTorch counterpart of ``pyqed_tpu/qchem/scf.py`` (reference:
pyqed/qchem/hf/rhf.py — ``RHF:22``, kernel ``hartree_fock:424``).

Integrals come from the host layer and live on the molecule's device; the
SCF loop — Fock build (contractions with the ERI tensor), DIIS
extrapolation, generalized eigenproblem via symmetric orthogonalization —
runs there, reading the host once per cycle for the energy.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(x, like):
    """``x`` as a float64 tensor on ``like``'s device."""
    return torch.as_tensor(x, dtype=torch.float64, device=like.device)


def ao2mo(eri, C1, C2=None, C3=None, C4=None):
    """(ij|kl) = sum C1[p,i] C2[q,j] (pq|rs) C3[r,k] C4[s,l], one index at
    a time (the five-operand einsum of the JAX package)."""
    C2 = C1 if C2 is None else C2
    C3 = C1 if C3 is None else C3
    C4 = C3 if C4 is None else C4
    n1, n2, n3, n4 = eri.shape
    t = (eri.reshape(-1, n4) @ C4).reshape(n1, n2, n3, -1)
    t = torch.einsum("pqrl, rk -> pqkl", t, C3)
    t = torch.einsum("pqkl, qj -> pjkl", t, C2)
    return torch.einsum("pjkl, pi -> ijkl", t, C1)


def jk_builder(eri):
    """(J, K) functions of a density matrix for one ERI tensor: the
    exchange layout (pr|qs) -> [pq, rs] is copied once, so every K build
    is one matrix-vector product like J's."""
    n = eri.shape[0]
    Jm = eri.reshape(n * n, n * n)
    Km = eri.permute(0, 2, 1, 3).reshape(n * n, n * n)

    def J(D):
        return (Jm @ D.reshape(-1)).reshape(n, n)

    def K(D):
        return (Km @ D.reshape(-1)).reshape(n, n)

    return J, K


def orthogonalizer(S):
    """Symmetric orthogonalization X = S^{-1/2}."""
    s, U = torch.linalg.eigh(S)
    return (U * (1.0 / torch.sqrt(s))) @ U.T


def diis_extrapolate(errs, vecs):
    """Pulay DIIS: solve the bordered B-matrix system and return the
    extrapolated vector ``sum_i c_i vecs[i]`` (or None if the system is
    singular). Shared by RHF/UHF Fock extrapolation and the CCSD
    amplitude extrapolation (qchem/cc.py). ``errs`` and ``vecs`` are
    tensors (or arrays) of one device; the (m, m) overlaps are read to
    the host in one transfer and the small system is solved there."""
    m = len(errs)
    E = torch.stack([torch.as_tensor(e).reshape(-1) for e in errs])
    G = (E.conj() @ E.T).real.cpu().numpy()
    B = np.zeros((m + 1, m + 1))
    B[-1, :] = B[:, -1] = -1.0
    B[-1, -1] = 0.0
    B[:m, :m] = G
    rhs = np.zeros(m + 1)
    rhs[-1] = -1.0
    try:
        c = np.linalg.solve(B, rhs)[:m]
    except np.linalg.LinAlgError:
        return None
    return sum(float(ci) * vi for ci, vi in zip(c, vecs))


class RHF:
    """(reference: pyqed/qchem/hf/rhf.py:22). Computes on ``mol.device``."""

    def __init__(self, mol, max_cycle=100, conv_tol=1e-10, diis_size=8,
                 extra_hcore=None):
        self.mol = mol
        self.max_cycle = max_cycle
        self.conv_tol = conv_tol
        self.diis_size = diis_size
        # extra_hcore: optional (nao, nao) AO one-electron perturbation
        # added to T+V — finite-field properties (dipole/polarizability
        # as energy derivatives) and one-electron embedding potentials
        self.extra_hcore = extra_hcore
        self.e_tot = None
        self.mo_coeff = None
        self.mo_energy = None
        self.converged = False

    @property
    def bfs(self):
        return self.mol.bfs

    @property
    def device(self):
        return self.mol.device

    def _hcore(self, T, V):
        hcore = T + V
        if self.extra_hcore is not None:
            hcore = hcore + _t(self.extra_hcore, hcore)
        return hcore

    def run(self):
        mol = self.mol
        S, T, V, eri = mol.intor()
        hcore = self._hcore(T, V)
        enuc = mol.energy_nuc()
        nocc = mol.nelec // 2
        if mol.nelec % 2 != 0:
            raise ValueError("RHF needs an even electron count")
        X = orthogonalizer(S)
        J, K = jk_builder(eri)

        def fock(D):
            return hcore + J(D) - 0.5 * K(D)

        def density(F):
            e, Cp = torch.linalg.eigh(X.T @ F @ X)
            C = X @ Cp
            Cocc = C[:, :nocc]
            return 2.0 * Cocc @ Cocc.T, C, e

        # core guess
        D, C, mo_e = density(hcore)
        E_old = 0.0
        diis_F, diis_err = [], []
        self.cycles = 0
        for it in range(self.max_cycle):
            F = fock(D)
            # DIIS error: FDS - SDF in orthogonal basis
            err = X.T @ (F @ D @ S - S @ D @ F) @ X
            diis_F.append(F)
            diis_err.append(err)
            if len(diis_F) > self.diis_size:
                diis_F.pop(0)
                diis_err.pop(0)
            if len(diis_F) > 1:
                mix = diis_extrapolate(diis_err, diis_F)
                if mix is not None:
                    F = mix
            D, C, mo_e = density(F)
            # E_elec = 1/2 Tr[D (hcore + F)]
            E = float(0.5 * torch.sum(D * (hcore + fock(D))))
            self.cycles = it + 1
            if abs(E - E_old) < self.conv_tol:
                self.converged = True
                break
            E_old = E

        self.e_tot = E + enuc
        self.mo_coeff = C
        self.mo_energy = mo_e
        self.nocc = nocc
        self.hcore = hcore
        self.eri = eri
        self.S = S
        self.e_elec = E
        self.dm = D
        return self

    kernel = run

    # ------------------------------------------------- MO-basis integrals
    def mo_ints(self):
        """(hcore_mo, eri_mo in chemists' notation)."""
        C = self.mo_coeff
        return C.T @ self.hcore @ C, ao2mo(self.eri, C)

    def dipole_integrals(self, origin=(0.0, 0.0, 0.0)):
        """AO dipole matrices (3, nao, nao) about ``origin`` on the device
        (reference: gbasis-backed path, pyqed/qchem/basis.py:10-15)."""
        from .basis import dipole_matrix
        mu = dipole_matrix(self.mol.bfs, origin)
        C = getattr(self.mol, "csph", None)
        if C is not None:
            mu = np.einsum("pi, kij, qj -> kpq", C, mu, C)
        return torch.as_tensor(mu, dtype=torch.float64,
                               device=self.mol.device)

    def dip_moment(self, origin=(0.0, 0.0, 0.0), unit="au"):
        """Molecular dipole vector mu = sum_A Z_A R_A - Tr[D r] as a NumPy
        (3,) array (reference calls through to pyscf ``mf.dip_moment()``,
        pyqed/qchem/hessian.py:232; here from the in-house AO dipole
        integrals). ``unit``: 'au' or 'debye'."""
        mu_ao = self.dipole_integrals(origin)
        el = -torch.einsum("kpq, qp -> k", mu_ao, self.dm).cpu().numpy()
        R = np.asarray(self.mol.atom_coords()) - np.asarray(origin)
        Z = np.asarray(self.mol.atom_charges(), dtype=float)
        mu = Z @ R + el
        if unit.lower().startswith("d"):
            mu = mu * 2.541746473
        return np.asarray(mu)

    def polarizability(self, eps=1e-3):
        """Static dipole polarizability alpha_ij = d mu_i / d E_j by
        finite-field SCF (the in-house finite-field route through
        ``extra_hcore``). Returns a NumPy (3, 3), symmetrized."""
        mu_ao = self.dipole_integrals()
        alpha = np.zeros((3, 3))
        for j in range(3):
            # H' = -mu.E => hcore += E_j * r_j (electron charge -1 is
            # inside mu_ao = -<r> convention handled in dip_moment)
            mus = []
            for s in (+1.0, -1.0):
                mf = RHF(self.mol, max_cycle=self.max_cycle,
                         conv_tol=self.conv_tol,
                         extra_hcore=s * eps * mu_ao[j]).run()
                mus.append(mf.dip_moment())
            alpha[:, j] = (mus[0] - mus[1]) / (2.0 * eps)
        return 0.5 * (alpha + alpha.T)

    def transition_dipoles(self, xy=None):
        """MO-basis dipole matrices (3, nmo, nmo) (feeds TDA/TDHF
        oscillator strengths)."""
        D = self.dipole_integrals()
        C = self.mo_coeff
        return torch.einsum("pi, kpq, qj -> kij", C, D, C)


class UHF:
    """Unrestricted Hartree-Fock (reference: pyqed/qchem/hf — UHF variant).

    Separate alpha/beta Fock matrices; same DIIS machinery as RHF.
    """

    def __init__(self, mol, max_cycle=150, conv_tol=1e-10, diis_size=8,
                 extra_hcore=None):
        self.mol = mol
        self.max_cycle = max_cycle
        self.conv_tol = conv_tol
        self.diis_size = diis_size
        #: optional (nao, nao) AO one-electron perturbation (finite
        #: fields etc.) — same contract as RHF's extra_hcore
        self.extra_hcore = extra_hcore
        self.converged = False

    @property
    def bfs(self):
        return self.mol.bfs

    def run(self):
        mol = self.mol
        S, T, V, eri = mol.intor()
        hcore = T + V
        if self.extra_hcore is not None:
            hcore = hcore + _t(self.extra_hcore, hcore)
        enuc = mol.energy_nuc()
        na = (mol.nelec + mol.spin) // 2
        nb = mol.nelec - na
        self.nocc = (na, nb)
        X = orthogonalizer(S)
        Jf, Kf = jk_builder(eri)

        def fock(Da, Db):
            J = Jf(Da + Db)
            return hcore + J - Kf(Da), hcore + J - Kf(Db)

        def density(F, nocc):
            e, Cp = torch.linalg.eigh(X.T @ F @ X)
            C = X @ Cp
            Cocc = C[:, :nocc]
            return Cocc @ Cocc.T, C, e

        Da, Ca, ea = density(hcore, na)
        Db, Cb, eb = density(hcore, nb)
        E_old = 0.0
        diis = []
        self.cycles = 0
        for it in range(self.max_cycle):
            Fa, Fb = fock(Da, Db)
            erra = X.T @ (Fa @ Da @ S - S @ Da @ Fa) @ X
            errb = X.T @ (Fb @ Db @ S - S @ Db @ Fb) @ X
            diis.append((torch.stack([Fa, Fb]),
                         torch.cat([erra.reshape(-1), errb.reshape(-1)])))
            if len(diis) > self.diis_size:
                diis.pop(0)
            if len(diis) > 1:
                mix = diis_extrapolate([d[1] for d in diis],
                                       [d[0] for d in diis])
                if mix is not None:
                    Fa, Fb = mix[0], mix[1]
            Da, Ca, ea = density(Fa, na)
            Db, Cb, eb = density(Fb, nb)
            Fa0, Fb0 = fock(Da, Db)
            E = float(0.5 * (torch.sum((Da + Db) * hcore)
                             + torch.sum(Da * Fa0) + torch.sum(Db * Fb0)))
            self.cycles = it + 1
            if abs(E - E_old) < self.conv_tol:
                self.converged = True
                break
            E_old = E

        self.e_tot = E + enuc
        self.mo_coeff = (Ca, Cb)
        self.mo_energy = (ea, eb)
        self.hcore = hcore
        self.eri = eri
        self.S = S
        self.dm = (Da, Db)
        return self

    kernel = run

    def spin_square(self):
        """<S^2> = S(S+1) + Nb - sum_ij |<a_i|b_j>|^2."""
        Ca, Cb = self.mo_coeff
        na, nb = self.nocc
        Sab = Ca[:, :na].T @ self.S @ Cb[:, :nb]
        sz = (na - nb) / 2
        return float(sz * (sz + 1) + nb - torch.sum(torch.abs(Sab) ** 2))


def get_hcore_mo(mf):
    """Core Hamiltonian in the MO basis; RHF-like -> (n, n), UHF-like ->
    (h_alpha, h_beta) (reference: pyqed/qchem/mol.py:48)."""
    C = mf.mo_coeff
    if isinstance(C, (tuple, list)):
        Ca, Cb = C
        return (Ca.T @ mf.hcore @ Ca, Cb.T @ mf.hcore @ Cb)
    return C.T @ mf.hcore @ C


def get_eri_mo(mf):
    """Two-electron integrals in the MO basis, chemists' notation
    (ij|kl); UHF-like -> (aa, ab, bb) blocks
    (reference: pyqed/qchem/mol.py:83)."""
    C = mf.mo_coeff
    if isinstance(C, (tuple, list)):
        Ca, Cb = C
        return (ao2mo(mf.eri, Ca), ao2mo(mf.eri, Ca, Ca, Cb, Cb),
                ao2mo(mf.eri, Cb))
    return ao2mo(mf.eri, C)


def scf_from_reference(mol, cls, *, mo_coeff, mo_energy, dm, nocc, e_tot,
                       converged=True, **kwargs):
    """A converged mean field of the port built from another run's
    state: ``cls`` (``RHF``, ``UHF``, ``RKS`` or ``UKS``) is constructed on
    the port's ``mol`` with ``kwargs``, its integrals are taken from
    ``mol.intor()``, and the orbitals, orbital energies, density, occupation
    and energy are given as NumPy arrays (pairs for the unrestricted
    classes). Post-HF parity tests start from the JAX package's own
    orbitals this way; nothing of JAX is imported here."""
    mf = cls(mol, **kwargs)
    S, T, V, eri = mol.intor()
    hcore = T + V
    if getattr(mf, "extra_hcore", None) is not None:
        hcore = hcore + _t(mf.extra_hcore, hcore)

    def dev(x):
        if isinstance(x, (tuple, list)):
            return tuple(dev(y) for y in x)
        return _t(np.array(x, dtype=float), S)

    mf.mo_coeff = dev(mo_coeff)
    mf.mo_energy = dev(mo_energy)
    mf.dm = dev(dm)
    mf.nocc = tuple(int(n) for n in nocc) if isinstance(
        nocc, (tuple, list)) else int(nocc)
    mf.e_tot = float(e_tot)
    mf.converged = bool(converged)
    mf.hcore, mf.eri, mf.S = hcore, eri, S
    return mf

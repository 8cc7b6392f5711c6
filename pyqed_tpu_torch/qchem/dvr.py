"""Real-space (DVR-grid) electronic structure — SCF/DFT/CI on sine-DVR
grids with erf-screened (soft) Coulomb interactions.

PyTorch counterpart of ``pyqed_tpu/qchem/dvr.py`` (reference:
pyqed/qchem/dvr/rhf.py:149 ``RHF1D``, :468 ``RHF2D``, rks.py:45 ``RKS``,
fci.py:312 ``fcisolver``, casci.py:28 ``CASCI``; model molecules
pyqed/models/ShinMetiu2e1d.py:765 ``AtomicChain``).

In a DVR basis the two-electron integrals are DIAGONAL in each
electron's index, (ij|kl) = v(|x_i − x_k|) δ_ij δ_kl, so the
Coulomb/exchange builds are one matrix-vector product and one Hadamard
product. The SCF step (Fock build + eigh + density) is a plain torch
function on the molecule's device, read back once per cycle for the
energy; FCI/CASCI reuse qchem/ci.py through ``mo_ints``; the 3D
one-electron solver applies its Hamiltonian matrix-free inside the
block Davidson of ``ops/davidson``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..grid.dvr import SineDVR
from .ci import CI, FCI, CISD


def soft_coulomb(r, R=1.0):
    """erf-screened Coulomb  erf(r/R)/r  with limit 2/(R sqrt(pi)) at r=0
    (reference: pyqed/qchem/dvr/rhf.py:36); a tensor on ``r``'s device
    (the CPU for NumPy or Python input)."""
    r = torch.as_tensor(r, dtype=torch.float64)
    small = r < 1e-12
    rsafe = torch.where(small, torch.ones_like(r), r)
    return torch.where(small, torch.full_like(r, 2.0 / (R * np.sqrt(np.pi))),
                       torch.special.erf(rsafe / R) / rsafe)


def get_veff(eri, dm):
    """Hartree + exchange potential in the DVR basis
    (reference: pyqed/qchem/dvr/rhf.py:121):
    J = diag(v @ diag(dm)),  K = v ⊙ dm,  vHF = J − K/2."""
    return torch.diag(eri @ torch.diagonal(dm)) - 0.5 * (eri * dm)


class MoleculeDVR:
    """Soft-Coulomb model molecule on a real-space grid: point charges
    Z_a at coordinates R_a in 1 or 2 dimensions (reference:
    pyqed/models/ShinMetiu2e1d.py:765 ``AtomicChain`` and
    pyqed/qchem/dvr/mol.py:489 ``Molecule``).

    atoms : list of (Z, coord) with coord scalar (1D) or array (2D).
    Rf    : screening length of the electron-nucleus/el-el interaction.
    device: where its mean fields compute (the card when None).
    """

    def __init__(self, atoms, charge=0, spin=0, Rf=1.5, Re=1.0,
                 device=None):
        self.device = resolve_device(device)
        self.atoms = [(int(Z), np.atleast_1d(np.asarray(R, dtype=float)))
                      for Z, R in atoms]
        self.charge = charge
        self.spin = spin
        self.Rf = Rf     # e-n screening (reference Rf = 1.5 A in a.u.)
        self.Re = Re     # e-e screening (reference mol.Re)
        self.nelec = self.nelectron = (
            sum(Z for Z, _ in self.atoms) - charge)
        self.ndim = len(self.atoms[0][1])

    def v_en(self, r):
        """Electron-nucleus potential at electron coordinate(s) r:
        −Σ_a Z_a erf(|r−R_a|/Rf)/|r−R_a| (reference:
        ShinMetiu2e1d.py:783); on ``r``'s device (NumPy r: the
        molecule's)."""
        if not isinstance(r, torch.Tensor):
            r = torch.as_tensor(np.asarray(r, dtype=float),
                                device=self.device)
        r = torch.atleast_2d(r.to(torch.float64))           # (npts, ndim)
        v = 0.0
        for Z, Ra in self.atoms:
            d = torch.linalg.vector_norm(
                r - torch.as_tensor(Ra, device=r.device)[None, :], dim=-1)
            v = v - Z * soft_coulomb(d, self.Rf)
        return v

    def energy_nuc(self):
        """Screened nuclear repulsion (reference: ShinMetiu2e1d.py:865)."""
        e = 0.0
        for a in range(len(self.atoms)):
            Za, Ra = self.atoms[a]
            for b in range(a):
                Zb, Rb = self.atoms[b]
                d = float(np.linalg.norm(Ra - Rb))
                if d > 0:
                    e += Za * Zb * float(soft_coulomb(d, self.Rf))
        return e


class RHF1D:
    """Restricted HF on a 1D sine-DVR grid, on the molecule's device
    (reference: pyqed/qchem/dvr/rhf.py:149)."""

    def __init__(self, mol: MoleculeDVR, domain=None, nx=None,
                 dvr_type="sine", max_cycle=100, tol=1e-9):
        self.mol = mol
        self.domain = domain
        self.nx = nx
        if dvr_type != "sine":
            raise ValueError(f"DVR {dvr_type} is not supported yet; "
                             "use 'sine'.")
        self.dvr_type = dvr_type
        self.max_cycle = max_cycle
        self.tol = tol
        self.x = None
        self.hcore = None
        self.eri = None
        self.mo_coeff = None
        self.mo_energy = None
        self.mo_occ = None
        self.e_tot = None
        self.converged = False
        self.nmo_ci = None     # MO truncation handed to CI (None = all)

    @property
    def device(self):
        return self.mol.device

    # ------------------------------------------------------------- grid
    def _points(self):
        dvr = SineDVR(*self.domain, self.nx, device=self.device)
        self.dvr = dvr
        self.x = np.asarray(dvr.x)
        return self.x.reshape(-1, 1)

    def get_hcore(self):
        pts = self._points()
        self.hcore = self.dvr.t() + torch.diag(self.mol.v_en(pts))
        return self.hcore

    def get_eri(self):
        """DVR two-electron matrix v_ij = sc(|x_i − x_j|, Re)
        (reference: pyqed/qchem/dvr/rhf.py:201)."""
        pts = torch.as_tensor(self.x.reshape(self.nx, -1)
                              if self.x.ndim == 1 else self.x,
                              device=self.device)
        d = torch.linalg.vector_norm(pts[:, None, :] - pts[None, :, :],
                                     dim=-1)
        self.eri = soft_coulomb(d, self.mol.Re)
        return self.eri

    # -------------------------------------------------------------- scf
    def _scf(self, step, hcore, nocc):
        """Iterate ``step`` from the hcore guess (reference: rhf.py:336)
        until the total energy moves less than ``tol``."""
        enuc = self.mol.energy_nuc()
        _, C0 = torch.linalg.eigh(hcore)
        dm = 2.0 * C0[:, :nocc] @ C0[:, :nocc].T
        old = np.inf
        for _ in range(self.max_cycle):
            dm, e_elec, mo_e, C = step(dm)
            e_tot = float(e_elec) + enuc
            if abs(e_tot - old) < self.tol:
                self.converged = True
                break
            old = e_tot
        self.mo_energy = mo_e
        self.mo_coeff = C
        self.dm = dm
        self.e_tot = e_tot
        return e_tot

    def run(self):
        hcore = self.get_hcore()
        eri = self.get_eri()
        n = hcore.shape[0]
        nocc = self.mol.nelec // 2
        if self.mol.nelec % 2:
            raise ValueError("RHF1D needs an even electron count")
        mo_occ = torch.zeros(n, dtype=torch.float64, device=self.device)
        mo_occ[:nocc] = 2.0
        self.mo_occ = mo_occ

        def scf_step(dm):
            F = hcore + get_veff(eri, dm)
            e, C = torch.linalg.eigh(F)
            Cocc = C[:, :nocc]
            dm_new = 2.0 * Cocc @ Cocc.T
            e_elec = (torch.sum(hcore * dm_new)
                      + 0.5 * torch.sum(get_veff(eri, dm_new) * dm_new))
            return dm_new, e_elec, e, C

        return self._scf(scf_step, hcore, nocc)

    kernel = run

    def make_rdm1(self):
        return self.dm

    # ------------------------------------------------------- CI plumbing
    def mo_ints(self):
        """(hcore_mo, chemists' (pq|rs)) in the nmo_ci lowest MOs —
        transformed from the diagonal DVR form
        (pq|rs) = Σ_ij C_ip C_iq v_ij C_jr C_js."""
        nmo = self.nmo_ci or min(self.hcore.shape[0], 8)
        C = self.mo_coeff[:, :nmo]
        h = C.T @ self.hcore @ C
        P = torch.einsum("ip, iq -> ipq", C, C)      # (ngrid, nmo, nmo)
        M = torch.einsum("ipq, ij, jrs -> pqrs", P, self.eri, P)
        return h, M

    def FCI(self):
        return FCI(self)

    def CISD(self):
        return CISD(self)

    def CASCI(self, ncas, nelecas=None):
        return CASCIDVR(self, ncas, nelecas)


class RHF2D(RHF1D):
    """Restricted HF on a 2D direct-product sine-DVR grid
    (reference: pyqed/qchem/dvr/rhf.py:468)."""

    def __init__(self, mol, domains=None, nxs=None, **kw):
        super().__init__(mol, domain=None, nx=None, **kw)
        self.domains = domains
        self.nxs = nxs

    def _points(self):
        dvrs = [SineDVR(*dom, n, device=self.device)
                for dom, n in zip(self.domains, self.nxs)]
        self.dvrs = dvrs
        X, Y = np.meshgrid(np.asarray(dvrs[0].x), np.asarray(dvrs[1].x),
                           indexing="ij")
        self.x = np.stack([X.ravel(), Y.ravel()], axis=-1)
        self.nx = self.x.shape[0]
        return self.x

    def get_hcore(self):
        pts = self._points()
        T1, T2 = (d.t() for d in self.dvrs)
        eye = lambda m: torch.eye(m.shape[0], dtype=m.dtype,  # noqa: E731
                                  device=m.device)
        T = torch.kron(T1, eye(T2)) + torch.kron(eye(T1), T2)
        self.hcore = T + torch.diag(self.mol.v_en(pts))
        return self.hcore


class RKS1D(RHF1D):
    """Restricted Kohn-Sham (LDA, Slater exchange) on the 1D grid
    (reference: pyqed/qchem/dvr/rks.py:45).

    In DVR the density at grid point i is n_i = dm_ii / dx, and the LDA
    exchange potential enters as a diagonal matrix; v_x = −c_x (3/π
    n)^{1/3} with c_x = ``xalpha``."""

    def __init__(self, mol, domain=None, nx=None, xalpha=1.0, **kw):
        super().__init__(mol, domain=domain, nx=nx, **kw)
        self.xalpha = xalpha

    def run(self):
        hcore = self.get_hcore()
        eri = self.get_eri()
        nocc = self.mol.nelec // 2
        dx = float(self.x[1] - self.x[0])
        alpha = self.xalpha

        def xc(dm):
            dens = torch.diagonal(dm) / dx
            # Slater LDA exchange (3D form, reference convention)
            vx = -alpha * (3.0 / np.pi * dens) ** (1.0 / 3.0)
            return vx, 0.75 * torch.sum(vx * dens) * dx

        def scf_step(dm):
            vx, _ = xc(dm)
            F = hcore + torch.diag(eri @ torch.diagonal(dm)) + torch.diag(vx)
            e, C = torch.linalg.eigh(F)
            Cocc = C[:, :nocc]
            dm_new = 2.0 * Cocc @ Cocc.T
            _, ex_new = xc(dm_new)
            J_new = eri @ torch.diagonal(dm_new)
            e_elec = (torch.sum(hcore * dm_new)
                      + 0.5 * torch.sum(J_new * torch.diagonal(dm_new))
                      + ex_new)
            return dm_new, e_elec, e, C

        return self._scf(scf_step, hcore, nocc)


class CASCIDVR(CI):
    """CASCI on DVR mean-field MOs: FCI inside an (ncas, nelecas) active
    window on top of a frozen doubly-occupied core
    (reference: pyqed/qchem/dvr/casci.py:28). The core folding is a pair
    of contractions on the device; the determinant Hamiltonian comes
    from the Slater-Condon rules of qchem/ci.py on the host, and its
    ``eigh`` runs on the device."""

    def __init__(self, mf, ncas, nelecas=None):
        super().__init__(mf, max_exc=None)
        self.ncas = ncas
        self.nelecas = nelecas if nelecas is not None else mf.mol.nelec
        self.ncore = (mf.mol.nelec - self.nelecas) // 2

    def run(self, nroots=1):
        from .ci import spinorb_ints, enumerate_dets, build_hamiltonian, _host
        mf = self.mf
        ncore, ncas = self.ncore, self.ncas
        saved = mf.nmo_ci
        mf.nmo_ci = ncore + ncas
        hmo, eri = mf.mo_ints()
        mf.nmo_ci = saved
        c, a = slice(0, ncore), slice(ncore, ncore + ncas)
        # fold the frozen core into an effective 1-body term + constant
        e_core = float(2.0 * torch.sum(torch.diagonal(hmo)[c])
                       + 2.0 * torch.einsum("iijj ->", eri[c, c, c, c])
                       - torch.einsum("ijji ->", eri[c, c, c, c]))
        heff = (hmo[a, a] + 2.0 * torch.einsum("pqii -> pq", eri[a, a, c, c])
                - torch.einsum("piiq -> pq", eri[a, c, c, a]))
        h, g = (_host(x) for x in spinorb_ints(heff, eri[a, a, a, a]))
        dets = enumerate_dets(2 * ncas, self.nelecas)
        H = build_hamiltonian(dets, h, g)
        w, v = torch.linalg.eigh(torch.as_tensor(H, device=mf.device))
        self.e_tot = (w[:nroots].cpu().numpy() + e_core
                      + mf.mol.energy_nuc())
        self.civec = v[:, :nroots]
        self.dets = dets
        self.ns = 2 * ncas
        return self.e_tot


def exact_2e(mf, nroots=1):
    """Exact two-electron (singlet) energies by direct diagonalization of
    h⊗I + I⊗h + diag(v(x1−x2)) on the product grid, on the mean field's
    device — the brute-force oracle for 2-electron DVR molecules
    (reference analogue: the 'exact' path of ShinMetiu2e1d.single_point).
    Returns NumPy."""
    h = mf.hcore if mf.hcore is not None else mf.get_hcore()
    v = mf.eri if mf.eri is not None else mf.get_eri()
    n = h.shape[0]
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    H2 = (torch.kron(h, eye) + torch.kron(eye, h)
          + torch.diag(v.reshape(-1)))
    w, U = torch.linalg.eigh(H2)
    # the symmetric (singlet spatial) sector: psi = psi^T within
    # numpy.allclose's default tolerance (atol 1e-6, rtol 1e-5)
    psi = U.T.reshape(-1, n, n)
    ok = torch.all(torch.abs(psi - psi.transpose(1, 2))
                   <= 1e-6 + 1e-5 * torch.abs(psi.transpose(1, 2)),
                   dim=(1, 2))
    sym = w[ok][:nroots]
    return sym.cpu().numpy() + mf.mol.energy_nuc()


class ElectronDVR3D:
    """One-electron 3D real-space molecular Schrödinger solver on a
    direct-product sinc-DVR grid (reference: pyqed/qchem/sg.py:40
    ``DVRn`` — a scipy-sparse 3D Hamiltonian solved by Lanczos). Here the
    Hamiltonian is never materialized: ``grid.dvr.DVRN.apply_H`` applies
    the per-dimension kinetic contractions and the (soft-)Coulomb
    attraction diagonally to a block of columns, and the eigenpairs come
    from the matrix-free block Davidson (ops/davidson.py), all on
    ``device`` (the card when None).

    atoms: [(Z, (x, y, z)), ...] in bohr; softening R avoids the Coulomb
    cusp on the uniform grid (R -> 0 recovers bare Coulomb).
    """

    def __init__(self, atoms, domains, nxs, soft=0.2, device=None):
        from ..grid.dvr import SincDVR, DVRN
        dev = resolve_device(device)
        self.device = dev
        self.atoms = atoms
        # x_n = x0 - L/2 + n L/npts spans [x0-L/2, x0+L/2-dx]; shifting
        # x0 by dx/2 centers the grid on the domain midpoint so symmetric
        # molecules see a symmetric grid
        self.dvrs = [SincDVR(domains[d][1] - domains[d][0], nxs[d],
                             x0=0.5 * (domains[d][0] + domains[d][1])
                             + 0.5 * (domains[d][1] - domains[d][0])
                             / nxs[d],
                             mass=1.0, device=dev)
                     for d in range(3)]
        self.grid = DVRN(self.dvrs, device=dev)
        self.soft = soft
        X, Y, Z = (torch.as_tensor(g, device=dev) for g in np.meshgrid(
            *self.grid.x, indexing="ij"))
        V = torch.zeros_like(X)
        for (Zq, pos) in atoms:
            r2 = ((X - pos[0]) ** 2 + (Y - pos[1]) ** 2
                  + (Z - pos[2]) ** 2)
            V = V - Zq / torch.sqrt(r2 + soft ** 2)
        self.Vg = V

    def energy_nuc(self):
        e = 0.0
        for i, (Zi, ri) in enumerate(self.atoms):
            for j, (Zj, rj) in enumerate(self.atoms[:i]):
                e += Zi * Zj / np.linalg.norm(np.asarray(ri)
                                              - np.asarray(rj))
        return e

    def apply_H(self, psi_flat):
        """Matvec on (n,) or blocked (n, k) vectors."""
        psi = psi_flat.reshape(list(self.grid.nx) + list(psi_flat.shape[1:]))
        return self.grid.apply_H(psi, self.Vg).reshape(psi_flat.shape)

    def run(self, neig=1, tol=1e-8, max_iterations=120):
        """Lowest electronic eigenpairs, matrix-free Davidson."""
        from ..ops.davidson import block_davidson
        diag = self.Vg.reshape(-1)
        for d in range(3):
            t = torch.diagonal(self.dvrs[d].t())
            shape = [1, 1, 1]
            shape[d] = -1
            diag = diag + torch.broadcast_to(
                t.reshape(shape), self.Vg.shape).reshape(-1)
        E, U = block_davidson(self.apply_H, neig=neig, diag=diag,
                              tol=tol, max_iterations=max_iterations)
        self.mo_energy, self.mo_coeff = E, U
        return E

    def total_energy(self, nelec=1, neig=None):
        """Independent-electron total energy (Aufbau, closed shell)."""
        need = max(1, (nelec + 1) // 2)
        if not hasattr(self, "mo_energy") or len(self.mo_energy) < need:
            self.run(neig=need)
        occ = self.mo_energy[:need].cpu().numpy()
        fill = np.minimum(2, nelec - 2 * np.arange(len(occ)))
        return float(np.sum(occ * fill[:len(occ)]) + self.energy_nuc())


DVRn = ElectronDVR3D             # reference drop-in name (pyqed/qchem/sg.py:40)

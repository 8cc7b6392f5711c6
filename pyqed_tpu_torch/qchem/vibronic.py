"""Linear vibronic coupling (LVC) models from ab initio calculations.

PyTorch counterpart of ``pyqed_tpu/qchem/vibronic.py`` (reference:
pyqed/qchem/vibronic.py:22 ``LVC_DFT`` — a skeleton whose __init__
stores ``mol`` and whose body is pyscf script scraps; made real with the
in-house RHF + TDA stack). Every SCF, TDA and CIS overlap runs on
``device`` (the card when None); the normal-mode analysis and the model
parameters are small NumPy arrays.

Pipeline (all finite differences along DIMENSIONLESS normal
coordinates Q_i, cartesian displacement dR = M^{-1/2} u_i Q / sqrt(w)):

  1. mass-weighted Hessian -> normal modes (w_i, u_i);
  2. vertical TDA excitations at the reference geometry -> E_n;
  3. intrastate couplings  kappa_{n,i} = dU_n/dQ_i   (U_n = E_SCF + e_n)
  4. interstate couplings  lambda_{nm,i} = (E_m - E_n) <n|d/dQ_i|m>,
     the FD nonadiabatic coupling from CIS-vector overlaps in the
     leading-determinant approximation
     O_nm = sum_{ia,jb} X_n,ia X'_m,jb S^occ_ij S^virt_ab.

The result is a :class:`pyqed_tpu_torch.models.LVC` ready for quantum
dynamics.
"""
from __future__ import annotations

import numpy as np
import torch

from .mol import Molecule
from .hessian import Hessian
from .tdscf import TDA
from .ci_overlap import cross_overlap_ao
from ..units import atomic_mass
from ..models.lvc import LVC, Mode

__all__ = ["LVCBuilder", "LVC_DFT"]


class LVCBuilder:
    """Build an LVC model for the lowest ``nstates`` electronic states
    (ground + nstates-1 TDA excitations) of ``atoms`` (bohr), every
    electronic-structure step on ``device`` (the card when None).

    Use an OPTIMIZED geometry: the ground-state linear term kappa_0 is
    computed and included, but the harmonic expansion is only faithful
    near a stationary point.
    """

    def __init__(self, atoms, basis="sto-3g", nstates=2, dq=0.05,
                 truncate=8, singlet=True, hessian_step=5e-3, device=None):
        self.atoms = [(s, np.asarray(x, dtype=float)) for s, x in atoms]
        self.basis = basis
        self.nstates = nstates
        self.dq = dq
        self.truncate = truncate
        self.singlet = singlet
        self.hessian_step = hessian_step
        self.device = device
        self.natm = len(self.atoms)
        self.lvc = None

    # ------------------------------------------------------------ ab initio
    def _solve(self, coords_flat):
        """(E_scf, e_exc (nroots,), X (nov, nroots) tensor, mf) at a
        geometry."""
        coords = np.asarray(coords_flat).reshape(self.natm, 3)
        mol = Molecule([(s, c) for (s, _), c in zip(self.atoms, coords)],
                       basis=self.basis, device=self.device)
        mf = mol.RHF().run()
        if not mf.converged:
            raise RuntimeError("SCF not converged in LVCBuilder")
        td = TDA(mf, singlet=self.singlet)
        e = td.run(nroots=self.nstates - 1)
        return float(mf.e_tot), np.asarray(e), td.xy, mf

    @staticmethod
    def _cis_overlap(mf1, X1, mf2, X2):
        """Leading-determinant CIS cross overlaps O_nm (n1, n2), NumPy."""
        C1, C2 = mf1.mo_coeff, mf2.mo_coeff
        S12 = torch.as_tensor(cross_overlap_ao(mf1.mol.bfs, mf2.mol.bfs),
                              device=C1.device)
        Smo = C1.T @ S12 @ C2
        nocc = mf1.nocc
        nvir = X1.shape[0] // nocc
        x1 = X1.reshape(nocc, nvir, -1)
        x2 = X2.reshape(nocc, nvir, -1)
        return torch.einsum("ian, ij, ab, jbm -> nm", x1, Smo[:nocc, :nocc],
                            Smo[nocc:, nocc:][:nvir, :nvir], x2).cpu().numpy()

    def _mass_scale(self):
        masses = np.repeat([atomic_mass[s.upper()] * 1822.888486
                            for s, _ in self.atoms], 3)
        return 1.0 / np.sqrt(masses)

    # ---------------------------------------------------------------- build
    def run(self):
        x0 = np.concatenate([x for _, x in self.atoms])

        # 1. normal modes (mass-weighted Hessian of the SCF energy)
        hes = Hessian(self.atoms, basis=self.basis, step=self.hessian_step,
                      device=self.device)
        hes.run()
        Minv = self._mass_scale()
        Hmw = hes.hessian * np.outer(Minv, Minv)
        w2, U = np.linalg.eigh(Hmw)
        nzero = 5 if self.natm == 2 else 6
        vib = np.argsort(np.abs(w2))[nzero:]
        vib = vib[np.argsort(w2[vib])]
        omegas = np.sqrt(np.abs(w2[vib]))            # a.u.
        modes_cart = U[:, vib]                       # mass-weighted vecs

        # 2. reference point
        E0, e0, X0, mf0 = self._solve(x0)
        nst = self.nstates

        # 3./4. FD couplings per mode
        modes = []
        self.kappa = np.zeros((len(omegas), nst))
        self.lam = np.zeros((len(omegas), nst, nst))
        for i, (w, u) in enumerate(zip(omegas, modes_cart.T)):
            dx = Minv * u / np.sqrt(w)               # dR per unit Q
            Ep, ep, Xp, mfp = self._solve(x0 + self.dq * dx)
            Em, em, Xm, mfm = self._solve(x0 - self.dq * dx)
            Up = np.concatenate([[Ep], Ep + ep])
            Um = np.concatenate([[Em], Em + em])
            kappa = (Up - Um) / (2 * self.dq)
            couplings = [((n, n), float(kappa[n])) for n in range(nst)
                         if abs(kappa[n]) > 1e-12]
            # interstate: FD NAC from CIS overlaps, phase-fixed so the
            # diagonal overlap is positive
            Op = self._cis_overlap(mf0, X0, mfp, Xp)
            Om = self._cis_overlap(mf0, X0, mfm, Xm)
            for O in (Op, Om):
                O *= np.sign(np.diag(O))[None, :]
            tau = (Op - Om) / (2 * self.dq)          # <n|d/dQ|m>
            for n in range(1, nst):
                for m in range(n + 1, nst):
                    lam = float((e0[m - 1] - e0[n - 1])
                                * tau[n - 1, m - 1])
                    self.lam[i, n, m] = self.lam[i, m, n] = lam
                    if abs(lam) > 1e-12:
                        couplings.append(((n, m), lam))
            self.kappa[i] = kappa
            modes.append(Mode(float(w), couplings,
                              truncate=self.truncate))

        E_fc = np.concatenate([[0.0], e0])           # vertical energies
        self.e_scf0 = E0
        self.omegas = omegas
        self.modes_cart = modes_cart
        self.lvc = LVC(E_fc, modes)
        return self.lvc

    # --------------------------------------------------------- validation
    def ab_initio_apes(self, imode, Q):
        """Directly computed adiabatic energies (relative to the
        reference ground energy) at normal-coordinate displacement Q of
        mode ``imode`` — for validating the LVC expansion."""
        x0 = np.concatenate([x for _, x in self.atoms])
        dx = self._mass_scale() * self.modes_cart[:, imode] \
            / np.sqrt(self.omegas[imode])
        E, e, _, _ = self._solve(x0 + Q * dx)
        return np.concatenate([[E], E + e]) - self.e_scf0


LVC_DFT = LVCBuilder    # reference drop-in name (qchem/vibronic.py:22)

"""G0W0 quasiparticle corrections on the RPA (Casida) screened interaction.

PyTorch counterpart of ``pyqed_tpu/negf/gw.py`` (reference:
pyqed/gw/G0W0.py:170 — G0W0 on RPA/Casida).

Sum-over-states correlation self-energy from the RPA excitation vectors:

  Sigma_c^p(w) = sum_I [ sum_i |w^I_{pi}|^2 / (w - e_i + Omega_I)
                       + sum_a |w^I_{pa}|^2 / (w - e_a - Omega_I) ]

with w^I_{pq} = sum_{ia} (pq|ia) (X+Y)^I_{ia}; HF reference, so the
quasiparticle energy is E_p = e_p + Sigma_c(e_p) (linearized, eta -> 0+).
The RPA problem reuses the port's ``qchem.tdscf`` A/B matrices; the
eigensolves, the contractions and the self-energy of every requested
orbital at once run on the mean field's device. Results are NumPy, as
in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..qchem.tdscf import tda_matrix, b_matrix


def _rpa(mf):
    """(Omega, X+Y) tensors on the mean field's device."""
    A = tda_matrix(mf, singlet=True)
    B = b_matrix(mf, singlet=True)
    w, U = torch.linalg.eigh(A - B)
    w = torch.clamp(w, min=1e-14)
    sq = (U * torch.sqrt(w)) @ U.T
    w2, Z = torch.linalg.eigh(sq @ (A + B) @ sq)
    Omega = torch.sqrt(torch.clamp(w2, min=1e-14))
    # X+Y = (A-B)^{1/2} Z / sqrt(Omega)
    return Omega, sq @ Z / torch.sqrt(Omega)[None, :]


def rpa_modes(mf):
    """RPA excitation energies Omega_I and (X+Y)^I vectors (Casida
    normalization), NumPy."""
    Omega, XpY = _rpa(mf)
    return Omega.cpu().numpy(), XpY.cpu().numpy()


def _blocks(mf):
    hmo, eri_mo = mf.mo_ints()
    nocc = mf.nocc
    return eri_mo, mf.mo_energy, nocc, hmo.shape[0] - nocc


def _m_rpa(eri, nocc, XpY):
    """M_{pq,I} = Σ_ia (pq|ia) (X+Y)^I_{ia} (one product on the device)."""
    nmo = eri.shape[0]
    nov = nocc * (nmo - nocc)
    return (eri[:, :, :nocc, nocc:].reshape(nmo * nmo, nov)
            @ XpY).reshape(nmo, nmo, -1)


def _g0w0(mf, eta, orbitals, modes=None, blocks=None):
    eri, e, nocc, nvir = blocks if blocks is not None else _blocks(mf)
    nmo = nocc + nvir
    Omega, XpY = modes if modes is not None else _rpa(mf)
    if orbitals is None:
        orbitals = list(range(nmo))
    orb = torch.as_tensor(orbitals, dtype=torch.long, device=e.device)
    W = _m_rpa(eri, nocc, XpY)[orb]                  # (P, nmo, I)
    w0 = e[orb][:, None, None]
    den_occ = w0 - e[None, :nocc, None] + Omega[None, None, :]
    den_vir = w0 - e[None, nocc:, None] - Omega[None, None, :]
    sc = (torch.sum(W[:, :nocc] ** 2 * den_occ / (den_occ ** 2 + eta ** 2),
                    dim=(1, 2))
          + torch.sum(W[:, nocc:] ** 2 * den_vir / (den_vir ** 2 + eta ** 2),
                      dim=(1, 2)))
    e_h = e.cpu().numpy()
    sig = np.zeros(nmo)
    sig[orbitals] = sc.cpu().numpy()
    e_qp = e_h.astype(float).copy()
    e_qp[orbitals] = e_h[orbitals] + sig[orbitals]
    return e_qp, e_h, sig


def g0w0(mf, eta=1e-3, orbitals=None):
    """Quasiparticle energies for the requested orbitals (default: all).

    Returns (e_qp, e_hf, sigma_c) NumPy. HF starting point: E_p = e_p +
    Re Sigma_c(e_p).
    """
    return _g0w0(mf, eta, orbitals)


class G0W0:
    """(reference: pyqed/gw/G0W0.py:170)."""

    def __init__(self, mf, eta=1e-3):
        self.mf = mf
        self.eta = eta
        self.e_qp = None

    def run(self, orbitals=None):
        self.e_qp, self.e_hf, self.sigma_c = g0w0(self.mf, self.eta,
                                                  orbitals)
        return self.e_qp

    kernel = run

    @property
    def ip(self):
        """Ionization potential = -E_qp(HOMO)."""
        return -self.e_qp[self.mf.nocc - 1]

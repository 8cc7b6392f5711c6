"""Coupled-perturbed Hartree-Fock (CPHF) linear response.

Analytic static and frequency-dependent dipole polarizabilities from
the TDHF/RPA (A, B) matrices already built in :mod:`~.tdscf`:

    alpha_ij(w) = 4 sum_n  [v_n^T (A-B)^{1/2} mu_i] [v_n^T (A-B)^{1/2} mu_j]
                           / (w_n^2 - w^2)

with M = (A-B)^{1/2} (A+B) (A-B)^{1/2} = V diag(w_n^2) V^T (real
orbitals, closed shell). At w = 0 this reduces to the textbook CPHF
result alpha = 4 mu^T (A+B)^{-1} mu.

The reference exposes polarizabilities only through the pyscf properties
module it wraps (no in-tree implementation); the finite-field route
(``RHF.polarizability``, qchem/scf.py) is the in-house cross-check.
PyTorch counterpart of ``pyqed_tpu/qchem/cphf.py``: the eigensolves run on
the mean field's device; the results are NumPy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["polarizability_cphf", "polarizability_dynamic"]


def _response_setup(mf):
    from .tdscf import tda_matrix, b_matrix
    A = tda_matrix(mf, singlet=True)
    B = b_matrix(mf, singlet=True)
    w, U = torch.linalg.eigh(A - B)
    if bool(torch.any(w < -1e-10)):
        raise np.linalg.LinAlgError(
            "(A-B) not positive definite (SCF instability)")
    sq = (U * torch.sqrt(torch.clamp(w, min=0.0))) @ U.T  # (A-B)^{1/2}
    M = sq @ (A + B) @ sq
    w2, V = torch.linalg.eigh(M)
    # occ-virt MO dipole blocks -> (3, nocc*nvir)
    mu = mf.transition_dipoles()                         # (3, nmo, nmo)
    nocc = mf.nocc
    mu_ov = mu[:, :nocc, nocc:].reshape(3, -1)
    d = mu_ov @ sq @ V                                   # (3, n) couplings
    return (torch.clamp(w2, min=0.0).cpu().numpy(), d.cpu().numpy())


def polarizability_cphf(mf):
    """Static CPHF dipole polarizability (3, 3), analytic (one eigh of
    the RPA Hessian; no finite fields)."""
    w2, d = _response_setup(mf)
    return 4.0 * np.einsum("xn, n, yn -> xy", d, 1.0 / w2, d)


def polarizability_dynamic(mf, omegas):
    """Frequency-dependent alpha(w) (nw, 3, 3); poles at the TDHF
    excitation energies w_n = sqrt(eig M)."""
    w2, d = _response_setup(mf)
    omegas = np.atleast_1d(np.asarray(omegas, dtype=float))
    denom = w2[None, :] - omegas[:, None] ** 2           # (nw, n)
    return 4.0 * np.einsum("xn, wn, yn -> wxy", d, 1.0 / denom, d)

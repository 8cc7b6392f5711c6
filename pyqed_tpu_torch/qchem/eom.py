"""EOM-CCSD excitation energies via the exact determinant-space
similarity transform.

Beyond the reference (no EOM / coupled cluster anywhere in its tree).
PyTorch-package counterpart of ``pyqed_tpu/qchem/eom.py``: like the JAX
package's, it works on the host in NumPy, in the full determinant space,
so it is for small molecules only.
Instead of the ~50-term diagrammatic sigma equations, this exploits the
package's determinant machinery: build H and the cluster operator
T = T1 + T2 as matrices in the full determinant space, form

    Hbar = e^{-T} H e^{T}

with the NILPOTENT exponential (the series terminates exactly — T only
raises the excitation level), and diagonalize the singles+doubles block.
Because the CC amplitude equations say exactly <Phi_SD| Hbar |Phi_0> = 0,
the reference root decouples and the remaining eigenvalues of the S+D
block are the EOM-EE-CCSD energies — algebraically identical to the
diagrammatic formulation, exact to machine precision at the sizes this
package targets (determinant spaces up to a few thousand).

Internal consistency pin: <Phi_0| Hbar |Phi_0> must equal E_CCSD, and the
first column of Hbar in the S+D rows must vanish (the converged CCSD
residuals) — both asserted in the tests.
"""
from __future__ import annotations

import numpy as np

import warnings

from .ci import (spinorb_ints, enumerate_dets, build_hamiltonian, _phase,
                 _host)

__all__ = ["EOMCCSD"]


def _cluster_matrix(dets, index, t1, t2, no):
    """T = T1 + T2 as a dense matrix in the determinant basis:
    T[J, I] = <D_J| T |D_I> (strictly excitation-raising w.r.t. the
    Aufbau reference, hence nilpotent)."""
    nd = len(dets)
    T = np.zeros((nd, nd))
    occ = range(no)
    for I, det in enumerate(dets):
        dset = set(det)
        present = [i for i in occ if i in dset]
        absent_v = [a for a in range(no, t1.shape[1] + no)
                    if a not in dset]
        # singles
        for i in present:
            for a in absent_v:
                new = tuple(sorted(dset - {i} | {a}))
                J = index.get(new)
                if J is not None:
                    T[J, I] += _phase(det, [i], [a]) * t1[i, a - no]
        # doubles (ordered pairs; antisymmetry of t2 carries the 1/4)
        for ii in range(len(present)):
            for jj in range(ii + 1, len(present)):
                i, j = present[ii], present[jj]
                for aa in range(len(absent_v)):
                    for bb in range(aa + 1, len(absent_v)):
                        a, b = absent_v[aa], absent_v[bb]
                        new = tuple(sorted(dset - {i, j} | {a, b}))
                        J = index.get(new)
                        if J is not None:
                            T[J, I] += (_phase(det, [i, j], [a, b])
                                        * t2[i, j, a - no, b - no])
    return T


def _expm_nilpotent_cols(T, cols):
    """Columns ``cols`` of e^T for nilpotent T (series terminates
    exactly); cost nd^2 |cols| per term instead of nd^3."""
    nd = T.shape[0]
    X = np.eye(nd)[:, cols]
    term = X.copy()
    k = 1
    while True:
        term = (T @ term) / k
        if not np.any(term):
            break
        X = X + term
        k += 1
        assert k < 64, "T not nilpotent?"
    return X


class EOMCCSD:
    """EOM-EE-CCSD excitation energies from a converged ``qchem.cc.CCSD``.

    ``run(nroots)`` returns the lowest excitation energies (Hartree).
    Attributes: .e_ee (all S+D-block excitation energies, sorted),
    .e_cc_check (<0|Hbar|0>, must equal the CCSD total energy),
    .residual_norm (max |<SD|Hbar|0>|, ~0 at convergence).
    """

    def __init__(self, cc):
        assert cc.t2 is not None, "run CCSD first"
        self.cc = cc

    def run(self, nroots: int = 5):
        cc = self.cc
        mf = cc.mf
        hmo, eri_mo = mf.mo_ints()
        h, g = (_host(x) for x in spinorb_ints(hmo, eri_mo))
        nelec = mf.mol.nelec
        ns = 2 * hmo.shape[0]
        no = nelec
        ref = tuple(range(nelec))     # interleaved aufbau (== ci.py)
        dets = enumerate_dets(ns, nelec)
        index = {d: i for i, d in enumerate(dets)}
        nd = len(dets)

        H = build_hamiltonian(dets, h, g)
        H += mf.mol.energy_nuc() * np.eye(nd)

        t1 = _host(cc.t1)
        t2 = _host(cc.t2)
        T = _cluster_matrix(dets, index, t1, t2, no)

        # S+D projection (excitation level <= 2 from the reference);
        # only the P-block of Hbar is needed, so build just those
        # columns of e^T / rows of e^-T (nd^2 |P| instead of nd^3)
        ref_set = set(ref)
        P = [i for i, d in enumerate(dets)
             if len(ref_set - set(d)) <= 2]
        i0 = P.index(index[tuple(sorted(ref))])
        eT_cols = _expm_nilpotent_cols(T, P)              # (nd, |P|)
        emT_rows = _expm_nilpotent_cols(-T.T, P).T        # (|P|, nd)
        Hpp = emT_rows @ H @ eT_cols

        self.e_cc_check = float(Hpp[i0, i0])
        col = np.delete(Hpp[:, i0], i0)
        self.residual_norm = float(np.max(np.abs(col)))
        if not getattr(cc, "converged", True) or self.residual_norm > 1e-6:
            # <SD|Hbar|0> = 0 is what decouples the reference root; an
            # unconverged CCSD breaks the block split silently otherwise
            warnings.warn(
                "EOM-CCSD on unconverged CCSD amplitudes (max residual "
                f"coupling {self.residual_norm:.2e}); excitation energies "
                "are perturbed by the residual reference coupling.")

        # reference root decouples; diagonalize the S+D excited block
        keep = [k for k in range(len(P)) if k != i0]
        w = np.linalg.eigvals(Hpp[np.ix_(keep, keep)])
        if np.max(np.abs(w.imag)) > 1e-8 * max(np.max(np.abs(w)), 1.0):
            warnings.warn(
                "complex EOM-CCSD eigenvalue pair (non-Hermitian Hbar "
                "root coalescence); real parts reported "
                f"(max |Im| = {np.max(np.abs(w.imag)):.2e}).")
        ee = np.sort(np.real(w)) - cc.e_tot
        self.e_ee = ee
        return ee[:nroots]

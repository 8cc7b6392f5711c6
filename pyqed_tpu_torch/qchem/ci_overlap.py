"""Overlap of CI wavefunctions at different geometries + nonadiabatic
couplings.

PyTorch counterpart of ``pyqed_tpu/qchem/ci_overlap.py`` and of the
reference overlap layer
(reference: pyqed/qchem/ci_overlap.py:65 ``wavefunction_overlap`` /
``nonadiabatic_coupling:92``, pyqed/qchem/cisd_overlap.py — a
pyscf-derived CISD-amplitude construction, and pyqed/qchem/overlap.py).

Instead of the reference's amplitude bookkeeping, the overlap is built
determinant-wise, which works uniformly for FCI/CISD/CASCI from
``qchem.ci``:

    <Psi_bra | Psi_ket> = sum_IJ c_I* d_J det( S_occ(I, J) )

with S_occ(I, J) the bra-occ x ket-occ block of the spin-orbital MO
cross overlap C1^T S_AO(R1, R2) C2. The determinant batch is one
batched ``torch.linalg.det`` over all (I, J) pairs on the device instead
of the reference's per-pair Python loops.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .basis import _pair_matrix
from .ci import _host


def cross_overlap_ao(bfs1, bfs2):
    """AO overlap matrix between two basis sets (e.g. the same molecule
    at two geometries) -> (nao1, nao2), on the host."""
    return _pair_matrix(bfs1, bfs2, lambda P, la, lb: P.overlap(la, lb))


def mo_cross_overlap(C1, S12, C2):
    """Spatial-MO cross overlap C1^T S_AO C2 -> (nmo1, nmo2) (NumPy)."""
    return _host(C1).T @ _host(S12) @ _host(C2)


def _spinorb_overlap(smo):
    """Expand a spatial-MO overlap to spin orbitals (2p = p alpha,
    2p+1 = p beta — the qchem.ci convention); cross-spin blocks are 0."""
    n1, n2 = smo.shape
    s = np.zeros((2 * n1, 2 * n2))
    s[0::2, 0::2] = smo
    s[1::2, 1::2] = smo
    return s


def ci_overlap(dets_bra, c_bra, dets_ket, c_ket, smo, device=None):
    """<Psi_bra|Psi_ket> for determinant-expanded CI states.

    dets_*: lists of sorted occupied-spin-orbital tuples (qchem.ci);
    c_*: coefficient vectors (or (ndet, nroots) matrices);
    smo: SPATIAL MO cross-overlap matrix (expanded to spin orbitals
    internally).

    The determinants run on ``device`` (that of ``c_bra`` when it is a
    tensor, else the card when None).
    Returns a scalar (vector inputs) or (nroots_bra, nroots_ket) block.
    """
    if device is None and isinstance(c_bra, torch.Tensor):
        device = c_bra.device
    dev = resolve_device(device)
    s = _spinorb_overlap(_host(smo))
    db = np.asarray(dets_bra)        # (nb, ne)
    dk = np.asarray(dets_ket)        # (nk, ne)
    # occupied-block overlap for every (I, J) pair: (nb, nk, ne, ne)
    M = s[db[:, None, :, None], dk[None, :, None, :]]
    dets = torch.linalg.det(torch.as_tensor(M, device=dev))  # batched LU
    cb = torch.as_tensor(np.atleast_2d(_host(c_bra).T).T, device=dev)
    ck = torch.as_tensor(np.atleast_2d(_host(c_ket).T).T, device=dev)
    out = torch.einsum("im, ij, jn -> mn", cb.conj(), dets, ck)
    return out.squeeze().cpu().numpy()


def wavefunction_overlap(mf1, ci1, mf2, ci2):
    """CI state-overlap block between two converged calculations
    (reference: pyqed/qchem/ci_overlap.py:65; pyqed/qchem/overlap.py:16).

    mf1/mf2: converged RHF objects (possibly different geometries);
    ci1/ci2: run CI objects (FCI/CISD/CASCI) holding .dets/.civec.
    Returns (nroots1, nroots2).
    """
    S12 = cross_overlap_ao(mf1.bfs, mf2.bfs)
    smo = mo_cross_overlap(mf1.mo_coeff, S12, mf2.mo_coeff)
    return ci_overlap(ci1.dets, ci1.civec, ci2.dets, ci2.civec, smo,
                      device=mf1.mol.device)


def nonadiabatic_coupling(make_mol, R0, direction, dr=1e-3, nroots=3,
                          ci_cls=None):
    """First-derivative coupling tau_mn = <Psi_m(R)| d/dR |Psi_n(R)> by
    central differences of the CI overlap
    (reference: pyqed/qchem/ci_overlap.py:92 — forward difference there).

    make_mol(R) -> Molecule at scalar coordinate R (arbitrary
    parametrization, e.g. a bond length or normal-mode displacement);
    ``direction`` is kept for API parity and ignored for the scalar
    parametrization. Returns (nroots, nroots) antisymmetric-to-O(dr^2).
    """
    from .ci import FCI
    if ci_cls is None:
        ci_cls = FCI

    def solve(R):
        mol = make_mol(R)
        mf = mol.RHF().run()
        ci = ci_cls(mf)
        ci.run(nroots=nroots)
        return mf, ci

    mf0, ci0 = solve(R0)
    mfp, cip = solve(R0 + dr)
    mfm, cim = solve(R0 - dr)

    def fix_phase(ciref, mfref, ci, mf):
        """Align CI-state signs to the reference calculation."""
        O = wavefunction_overlap(mfref, ciref, mf, ci)
        sgn = np.sign(np.real(np.diag(O)))
        sgn[sgn == 0] = 1.0
        ci.civec = ci.civec * torch.as_tensor(sgn, device=ci.civec.device)
        return ci

    cip = fix_phase(ci0, mf0, cip, mfp)
    cim = fix_phase(ci0, mf0, cim, mfm)
    Op = wavefunction_overlap(mf0, ci0, mfp, cip)
    Om = wavefunction_overlap(mf0, ci0, mfm, cim)
    tau = (Op - Om) / (2.0 * dr)
    return tau

"""Core-excitation (restricted-excitation-space) TDA — "RXS".

PyTorch counterpart of ``pyqed_tpu/qchem/rxs.py`` and of the reference
core-excitation layer
(reference: pyqed/qchem/core.py — ``get_ab_ras:46`` A/B matrices in a
restricted occ/vir window, ``core_excitation:160`` energy-window /
nstates eigensolves, ``RXS:444`` with ``tdm:518`` transition density
matrices and ``transition_dipole:592``).

The restricted A/B blocks are einsum slices of the MO ERIs; the
energy-window selection is done on the eigenvalues of the (small)
windowed Hermitian A instead of the reference's banded ``eig_banded``
path: one dense ``eigh`` of the windowed block on the mean field's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .ci import _host
from .tdscf import _mo_blocks


def _block(eri, *idx):
    """eri[np.ix_(*idx)] on the tensor's device."""
    n = len(idx)
    t = [torch.as_tensor(np.asarray(ix), device=eri.device).reshape(
        [-1 if k == m else 1 for m in range(n)]) for k, ix in enumerate(idx)]
    return eri[tuple(t)]


def get_ab_ras(mf, occidx=None, viridx=None, singlet=True):
    """A/B response matrices in a restricted excitation window
    (reference: pyqed/qchem/core.py:46).

    occidx/viridx index the occupied / virtual orbitals to keep
    (absolute MO indices; virtuals may be given either absolute or
    relative to the first virtual — absolute assumed when any index
    >= nocc). Returns (A, B) with shape (no, nv, no, nv).
    """
    eri, e, nocc, nvir = _mo_blocks(mf)
    if occidx is None:
        occidx = np.arange(nocc)
    occidx = np.asarray(occidx, dtype=int)
    if viridx is None:
        viridx = np.arange(nocc, nocc + nvir)
    viridx = np.asarray(viridx, dtype=int)
    if viridx.max() < nocc:          # relative virtual indices
        viridx = viridx + nocc
    assert occidx.max() < nocc and viridx.min() >= nocc

    oi = torch.as_tensor(occidx, device=e.device)
    vi = torch.as_tensor(viridx, device=e.device)
    de = e[vi][None, :] - e[oi][:, None]                  # (no, nv)
    ov = _block(eri, occidx, viridx, occidx, viridx)      # (ia|jb)
    oovv = _block(eri, occidx, occidx, viridx, viridx)    # (ij|ab)
    no, nv = len(occidx), len(viridx)
    A = e.new_zeros((no, nv, no, nv))
    idx = torch.arange(no, device=e.device)
    jdx = torch.arange(nv, device=e.device)
    A[idx[:, None], jdx[None, :], idx[:, None], jdx[None, :]] = de
    if singlet:
        A = A + 2.0 * ov - oovv.permute(0, 2, 1, 3)
        B = 2.0 * ov - ov.permute(0, 3, 2, 1)
    else:
        A = A - oovv.permute(0, 2, 1, 3)
        B = -ov.permute(0, 3, 2, 1)
    return A, B


def core_excitation(mf, occidx=None, viridx=None, energy_range=None,
                    nstates=None, singlet=True):
    """Solve the windowed TDA equation A X = w X
    (reference: pyqed/qchem/core.py:160). Returns (w, X) with X of
    shape (no*nv, nroots), NumPy arrays."""
    A, _ = get_ab_ras(mf, occidx, viridx, singlet)
    no, nv = A.shape[:2]
    w, v = torch.linalg.eigh(A.reshape(no * nv, no * nv))
    w, v = w.cpu().numpy(), v.cpu().numpy()
    if energy_range is not None:
        emin, emax = energy_range
        keep = (w >= emin) & (w <= emax)
        w, v = w[keep], v[:, keep]
    elif nstates is not None:
        w, v = w[:nstates], v[:, :nstates]
    return w, v


class RXS:
    """Restricted-excitation-space TDA for core/X-ray spectra
    (reference: pyqed/qchem/core.py:444).

    Typical core-valence-separation use: ``occidx=[0]`` restricts to
    excitations out of the 1s core orbital.
    """

    def __init__(self, mf, occidx=None, viridx=None, singlet=True):
        self.mf = mf
        nocc = mf.nocc
        nmo = mf.mo_coeff.shape[1]
        self.occidx = (np.arange(nocc) if occidx is None
                       else np.asarray(occidx, dtype=int))
        vir = (np.arange(nocc, nmo) if viridx is None
               else np.asarray(viridx, dtype=int))
        if len(vir) and vir.max() < nocc:
            vir = vir + nocc
        self.viridx = vir
        self.singlet = singlet
        self.e = None
        self.x = None        # (no, nv, nroots)

    def core_excitation(self, nstates=None, energy_range=None):
        w, v = core_excitation(self.mf, self.occidx, self.viridx,
                               energy_range=energy_range, nstates=nstates,
                               singlet=self.singlet)
        self.e = w
        self.x = v.reshape(len(self.occidx), len(self.viridx), -1)
        return w, v

    run = kernel = core_excitation

    def get_ab(self):
        return get_ab_ras(self.mf, self.occidx, self.viridx, self.singlet)

    def tdm(self, n, representation="mo"):
        """Transition density matrix <Phi_n| a+ i |Phi_0> = conj(X^n_ia)
        (reference: pyqed/qchem/core.py:518). 'mo': (no, nv) window
        block; 'ao': full (nao, nao) AO matrix D = C_o X C_v^T."""
        X = self.x[:, :, n].conj()
        if representation == "mo":
            return X
        C = _host(self.mf.mo_coeff)
        Co = C[:, self.occidx]
        Cv = C[:, self.viridx]
        return Co @ X @ Cv.T

    def transition_dipole(self):
        """<0|r|n> for every computed root (nroots, 3)
        (reference: pyqed/qchem/core.py:592)."""
        Dmo = _host(self.mf.transition_dipoles())        # (3, nmo, nmo)
        dov = Dmo[:, self.occidx][:, :, self.viridx]     # (3, no, nv)
        return np.einsum("kia, ian -> nk", dov, np.asarray(self.x)) \
            * np.sqrt(2.0)

    def oscillator_strength(self):
        mu = self.transition_dipole()
        return (2.0 / 3.0) * self.e * np.sum(np.abs(mu) ** 2, axis=1)

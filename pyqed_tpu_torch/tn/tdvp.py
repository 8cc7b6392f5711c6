"""One- and two-site TDVP time evolution of an MPS under an MPO
Hamiltonian (PyTorch).

Counterpart of ``pyqed_tpu/tn/tdvp.py``, which fills the reference's
TDVP stub (reference: pyqed/mps/mps.py:1463, an empty class) with the
Haegeman one-site integrator:

    sweep L→R: evolve the site tensor forward dt/2 under H_eff(1 site),
               QR-split, evolve the bond centre backward dt/2 under the
               zero-site K_eff; then the mirrored R→L half-sweep.

The local exponentials are Arnoldi on the ported
:func:`ops.expm.krylov_expm_multiply`, the local actions pairwise einsums
on the MPS's device. The QR gauge is fixed to a positive diagonal
(:func:`_qr_pos`), so the tensors themselves agree across backends.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .mps import (MPS, MPO, _boundary, _bond_action, _one_site_action,
                  _push_left, _push_right, _same_device, _two_site_action)
from ..ops.expm import krylov_expm_multiply
from ..ops.linalg import as_tensor


def _krylov_dim(m, x):
    return min(m, x.numel() - 1) or 1


def _site_expm(LP, W, RP, M, tau, m):
    return krylov_expm_multiply(
        lambda x: -1j * _one_site_action(LP, W, RP, x), M, dt=tau, m=m)


def _bond_expm(LP, RP, C, tau, m):
    return krylov_expm_multiply(
        lambda x: -1j * _bond_action(LP, RP, x), C, dt=tau, m=m)


def _two_expm(LP, W1, W2, RP, th, tau, m):
    return krylov_expm_multiply(
        lambda x: -1j * _two_site_action(LP, W1, W2, RP, x), th, dt=tau,
        m=m)


def _qr_pos(M):
    """QR with R's diagonal made real positive (a deterministic gauge)."""
    Q, R = torch.linalg.qr(M)
    dR = torch.diagonal(R)
    ph = torch.sgn(torch.where(dR.abs() > 1e-30, dR, torch.ones_like(dR)))
    return Q * ph[None, :], R * ph.conj()[:, None]


class TDVP:
    """One-site TDVP integrator.

    Parameters
    ----------
    mpo : MPO Hamiltonian, on the MPS's device.
    mps : initial state (B canonical form, as produced by MPS/DMRG).
    krylov_dim : Arnoldi dimension for the local exponentials.
    """

    def __init__(self, mpo: MPO, mps: MPS, krylov_dim: int = 16):
        _same_device(mpo, mps, type(self).__name__)
        self.mpo = mpo
        self.L = mps.L
        self.m = krylov_dim
        cdt = torch.complex128
        self.Ws = [W.to(cdt) for W in mpo.Ws]
        # mixed-canonical storage; orthocentre at 0: M0 = S0 B0, the rest
        # right-canonical
        self.Ms = [mps.get_theta1(0).to(cdt)] + [B.to(cdt)
                                                 for B in mps.Bs[1:]]
        dev = mps.device
        self.LPs = [None] * (self.L + 1)
        self.RPs = [None] * (self.L + 1)
        self.LPs[0] = _boundary(self.Ms[0].shape[0], mpo.Ws[0].shape[0], 0,
                                cdt, dev)
        self.RPs[self.L] = _boundary(self.Ms[-1].shape[2],
                                     mpo.Ws[-1].shape[1], -1, cdt, dev)
        for i in range(self.L - 1, 0, -1):
            self._push_RP(i)

    # ------------------------------------------------------ environments
    def _push_RP(self, i):
        """RPs[i] from RPs[i+1] using the right-canonical Ms[i]."""
        self.RPs[i] = _push_right(self.RPs[i + 1], self.Ms[i], self.Ws[i])

    def _push_LP(self, i, A):
        """LPs[i+1] from LPs[i] using the left-canonical A at site i."""
        self.LPs[i + 1] = _push_left(self.LPs[i], A, self.Ws[i])

    # --------------------------------------------------- local evolutions
    def _evolve_site(self, i, M, tau):
        return _site_expm(self.LPs[i], self.Ws[i], self.RPs[i + 1], M, tau,
                          _krylov_dim(self.m, M))

    def _evolve_bond(self, i, C, tau):
        """Zero-site backward evolution between sites i-1 and i."""
        return _bond_expm(self.LPs[i], self.RPs[i], C, tau,
                          _krylov_dim(self.m, C))

    # ------------------------------------------------------------- sweep
    def step(self, dt):
        """One second-order symmetric step (two half-sweeps of dt/2)."""
        L = self.L
        for i in range(L - 1):
            M = self._evolve_site(i, self.Ms[i], +dt / 2)
            chiL, d, chiR = M.shape
            Q, R = _qr_pos(M.reshape(chiL * d, chiR))
            A = Q.reshape(chiL, d, Q.shape[1])
            self._push_LP(i, A)
            self.Ms[i] = A
            C = self._evolve_bond(i + 1, R, -dt / 2)
            self.Ms[i + 1] = torch.einsum("ab, bpc -> apc", C, self.Ms[i + 1])
        self.Ms[L - 1] = self._evolve_site(L - 1, self.Ms[L - 1], +dt)
        for i in range(L - 1, 0, -1):
            M = self.Ms[i]
            chiL, d, chiR = M.shape
            # RQ decomposition via QR of the adjoint
            Q, R = _qr_pos(M.reshape(chiL, d * chiR).mH)
            self.Ms[i] = Q.mH.resolve_conj().reshape(Q.shape[1], d, chiR)
            self._push_RP(i)
            C = self._evolve_bond(i, R.mH.resolve_conj(), -dt / 2)
            M_prev = torch.einsum("apb, bc -> apc", self.Ms[i - 1], C)
            self.Ms[i - 1] = self._evolve_site(i - 1, M_prev, +dt / 2)
        return self

    def run(self, dt, nt):
        for _ in range(nt):
            self.step(dt)
        return self

    # ------------------------------------------------------- observables
    def to_mps(self) -> MPS:
        """A B-form MPS snapshot in canonical form (the orthocentre must be
        at 0): an L→R QR sweep, then an R→L SVD sweep, so that ``Ss`` are
        the Schmidt values. The JAX package's snapshot skips the QR sweep,
        so its ``Ss`` away from site 0, and its ``expect_local`` there,
        are not those of the state."""
        return MPS._canonical(list(self.Ms))

    def expect_local(self, ops: Sequence):
        """<O_i> for one operator per site (None to skip a site), from
        the canonical centre at site 0 after to_mps(); Python complex
        numbers (one host read each)."""
        psi = self.to_mps()
        out = []
        for i, op in enumerate(ops):
            if op is None:
                out.append(None)
                continue
            th = psi.get_theta1(i)
            op = as_tensor(op, device=th.device).to(th.dtype)
            out.append(complex(torch.einsum("apb, pq, aqb ->", th.conj(),
                                            op, th)))
        return out

    def expect_mpo(self, mpo=None):
        return complex((mpo or self.mpo).expect(self.to_mps()))


class TDVP2(TDVP):
    """Two-site TDVP: grows the bond dimension on the fly (up to
    chi_max), unlike the strictly fixed-rank one-site variant — the right
    default for quenches from product states. Each split reads the kept
    rank back to the host."""

    def __init__(self, mpo: MPO, mps: MPS, chi_max: int = 32,
                 krylov_dim: int = 16, svd_eps: float = 1e-10):
        super().__init__(mpo, mps, krylov_dim=krylov_dim)
        self.chi_max = chi_max
        self.svd_eps = svd_eps

    def _evolve_two(self, i, th, tau):
        return _two_expm(self.LPs[i], self.Ws[i], self.Ws[i + 1],
                         self.RPs[i + 2], th, tau, _krylov_dim(self.m, th))

    def _split(self, th):
        chiL, d1, d2, chiR = th.shape
        U, S, Vh = torch.linalg.svd(th.reshape(chiL * d1, d2 * chiR),
                                    full_matrices=False)
        chi = max(1, min(self.chi_max, int((S > self.svd_eps).sum())))
        U, S, Vh = U[:, :chi], S[:chi], Vh[:chi]
        S = S / torch.linalg.vector_norm(S)
        return (U.reshape(chiL, d1, chi), S.to(U.dtype),
                Vh.reshape(chi, d2, chiR))

    def step(self, dt):
        L = self.L
        tau = dt / 2
        for i in range(L - 1):
            th = torch.einsum("apb, bqc -> apqc", self.Ms[i], self.Ms[i + 1])
            A, S, B = self._split(self._evolve_two(i, th, +tau))
            self._push_LP(i, A)
            self.Ms[i] = A
            center = S[:, None, None] * B
            if i < L - 2:
                # backward one-site evolution of the new centre; RPs[i+2]
                # is still valid, since the sites right of i+1 are
                # unchanged since their last split
                self.RPs[i + 1] = None  # stale
                center = self._evolve_site(i + 1, center, -tau)
            self.Ms[i + 1] = center
        for i in range(L - 2, -1, -1):
            th = torch.einsum("apb, bqc -> apqc", self.Ms[i], self.Ms[i + 1])
            A, S, B = self._split(self._evolve_two(i, th, +tau))
            self.Ms[i + 1] = B
            self._push_RP(i + 1)
            center = A * S[None, None, :]
            if i > 0:
                center = self._evolve_site(i, center, -tau)
            self.Ms[i] = center
        return self

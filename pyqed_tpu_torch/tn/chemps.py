"""Ab initio quantum-chemistry MPOs from (h1e, eri) (PyTorch).

Counterpart of ``pyqed_tpu/tn/chemps.py`` (reference: pyqed/qchem/dmrg.py
``DMRG(mf, D):834``, block DMRG with complementary operators). The
electronic Hamiltonian

    H = sum_pq h_pq a+_p a_q + 1/4 sum_pqrs <pq||rs> a+_p a+_q a_s a_r

becomes an exact MPO: every product term is Jordan-Wigner-mapped
numerically to a tensor product of 2x2 matrices, and the sum of ~k^4
terms is compressed by SVD sweeps over the coefficient matrix (a CP ->
MPS conversion whose bond dimension comes out at the O(k^2)
complementary-operator scaling). The construction is NumPy on the host,
as in the JAX package, so both packages build identical W tensors; the
MPO lands on ``device`` (the card when None).

:class:`DMRGQC` runs two-site DMRG on this MPO from a converged mean field
of ``pyqed_tpu_torch.qchem`` (its spin-orbital integrals,
``qchem.ci.spinorb_ints``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .mps import MPO, MPS, two_site_dmrg

_SP = np.array([[0.0, 0.0], [1.0, 0.0]])    # sigma+ = a+ (|1><0|)
_SM = np.array([[0.0, 1.0], [0.0, 0.0]])    # sigma- = a
_Z = np.array([[1.0, 0.0], [0.0, -1.0]])    # JW string
_I = np.eye(2)
_NUM = np.array([[0.0, 0.0], [0.0, 1.0]])


def jw_op(kind: str, p: int, L: int) -> np.ndarray:
    """JW image of a single fermion operator as an (L, 2, 2) stack of
    local matrices (pure tensor product): a+_p = Z_0..Z_{p-1} sigma+_p.
    kind: 'c' (annihilation) or 'cdag'."""
    ops = np.tile(_I, (L, 1, 1))
    ops[:p] = _Z
    ops[p] = _SP if kind == "cdag" else _SM
    return ops


def jw_product(factors) -> np.ndarray | None:
    """Site-wise product of JW tensor-product operators, in operator
    order (leftmost acts last). Returns (L, 2, 2), or None if the product
    vanishes identically."""
    out = factors[0].copy()
    for f in factors[1:]:
        out = np.einsum("kpq, kqr -> kpr", out, f)
    if any(not np.any(out[k]) for k in range(out.shape[0])):
        return None
    return out


def mpo_from_product_terms(coeffs, ops, tol=1e-12, device=None) -> MPO:
    """Compress  H = sum_t coeffs[t] * (x)_k ops[t, k]  into an MPO.

    coeffs : (P,) real/complex amplitudes.
    ops : (P, L, d, d) local operator stacks (identity where a term does
        not act).
    tol : relative singular-value cutoff; 1e-12 keeps the MPO exact to
        numerical precision while discarding the null space.

    One left-to-right sweep carries the (r, P) mixing matrix C of the
    already-fixed left part; at site k it SVDs the (r*d*d, P) matrix
    M[(a,p,q), t] = C[a, t] * ops[t, k, p, q]. A right-to-left SVD sweep
    then restores the two-sided operator rank.
    """
    ops = np.asarray(ops)
    P, L, d, _ = ops.shape
    C = np.asarray(coeffs, dtype=ops.dtype
                   if np.iscomplexobj(ops) or np.iscomplexobj(coeffs)
                   else float).reshape(1, P)

    def kept(S):
        return max(1, int(np.sum(S > tol * (S[0] if S.size else 1.0))))

    Ws = []
    for k in range(L - 1):
        r = C.shape[0]
        M = np.einsum("at, tpq -> apqt", C, ops[:, k]).reshape(r * d * d, P)
        U, S, Vh = np.linalg.svd(M, full_matrices=False)
        keep = kept(S)
        Ws.append(U[:, :keep].reshape(r, d, d, keep).transpose(0, 3, 1, 2))
        C = S[:keep, None] * Vh[:keep]
    Ws.append(np.einsum("at, tpq -> apq", C, ops[:, L - 1])[:, None])
    for k in range(L - 1, 0, -1):
        W = Ws[k]
        wL, wR = W.shape[0], W.shape[1]
        U, S, Vh = np.linalg.svd(W.transpose(0, 2, 3, 1).reshape(
            wL, d * d * wR), full_matrices=False)
        keep = kept(S)
        Ws[k] = Vh[:keep].reshape(keep, d, d, wR).transpose(0, 3, 1, 2)
        Ws[k - 1] = np.einsum("abpq, br -> arpq", Ws[k - 1],
                              U[:, :keep] * S[:keep])
    dev = resolve_device(device)
    return MPO([torch.as_tensor(np.ascontiguousarray(W), device=dev)
                for W in Ws])


def spin_orbital_terms(h, g, tol=1e-12):
    """Product-term list of the spin-orbital Hamiltonian
    H = sum h_pq a+_p a_q + 1/4 sum <pq||rs> a+_p a+_q a_s a_r
    (g antisymmetrized, physicists' ordering). NumPy: returns
    (coeffs (P,), ops (P, L, 2, 2))."""
    h = np.asarray(h)
    g = np.asarray(g)
    L = h.shape[0]
    cdag = [jw_op("cdag", p, L) for p in range(L)]
    c = [jw_op("c", p, L) for p in range(L)]
    coeffs, ops = [], []
    for p in range(L):
        for q in range(L):
            if abs(h[p, q]) <= tol:
                continue
            prod = jw_product([cdag[p], c[q]])
            if prod is not None:
                coeffs.append(h[p, q])
                ops.append(prod)
    # antisymmetry: 1/4 sum_pqrs = sum_{p<q, r<s} g_pqrs a+_p a+_q a_s a_r
    for p in range(L):
        for q in range(p + 1, L):
            for s in range(L):
                for r in range(s + 1, L):
                    if abs(g[p, q, r, s]) <= tol:
                        continue
                    prod = jw_product([cdag[p], cdag[q], c[s], c[r]])
                    if prod is not None:
                        coeffs.append(g[p, q, r, s])
                        ops.append(prod)
    return np.asarray(coeffs), np.asarray(ops)


def qc_mpo(h, g, tol=1e-12, nelec=None, shift=2.0, device=None) -> MPO:
    """Exact MPO of the spin-orbital electronic Hamiltonian.

    nelec : if given, add the quadratic number penalty
        shift*(N_hat - nelec)^2 at the term level before compression,
        pinning DMRG to the physical sector with one compact MPO.
    """
    coeffs, ops = spin_orbital_terms(h, g, tol=tol)
    if nelec is not None:
        L = np.asarray(h).shape[0]
        extra_c, extra_o = [], []
        for p in range(L):                     # shift*(1-2n)*n_p
            o = np.tile(_I, (L, 1, 1))
            o[p] = _NUM
            extra_c.append(shift * (1.0 - 2.0 * nelec))
            extra_o.append(o)
        for p in range(L):                     # 2*shift*n_p n_q (p<q)
            for q in range(p + 1, L):
                o = np.tile(_I, (L, 1, 1))
                o[p] = _NUM
                o[q] = _NUM
                extra_c.append(2.0 * shift)
                extra_o.append(o)
        extra_c.append(shift * nelec ** 2)     # constant
        extra_o.append(np.tile(_I, (L, 1, 1)))
        coeffs = np.concatenate([coeffs, np.asarray(extra_c)])
        ops = np.concatenate([ops, np.asarray(extra_o)], axis=0)
    return mpo_from_product_terms(coeffs, ops, tol=tol, device=device)


def number_mpo(L, device=None) -> MPO:
    """MPO of the total-number operator sum_p n_p on L JW sites."""
    ops = np.tile(_I, (L, L, 1, 1))
    for p in range(L):
        ops[p, p] = _NUM
    return mpo_from_product_terms(np.ones(L), ops, device=device)


def _hartree_fock_mps(L, occ, device=None):
    """Product-state MPS |occ> (chi = 1)."""
    return MPS.from_product_state(
        [[0.0, 1.0] if k in occ else [1.0, 0.0] for k in range(L)],
        device=device)


class DMRGQC:
    """Ab initio DMRG on a converged mean field
    (reference front door: pyqed/qchem/dmrg.py:834 ``DMRG(mf, D)``).

    Parameters
    ----------
    mf : converged RHF-style object of ``pyqed_tpu_torch.qchem`` exposing
        ``mo_ints()`` and ``mol.nelec`` / ``mol.energy_nuc()``.
    D : maximum MPS bond dimension (the reference's ``m``).
    device : where the MPO and the sweeps live (the mean field's molecule's
        device when None).
    """

    def __init__(self, mf, D=64, mpo_tol=1e-12, shift=2.0, device=None):
        from ..qchem.ci import spinorb_ints
        self.mf = mf
        self.D = int(D)
        self.device = resolve_device(mf.mol.device if device is None
                                     else device)
        hmo, eri_mo = mf.mo_ints()
        h, g = spinorb_ints(hmo, eri_mo)
        self.h, self.g = h.cpu().numpy(), g.cpu().numpy()
        self.ns = self.h.shape[0]
        self.nelec = mf.mol.nelec
        # number-penalized MPO: pins the N sector so a random
        # (sector-spanning) seed converges to the NEUTRAL ground state;
        # at the minimum the penalty term is exactly zero
        self.mpo = qc_mpo(self.h, self.g, tol=mpo_tol, nelec=self.nelec,
                          shift=shift, device=self.device)
        self.e_tot = None
        self.mps = None

    def run(self, sweeps=10, seed=0):
        # random seed spans all sectors — a chi=1 Hartree-Fock product
        # is a fixed point of local two-site updates (bond never grows)
        psi0 = MPS.random(self.ns, d=2, chi=min(self.D, 8), seed=seed,
                          device=self.device)
        energies, psi = two_site_dmrg(self.mpo, psi0, chi_max=self.D,
                                      sweeps=sweeps)
        self.sweep_energies = energies
        self.e_elec = float(np.real(energies[-1]))
        self.e_tot = self.e_elec + float(self.mf.mol.energy_nuc())
        self.mps = psi
        return self.e_tot

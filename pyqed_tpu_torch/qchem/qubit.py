"""Qubitization of molecular Hamiltonians: second-quantized CAS
Hamiltonian -> qubit operator via the Jordan-Wigner (or Bravyi-Kitaev)
transform.

PyTorch counterpart of ``pyqed_tpu/qchem/qubit.py`` (reference:
pyqed/qchem/ci/casci.py — ``get_SO_matrix``, ``qubitization:~690``,
``jordan_wigner``, ``fix_nelec_by_energy_penalty``). All mode operators
come from the port's ``models/lattice`` encodings, dense on the device;
the one- and two-electron sums are contractions over the n^2 mode
excitation matrices E_pq = c_p^+ c_q built there once. The active-space
integrals are contractions of the MO integrals on the mean field's
device (the JAX package loops over the core on the host).

Spin-orbital convention: 2p = spatial p alpha, 2p+1 = spatial p beta
(matches :func:`.ci.spinorb_ints`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .ci import spinorb_ints
from ..models.lattice import jordan_wigner_ops, bravyi_kitaev_ops

__all__ = [
    "active_space_integrals", "qubit_hamiltonian", "qubitize",
    "number_operator", "fix_nelec_penalty", "pauli_decompose",
    "pauli_string_hamiltonian",
]


def active_space_integrals(mf, ncas=None, nelecas=None):
    """Spin-orbital (h, <pq||rs>) of a CAS window plus the scalar
    offset (core energy + nuclear repulsion).

    ncas/nelecas None -> the full MO space (qubitized FCI).
    Returns (h_so, g_so, e_offset) with h_so (2 ncas, 2 ncas) and g_so
    the antisymmetrized physicists' tensor, on the mean field's device.
    """
    hmo, eri = mf.mo_ints()
    nmo = hmo.shape[0]
    if ncas is None:
        ncas = nmo
    if nelecas is None:
        nelecas = 2 * mf.nocc
    ncore = mf.nocc - nelecas // 2
    c = slice(0, ncore)
    a = slice(ncore, ncore + ncas)
    ecore = (2.0 * torch.sum(torch.diagonal(hmo)[c])
             + 2.0 * torch.einsum("iijj ->", eri[c, c, c, c])
             - torch.einsum("ijji ->", eri[c, c, c, c]))
    heff = (hmo[a, a] + 2.0 * torch.einsum("abcc -> ab", eri[a, a, c, c])
            - torch.einsum("accb -> ab", eri[a, c, c, a]))
    h_so, g_so = spinorb_ints(heff, eri[a, a, a, a])
    return h_so, g_so, float(ecore) + mf.mol.energy_nuc()


def _mode_ops(ns, encoding, device):
    return (jordan_wigner_ops(ns, device=device) if encoding == "jw"
            else bravyi_kitaev_ops(ns, device=device))


def qubit_hamiltonian(h_so, g_so, e_offset=0.0, encoding="jw", device=None):
    """Dense qubit-space Hamiltonian (2^n, 2^n) of
    H = sum h_pq c_p^+ c_q + 1/4 sum <pq||rs> c_p^+ c_q^+ c_s c_r + E0,
    complex, on ``h_so``'s device when it is a tensor (else ``device``,
    the card when None).

    encoding: 'jw' (Jordan-Wigner) or 'bk' (Bravyi-Kitaev) — both give
    the same spectrum; the encodings differ by the qubit basis.
    """
    dev = h_so.device if (device is None and isinstance(h_so, torch.Tensor)) \
        else resolve_device(device)
    h = torch.as_tensor(h_so, device=dev).to(torch.complex128)
    g = torch.as_tensor(g_so, device=dev).to(torch.complex128)
    ns = h.shape[0]
    c = torch.stack(_mode_ops(ns, encoding, dev))          # (ns, d, d)
    dim = c.shape[-1]
    # E_pq = c_p^+ c_q, reused by both the 1e and 2e sums
    E = torch.einsum("pji, qjk -> pqik", c.conj(), c)
    Ef = E.reshape(ns * ns, dim * dim)
    H = (h.reshape(1, -1) @ Ef).reshape(dim, dim)
    # c_p^+ c_q^+ c_s c_r = E_pr E_qs - delta_qr E_ps  (normal order)
    gE = torch.einsum("pqrs, prij -> qsij", g, E)
    H = H + 0.25 * torch.einsum("qsij, qsjk -> ik", gE, E)
    H = H - 0.25 * (torch.einsum("pqqs -> ps", g).reshape(1, -1)
                    @ Ef).reshape(dim, dim)
    return H + e_offset * torch.eye(dim, dtype=H.dtype, device=dev)


def qubitize(mf, ncas=None, nelecas=None, encoding="jw"):
    """mean-field -> dense qubit Hamiltonian over 2*ncas qubits whose
    lowest eigenvalue in the nelecas sector is the CASCI/FCI total
    energy (reference ``CASCI.qubitization``)."""
    h_so, g_so, e0 = active_space_integrals(mf, ncas, nelecas)
    return qubit_hamiltonian(h_so, g_so, e0, encoding)


def number_operator(ns, spin=None, encoding="jw", device=None):
    """Qubit-space particle-number operator on ``device`` (the card when
    None); spin='alpha'/'beta' restricts to even/odd spin-orbitals."""
    c = _mode_ops(ns, encoding, resolve_device(device))
    sel = range(ns) if spin is None else (
        range(0, ns, 2) if spin == "alpha" else range(1, ns, 2))
    return sum(c[p].conj().T @ c[p] for p in sel)


def fix_nelec_penalty(H, ns, nelec_a, nelec_b, shift=0.1,
                      encoding="jw"):
    """H + shift [(N_a - nelec_a)^2 + (N_b - nelec_b)^2] — pushes
    wrong-particle-number sectors up so a sector-agnostic ground-state
    search lands in the physical sector (reference
    ``fix_nelec_by_energy_penalty``). On ``H``'s device."""
    H = torch.as_tensor(H).to(torch.complex128)
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    Ia = number_operator(ns, "alpha", encoding, H.device) - nelec_a * eye
    Ib = number_operator(ns, "beta", encoding, H.device) - nelec_b * eye
    return H + shift * (Ia @ Ia + Ib @ Ib)


# ------------------------------------------------------------------
# Pauli-string decomposition (the measurement-side interface; host)
# ------------------------------------------------------------------

_PAULIS = {
    "I": np.eye(2, dtype=complex),
    "X": np.array([[0, 1], [1, 0]], dtype=complex),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
    "Z": np.array([[1, 0], [0, -1]], dtype=complex),
}


def pauli_decompose(H, n_qubits, tol=1e-10):
    """Decompose a dense (2^n, 2^n) Hermitian H into Pauli strings:
    returns {string: real coefficient} with |coef| > tol, on the host.

    n successive single-qubit partial transforms (each a reshape + 4x4
    trace contraction) — O(n 4^n) instead of 4^n full-matrix traces.
    """
    if isinstance(H, torch.Tensor):
        H = H.detach().cpu().numpy()
    H = np.asarray(H, dtype=complex)
    dim = 2 ** n_qubits
    assert H.shape == (dim, dim)
    labels = "IXYZ"
    basis = np.stack([_PAULIS[s] for s in labels])       # (4, 2, 2)
    T = H.reshape((2,) * (2 * n_qubits))
    perm = []
    for q in range(n_qubits):
        perm += [q, n_qubits + q]
    T = T.transpose(perm)
    for q in range(n_qubits):
        T = np.tensordot(T, basis.conj(), axes=([q, q + 1], [1, 2])) / 2
        T = np.moveaxis(T, -1, q)
    coefs = {}
    for flat, val in enumerate(T.reshape(-1)):
        if abs(val) > tol:
            digits = np.base_repr(flat, base=4).zfill(n_qubits)
            coefs["".join(labels[int(d)] for d in digits)] = float(
                val.real)
    return coefs


def pauli_string_hamiltonian(mf, ncas=None, nelecas=None,
                             encoding="jw", tol=1e-10):
    """mean-field -> {Pauli string: coefficient} for VQE-style use."""
    H = qubitize(mf, ncas, nelecas, encoding)
    n = int(np.log2(H.shape[0]))
    return pauli_decompose(H, n, tol)

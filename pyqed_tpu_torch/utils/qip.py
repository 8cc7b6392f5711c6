"""Quantum-information utilities: reduced density matrices, entropies,
mutual information, entanglement measures.

Counterpart of ``pyqed_tpu/utils/qip.py``, on the port's ``ops/linalg``:
states are tensors (a NumPy input becomes a CPU tensor) and every result
is a tensor on the state's device.
"""
from __future__ import annotations

from typing import Sequence

import math

import numpy as np
import torch

from ..ops.linalg import as_tensor, dag, ket2dm


def _as_dm(state):
    state = as_tensor(state)
    if state.dim() == 1:
        return ket2dm(state)
    return state


def reduce_dm(state, indices: Sequence[int], dims=None):
    """Reduced density matrix on qubits/qudits ``indices``."""
    rho = _as_dm(state)
    N = rho.shape[0]
    if dims is None:
        nq = int(round(np.log2(N)))
        dims = [2] * nq
    nsub = len(dims)
    rho = torch.reshape(rho, list(dims) + list(dims))
    keep = list(indices)
    traced = [i for i in range(nsub) if i not in keep]
    perm = (keep + traced + [i + nsub for i in keep]
            + [i + nsub for i in traced])
    rho = torch.permute(rho, perm)
    d_keep = int(np.prod([dims[i] for i in keep])) if keep else 1
    d_tr = int(np.prod([dims[i] for i in traced])) if traced else 1
    rho = torch.reshape(rho, (d_keep, d_tr, d_keep, d_tr))
    return torch.einsum("atbt -> ab", rho)


def vn_entropy(state, indices=None, dims=None, base=None):
    """von Neumann entropy of the reduced state on ``indices``."""
    if indices is not None:
        rho = reduce_dm(state, indices, dims)
    else:
        rho = _as_dm(state)
    w = torch.linalg.eigvalsh(rho)
    w = torch.clamp(w.real, min=1e-300)
    S = -torch.sum(w * torch.log(w))
    if base is not None:
        S = S / math.log(base)
    return S


def mutual_info(state, indices0, indices1, dims=None, base=None):
    """I(A:B) = S(A) + S(B) - S(AB)."""
    SA = vn_entropy(state, indices0, dims, base)
    SB = vn_entropy(state, indices1, dims, base)
    SAB = vn_entropy(state, list(indices0) + list(indices1), dims, base)
    return SA + SB - SAB


def purity(state):
    rho = _as_dm(state)
    return torch.real(torch.trace(rho @ rho))


def concurrence(state):
    """Two-qubit concurrence (Wootters)."""
    rho = _as_dm(state).to(torch.complex128)
    sy = torch.tensor([[0, -1j], [1j, 0]], dtype=rho.dtype, device=rho.device)
    YY = torch.kron(sy, sy)
    rho_tilde = YY @ torch.conj(rho) @ YY
    evals = torch.linalg.eigvals(rho @ rho_tilde)
    lam = torch.sqrt(torch.clamp(torch.sort(torch.real(evals),
                                            descending=True).values, min=0))
    return torch.clamp(lam[0] - lam[1] - lam[2] - lam[3], min=0.0)


def tracedist(A, B):
    """Trace distance."""
    diff = _as_dm(A) - _as_dm(B)
    w = torch.linalg.eigvalsh(dag(diff) @ diff)
    return 0.5 * torch.sum(torch.sqrt(torch.clamp(w.real, min=0)))


def hilbert_dist(A, B):
    """Hilbert-Schmidt distance."""
    diff = _as_dm(A) - _as_dm(B)
    return torch.real(torch.trace(dag(diff) @ diff))


def fidelity(A, B):
    """Uhlmann fidelity F(rho, sigma)."""
    rho, sigma = _as_dm(A), _as_dm(B)
    w, v = torch.linalg.eigh(rho)
    sqrt_rho = (v * torch.sqrt(torch.clamp(w.real, min=0)).to(v.dtype)) \
        @ dag(v)
    M = sqrt_rho @ sigma.to(sqrt_rho.dtype) @ sqrt_rho
    wm = torch.linalg.eigvalsh(M)
    return torch.sum(torch.sqrt(torch.clamp(wm.real, min=0))) ** 2


def hadamard():
    """The Hadamard gate (a CPU tensor, as the operators of
    ``ops/operators``)."""
    return torch.tensor([[1.0, 1.0], [1.0, -1.0]],
                        dtype=torch.float64) / math.sqrt(2.0)

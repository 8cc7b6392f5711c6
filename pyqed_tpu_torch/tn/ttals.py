"""Tensor-train decomposition (TT-SVD) and ALS refinement (PyTorch).

PyTorch counterpart of ``pyqed_tpu/tn/ttals.py`` (reference:
pyqed/ldr/tt_als.py, a demo script there): compress a high-dimensional
surface or wavefunction tensor into a train of 3-way cores
G_k (r_{k-1}, n_k, r_k) by sequential SVD, refine the cores against the
full tensor by ALS sweeps, and contract or evaluate them. The full tensor
and the cores are tensors on ``device`` (the card when None, raises
without one); the SVDs and pseudo-inverses run there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor


def tt_svd(T, max_rank=16, eps=1e-12, device=None):
    """TT cores [G_k (r_{k-1}, n_k, r_k)] of a full tensor by sequential
    SVD (the TT-SVD algorithm); singular values below ``eps`` times the
    largest are dropped, and no rank exceeds ``max_rank``."""
    T = as_tensor(T, device=resolve_device(device))
    dims = T.shape
    d = len(dims)
    cores = []
    M = T.reshape(dims[0], -1)
    r_prev = 1
    for k in range(d - 1):
        M = M.reshape(r_prev * dims[k], -1)
        U, S, Vh = torch.linalg.svd(M, full_matrices=False)
        r = max(1, min(max_rank, int((S > eps * S[0]).sum())))
        cores.append(U[:, :r].reshape(r_prev, dims[k], r))
        M = S[:r, None].to(Vh.dtype) * Vh[:r]
        r_prev = r
    cores.append(M.reshape(r_prev, dims[-1], 1))
    return cores


def tt_to_dense(cores):
    """The full tensor of a train (tensors, or arrays on the CPU), on the
    cores' device."""
    cores = [as_tensor(G) for G in cores]
    out = cores[0]
    for G in cores[1:]:
        out = torch.tensordot(out, G, dims=1)
    return out.reshape([G.shape[1] for G in cores])


def tt_eval(cores, idx):
    """Entries at integer indices ``idx`` (m, d) -> (m,)."""
    cores = [as_tensor(G) for G in cores]
    idx = torch.as_tensor(np.atleast_2d(np.asarray(idx)), dtype=torch.long,
                          device=cores[0].device)
    out = cores[0][:, idx[:, 0], :].movedim(0, 1)         # (m, 1, r)
    for k, G in enumerate(cores[1:], 1):
        out = torch.bmm(out, G[:, idx[:, k], :].movedim(1, 0))
    return out[:, 0, 0]


def tt_als(T, cores, sweeps=4, device=None):
    """ALS refinement of TT cores against the FULL tensor T: each core is
    solved in closed form (least squares, pseudo-inverses) with the others
    fixed."""
    dev = resolve_device(device)
    T = as_tensor(T, device=dev)
    cores = [as_tensor(G, device=dev).clone() for G in cores]
    d = len(cores)
    for _ in range(sweeps):
        for k in range(d):
            left = torch.ones((1, 1), dtype=cores[0].dtype, device=dev)
            for G in cores[:k]:
                left = torch.tensordot(left, G, dims=1).reshape(
                    -1, G.shape[2])
            right = torch.ones((1, 1), dtype=cores[0].dtype, device=dev)
            for G in reversed(cores[k + 1:]):
                right = torch.tensordot(G, right, dims=1).reshape(
                    G.shape[0], -1)
            nk = cores[k].shape[1]
            Tm = T.reshape(left.shape[0], nk, right.shape[1]).to(left.dtype)
            Lp = torch.linalg.pinv(left)
            Rp = torch.linalg.pinv(right)
            cores[k] = torch.einsum("ap, pnq, qb -> anb", Lp, Tm, Rp)
    return cores


def tt_rank(cores):
    return [G.shape[2] for G in cores[:-1]]

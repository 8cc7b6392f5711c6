"""Davidson / block-Davidson iterative eigensolvers (PyTorch).

PyTorch counterpart of ``pyqed_tpu/ops/davidson.py`` (reference:
pyqed/davidson.py ``davidson:70``, ``block_davidson:155``): a matrix-free
``matvec``, a growing orthonormal search space kept with one QR per
iteration, Rayleigh-Ritz through a small ``torch.linalg.eigh`` of the
subspace matrix, and a diagonal (Davidson) or Jacobi-Davidson
preconditioned residual expansion. The work runs on the device of
``diag`` (or of the dense matrix); the convergence test reads one number
back per iteration.
"""
from __future__ import annotations

import torch

from .linalg import as_tensor


def _as_matvec(A):
    if callable(A):
        return A
    return lambda x: A @ x


def davidson(A, neigen, diag=None, tol=1e-8, maxiter=200, max_space=None,
             v0=None, jacobi=False):
    """Lowest ``neigen`` eigenpairs of a Hermitian operator.

    Parameters
    ----------
    A : (n, n) tensor or array, or a matvec callable x (n, k) -> (n, k)
        on tensors.
    diag : (n,) diagonal of A (required when A is a callable; used for
        the Davidson preconditioner and the initial unit-vector guess);
        the iteration runs on its device.
    jacobi : use the Jacobi-Davidson correction (project the current Ritz
        vectors out of the corrections) (reference: pyqed/davidson.py:37
        ``jacobi_correction``).

    Returns tensors (eigenvalues (neigen,), eigenvectors (n, neigen)).
    """
    if not callable(A):
        A = as_tensor(A)
    mv = _as_matvec(A)
    if diag is None:
        if callable(A):
            raise ValueError("matrix-free davidson needs diag=")
        diag = torch.diagonal(A)
    diag = as_tensor(diag)
    n = diag.shape[0]
    k = int(neigen)
    if max_space is None:
        max_space = min(n, max(6 * k, 24))

    if v0 is None:
        # unit vectors on the smallest diagonal entries
        idx = torch.argsort(diag)[:k]
        V = torch.zeros((n, k), dtype=diag.dtype, device=diag.device)
        V[idx, torch.arange(k, device=diag.device)] = 1.0
    else:
        V, _ = torch.linalg.qr(as_tensor(v0, device=diag.device))

    def rayleigh_ritz(V, AV):
        Hs = V.mH @ AV
        return torch.linalg.eigh(0.5 * (Hs + Hs.mH))

    AV = mv(V)
    for _ in range(maxiter):
        w, s = rayleigh_ritz(V, AV)
        theta = w[:k]
        X = V @ s[:, :k]          # Ritz vectors
        AX = AV @ s[:, :k]
        R = AX - X * theta[None, :]
        if bool(torch.linalg.vector_norm(R, dim=0).max() < tol):
            return theta, X
        # preconditioned correction vectors
        denom = diag[:, None] - theta[None, :]
        denom = torch.where(denom.abs() < 1e-8,
                            torch.sign(denom) * 1e-8 + (denom == 0) * 1e-8,
                            denom)
        T = R / denom
        if jacobi:
            T = T - X @ (X.mH @ T)
        # expand, re-orthonormalise the whole space with one QR
        V, _ = torch.linalg.qr(torch.cat([V, T], dim=1))
        if V.shape[1] > max_space:
            # restart from the current Ritz vectors and fresh corrections
            V, _ = torch.linalg.qr(torch.cat([X, T], dim=1))
        AV = mv(V)
    return theta, X


def block_davidson(A, neig=3, diag=None, tol=1e-9, max_iterations=60,
                   **kwargs):
    """Reference-named alias (pyqed/davidson.py:155) of :func:`davidson`."""
    return davidson(A, neig, diag=diag, tol=tol, maxiter=max_iterations,
                    **kwargs)

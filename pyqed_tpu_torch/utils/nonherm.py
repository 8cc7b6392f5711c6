"""Non-Hermitian eigen-decompositions and representations.

Counterpart of ``pyqed_tpu/utils/nonherm.py``. The non-Hermitian ``eig``
runs on the host (SciPy LAPACK), as in the JAX package, and comes back as
tensors on ``device``; Hermitian stacks use the batched ``eigh`` on the
device; the absorption sum is a device contraction.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from ..ops.linalg import as_tensor


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def eig(a, norm=False):
    """Biorthogonal eigen-decomposition A R_n = E_n R_n with L_m R_n =
    delta_mn via inversion, sorted by the real part. Returns (evals, U1,
    U2) with U2 = U1^{-1} (rows are left eigenvectors), and the
    biorthogonal norms with ``norm``; tensors on a's device (the CPU for
    an array)."""
    device = a.device if isinstance(a, torch.Tensor) else "cpu"
    evals, U1 = scipy.linalg.eig(_host(a))
    idx = np.argsort(evals.real)
    evals, U1 = evals[idx], U1[:, idx]
    U2 = scipy.linalg.inv(U1)
    out = [evals, U1, U2]
    if norm:
        out.append(np.einsum("na, an -> n", U2, U1))
    return tuple(torch.as_tensor(x, device=device) for x in out)


def diabatic_to_adiabatic(v, ndim=1):
    """Pointwise diagonalization of a (possibly complex-symmetric)
    diabatic potential matrix stack v (..., ns, ns). Returns (apes (...,
    ns), U (..., ns, ns)), on v's device (the CPU for an array):
    Hermitian input by a batched ``eigh`` there, other input by host
    ``eig`` per point sorted by the real part."""
    device = v.device if isinstance(v, torch.Tensor) else "cpu"
    v = _host(v)
    shape = v.shape[:-2]
    ns = v.shape[-1]
    vflat = v.reshape(-1, ns, ns)
    if np.allclose(vflat, np.conj(np.swapaxes(vflat, -1, -2))):
        w, u = torch.linalg.eigh(torch.as_tensor(vflat, device=device))
        return w.reshape(shape + (ns,)), u.reshape(shape + (ns, ns))
    ws, us = [], []
    for m in vflat:
        w, u = scipy.linalg.eig(m)
        idx = np.argsort(w.real)
        ws.append(w[idx])
        us.append(u[:, idx])
    return (torch.as_tensor(np.array(ws), device=device).reshape(
        shape + (ns,)),
        torch.as_tensor(np.array(us), device=device).reshape(
            shape + (ns, ns)))


def linear_absorption(omegas, mol=None, evals=None, dip=None,
                      psi0_weight=None):
    """Absorption from a non-Hermitian Hamiltonian's complex eigenvalues,
    S(w) = -Im sum_n |mu_n0|^2 / (w - E_n), Im E_n < 0; with ``mol`` its
    ``get_nonhermH()`` and ``edip_rms`` give the eigenvalues and the
    biorthogonal transition moments."""
    if mol is not None:
        evals, U1, U2 = eig(mol.get_nonhermH())
        mu = as_tensor(mol.edip_rms).to(U1.dtype)
        dip = torch.einsum("a, an -> n", mu[0, :], U1) \
            * torch.einsum("na, a -> n", U2, mu[:, 0])
    evals = as_tensor(evals)
    omegas = as_tensor(omegas).to(evals.device)
    amp = as_tensor(dip).to(evals.device)
    denom = omegas[:, None] - evals[None, :]
    return -torch.imag(torch.sum(amp[None, :] / denom, dim=1))

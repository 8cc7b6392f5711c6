"""Bosonic numerical renormalization group for spin-boson models
(PyTorch).

PyTorch counterpart of ``pyqed_tpu/open/nrg.py`` (reference: pyqed/nrg.py
— ``SBM:64``, ``NRG:194`` with logarithmic discretisation and the Lanczos
chain mapping ``discretize:225``). The Wilson chain is built on the host
in NumPy; the iterative diagonalisation keeps the lowest ``nkeep`` states
per shell, one dense ``eigh`` per shell on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor, dag
from ..ops.operators import boson, destroy, pauli


class SBM:
    """Spin-boson model container (reference: pyqed/nrg.py:64)."""

    def __init__(self, epsilon, Delta, omegac=1.0):
        self.omegac = omegac
        I, X, Y, Z = pauli()
        self.H = 0.5 * (-epsilon * Z + Delta * X)

    def spectral_density(self, omega, s=1.0, alpha=1.0):
        """Power-law J(w) = 2 pi alpha w_c^{1-s} w^s, w < w_c."""
        omega = as_tensor(omega)
        return torch.where(omega < self.omegac,
                           2 * np.pi * alpha * self.omegac ** (1 - s)
                           * omega**s, 0.0)


class NRG:
    """(reference: pyqed/nrg.py:194). ``device``: the card when None
    (raises without one), ``"cpu"`` on request."""

    def __init__(self, Himp, L=2.0, device=None):
        self.device = resolve_device(device)
        self.L = L
        self.H = as_tensor(Himp, device=self.device).to(torch.complex128)
        self.nmodes = None
        self.eta0 = None

    def discretize(self, N, s=1.0, omegac=1.0, alpha=1.0):
        """Logarithmic discretisation + Lanczos tridiagonalisation to the
        Wilson chain (reference: pyqed/nrg.py:225, after PRB 71, 045122).
        Returns (epsilon_n onsite, t_n hopping) as NumPy arrays."""
        n = np.arange(N)
        L = self.L
        xi = ((s + 1) / (s + 2) * (1.0 - L ** (-s - 2))
              / (1.0 - L ** (-s - 1)) * omegac * L ** (-n))
        g2 = (2 * np.pi * alpha / (s + 1) * omegac**2
              * (1 - L ** (-s - 1)) * L ** (-n * (s + 1)))
        eta0 = np.sum(g2)
        self.eta0 = eta0
        self.nmodes = N

        U = np.zeros((N, N))
        U[0, :] = np.sqrt(g2) / np.sqrt(eta0)
        t = np.zeros(N)
        eps = np.zeros(N)
        eps[0] = np.sum(U[0] ** 2 * xi)
        t[0] = np.sqrt(np.sum((xi - eps[0]) ** 2 * g2) / eta0)
        U[1] = (xi - eps[0]) * U[0] / t[0]
        for m in range(1, N - 1):
            eps[m] = np.sum(U[m] ** 2 * xi)
            t[m] = np.sqrt(np.sum(((xi - eps[m]) * U[m]
                                   - t[m - 1] * U[m - 1]) ** 2))
            U[m + 1] = ((xi - eps[m]) * U[m] - t[m - 1] * U[m - 1]) / t[m]
        eps[N - 1] = np.sum(U[N - 1] ** 2 * xi)
        self.eps_chain = eps
        self.t_chain = t
        return eps, t

    def run(self, N=10, nz=8, nkeep=64, s=1.0, omegac=1.0, alpha=0.1):
        """Iterative NRG: add Wilson-chain boson sites one at a time,
        rescale, keep the lowest ``nkeep`` states (completing the
        reference's truncated ``run``, pyqed/nrg.py:296). Returns the flow
        of the lowest six rescaled energies per shell (NumPy arrays);
        ``energies`` keeps the last shell's kept spectrum."""
        dev = self.device
        c128 = torch.complex128
        I, X, Y, Z = (p.to(dev) for p in pauli())
        eps, t = self.discretize(N, s=s, omegac=omegac, alpha=alpha)
        a = destroy(nz).to(dev)
        ad = dag(a)
        eye_z = torch.eye(nz, dtype=c128, device=dev)

        # impurity + site 0
        H = (torch.kron(self.H, eye_z)
             + torch.kron(I, boson(eps[0], nz).to(dev))
             + np.sqrt(self.eta0 / np.pi) * torch.kron(Z / 2, a + ad))
        w, v = torch.linalg.eigh(H)
        nk = min(nkeep, H.shape[0])
        w, v = w[:nk], v[:, :nk]
        # chain operator b_0 in the kept basis
        bn = v.mH @ torch.kron(torch.eye(2, dtype=c128, device=dev), a) @ v

        flow = [(w[:6] - w[0]).cpu().numpy()]
        for m in range(1, N):
            dim = w.shape[0]
            Hnew = (torch.kron(torch.diag(w.to(c128)), eye_z)
                    + torch.kron(torch.eye(dim, dtype=c128, device=dev),
                                 boson(eps[m], nz).to(dev))
                    + t[m - 1] * (torch.kron(bn, ad)
                                  + torch.kron(dag(bn), a)))
            w2, v2 = torch.linalg.eigh(Hnew)
            nk = min(nkeep, Hnew.shape[0])
            w, v2 = w2[:nk], v2[:, :nk]
            bn = v2.mH @ torch.kron(torch.eye(dim, dtype=c128, device=dev),
                                    a) @ v2
            flow.append(((w[:6] - w[0]) * self.L ** (m / 2)).cpu().numpy())
        self.flow = flow
        self.energies = w
        return flow

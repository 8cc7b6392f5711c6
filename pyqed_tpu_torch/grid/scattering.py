"""Lippmann-Schwinger scattering solvers (PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/scattering.py`` (reference:
pyqed/LippmanSchwinger.py ``LippmannSchwingerSolver:44`` 1D,
``LippmannSchwinger2DSolver:85``). The integral equation
psi = phi + G0 V psi becomes a dense linear system; a scan over k is one
batched ``torch.linalg.solve`` on ``device`` (the card when None; raises
without one). The 2D Green's function needs the Hankel function, which
torch lacks: it is tabulated on the host with SciPy, then the system is
solved on the device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import resolve_device


class LippmannSchwingerSolver:
    """1D scattering from a localized potential
    (reference: pyqed/LippmanSchwinger.py:44)."""

    def __init__(self, a, b, n, V: Callable, device=None):
        self.device = resolve_device(device)
        self.a, self.b, self.n = a, b, n
        self.V = V
        self.x = np.linspace(a, b, n + 1)
        self.h = self.x[1] - self.x[0]

    def run(self, k_vec, mass=1.0):
        """Solve (I - h G0 V) psi = e^{ikx} for every k in one batched
        solve. ``V`` is evaluated on the NumPy grid.

        Returns tensors (psi (nk, n+1), transmission |psi(b)|)."""
        dev = self.device
        x = torch.as_tensor(self.x, device=dev)
        Vx = torch.as_tensor(np.asarray(self.V(self.x)),
                             device=dev).to(torch.complex128)
        k = torch.as_tensor(np.atleast_1d(np.asarray(k_vec, float)),
                            device=dev).to(torch.complex128)[:, None, None]
        dist = (x[None, :] - x[:, None]).abs()       # |x_i - x_j|
        # retarded Green's function G0(x, x') = -i m/k e^{ik|x-x'|}; the
        # kernel is (G * V[:, None])^T, V on the column's point
        G = -1j * mass / k * torch.exp(1j * k * dist)
        A = (torch.eye(len(self.x), dtype=torch.complex128, device=dev)
             - self.h * G * Vx[None, None, :])
        phi = torch.exp(1j * k[:, :, 0] * x[None, :])
        psi = torch.linalg.solve(A, phi)
        return psi, psi[:, -1].abs()


class LippmannSchwinger2DSolver:
    """2D scattering (reference: pyqed/LippmanSchwinger.py:85):
    G0 = -(i/4) H0^(1)(k|r - r'|), tabulated on the host (SciPy), the
    dense solve on ``device`` (the card when None)."""

    def __init__(self, x, y, V: Callable, device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.V = V
        X, Y = np.meshgrid(self.x, self.y, indexing="ij")
        self.X, self.Y = X, Y
        self.coords = np.stack([X.ravel(), Y.ravel()], axis=1)
        self.h = (self.x[1] - self.x[0]) * (self.y[1] - self.y[0])

    def run(self, k, angle=0.0):
        import scipy.spatial
        import scipy.special
        eps = 1e-4
        S = scipy.spatial.distance.cdist(self.coords, self.coords + eps)
        G = -0.25j * scipy.special.hankel1(0, k * S)
        Vg = np.ravel(self.V(self.X + eps, self.Y + eps))
        A = np.eye(len(Vg)) + self.h * G * Vg[None, :]
        kvec = k * np.array([np.cos(angle), np.sin(angle)])
        phi = np.exp(1j * (self.coords @ kvec))
        dev = self.device
        psi = torch.linalg.solve(torch.as_tensor(A, device=dev),
                                 torch.as_tensor(phi, device=dev))
        return psi.reshape(self.X.shape)

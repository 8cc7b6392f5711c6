"""Thermal rate constants from flux-side correlation functions (PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/rate.py`` (reference:
pyqed/ldr/rate.py — ``flux:45``, ``boltzmann:74``; its ``Rate.run`` is a
stub). Miller-Schwartz-Tromp:

    k(T) Q_r(T) = lim_{t→∞} C_fs(t),
    C_fs(t) = Tr[ F̄  U†(t) h U(t) ],   F̄ = e^{−βH/2} F e^{−βH/2},
    F = i [H, h(x − x‡)]

from one eigendecomposition of H on the device and one batched product
over all requested times.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor


def heaviside_projector(x, x_div=0.0, device=None):
    """diag(x >= x_div) as a float64 tensor on ``device`` (the card when
    None, raises without one)."""
    x = as_tensor(x, device=resolve_device(device))
    return torch.diag((x >= x_div).to(torch.float64))


def flux_operator(H, x, x_div=0.0, device=None):
    """F = i [H, h] (reference rate.py:45 leaves out the i; with it F is
    Hermitian), on ``device``."""
    dev = resolve_device(device)
    h = heaviside_projector(x, x_div, device=dev)
    H = as_tensor(H, device=dev)
    return 1j * (H @ h - h @ H)


class RateFluxSide:
    """Flux-side rate for a 1D (or pre-flattened) Hamiltonian on a grid.

    H : (n, n) DVR Hamiltonian (e.g. SineDVR.t() + diag(V)); x : grid
    points (for the dividing surface); ``device``: the card when None
    (raises without one), ``"cpu"`` on request."""

    def __init__(self, H, x, x_div=0.0, device=None):
        self.device = resolve_device(device)
        self.H = as_tensor(H, device=self.device)
        self.x = as_tensor(x, device=self.device)
        self.x_div = x_div
        self.w, self.U = torch.linalg.eigh(self.H)

    def cfs(self, beta, times):
        """C_fs(t) at each of ``times``, (ntimes,) float64 on the device:
        Re Σ_ij F̄_ij e^{iw_j t} h_ji e^{-iw_i t}."""
        w, U = self.w, self.U
        h = heaviside_projector(self.x, self.x_div, device=self.device)
        F = flux_operator(self.H, self.x, self.x_div, device=self.device)
        Uc = U.to(torch.complex128)
        Fe = Uc.mH @ F.to(torch.complex128) @ Uc
        he = Uc.mH @ h.to(torch.complex128) @ Uc
        bolt = torch.exp(-0.5 * beta * w)
        Fbar = bolt[:, None] * Fe * bolt[None, :]
        G = Fbar * he.T                       # G_ij = F̄_ij h_ji
        t = as_tensor(times, device=self.device).to(torch.float64)
        ph = torch.exp(1j * t[:, None] * w[None, :])          # (nt, n)
        return ((ph.conj() @ G) * ph).sum(dim=1).real

    def reactant_partition(self, beta):
        """Q_r = Tr[e^{−βH} h(x‡ − x)] (reactant side)."""
        hr = torch.diag((self.x < self.x_div).to(torch.float64))
        he = self.U.mH @ hr.to(self.U.dtype) @ self.U
        return (torch.exp(-beta * self.w) * torch.diagonal(he)).sum().real

    def rate(self, beta, t_plateau, ntimes=200):
        """k(T) from the plateau of C_fs (the mean over the last third of
        the time window). Returns (k, times, C_fs) with NumPy arrays."""
        times = np.linspace(0.0, t_plateau, ntimes)
        c = self.cfs(beta, times).cpu().numpy()
        plateau = float(np.mean(c[2 * ntimes // 3:]))
        Qr = float(self.reactant_partition(beta))
        return plateau / Qr, times, c


class NonadiabaticRate(RateFluxSide):
    """Flux-side thermal rate on an LDR Hamiltonian (reference:
    pyqed/ldr/rate.py:22, an empty shell there): :class:`RateFluxSide`
    with H = ldr.buildH() on the multi-state grid, on the LDR's device.
    The dividing surface lies on the first nuclear coordinate, tiled over
    the electronic states."""

    def __init__(self, ldr, x_div=0.0):
        H = ldr.buildH()
        x = np.repeat(np.asarray(ldr.x[0]), ldr.nstates)
        super().__init__(H, x, x_div=x_div, device=ldr.device)
        self.ldr = ldr


Rate = RateFluxSide         # reference drop-in name (pyqed/ldr/rate.py)

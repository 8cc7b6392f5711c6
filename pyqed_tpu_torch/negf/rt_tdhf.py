"""Real-time TDHF: self-consistent Fock propagation of the 1-RDM.

PyTorch counterpart of ``pyqed_tpu/negf/rt_tdhf.py`` (reference:
pyqed/gw/rt_tdhf.py:68 ``TDHF`` — an empty class; the HF self-energy
helper is rt_tdhf.py:40 ``self_energy_hf``). Equation of motion in the
orthonormal MO basis of the converged ground state:

    i dP/dt = [F(P) + E(t)·mu, P],
    F(P) = h + J(P) − K(P)/2          (closed shell, Tr P = N)

propagated with RK4 as a loop of device operations on the mean field's
device (the JAX package runs one jitted ``lax.scan``); the induced
dipole of every step stays on the device until the run ends. The
delta-kick absorption spectrum is the FT of the induced dipole, whose
peaks reproduce the linear-response TDHF excitation energies.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

C128 = torch.complex128


class RTTDHF:
    """Real-time TDHF on a converged qchem RHF mean field (on its
    device)."""

    def __init__(self, mf, pulse: Optional[Callable] = None):
        self.mf = mf
        self.pulse = pulse
        hmo, eri_mo = mf.mo_ints()
        self.h = hmo.to(C128)
        self.eri = eri_mo.to(C128)
        n = self.h.shape[0]
        self.nocc = mf.nocc
        # J_pq = (pq|sr) P_sr ; K_pq = (pr|qs) P_rs — the exchange
        # contracts P (NOT P^T): it is what makes the linearized RT
        # frequencies equal the RPA ones
        self._Jm = self.eri.reshape(n * n, n * n)
        self._Km = self.eri.permute(0, 2, 1, 3).reshape(n * n, n * n)
        # MO dipole (z component by default)
        D = mf.dipole_integrals()
        C = mf.mo_coeff
        self.mu = (C.T @ D[2] @ C).to(C128)
        self.P0 = torch.zeros((n, n), dtype=C128, device=self.h.device)
        k = torch.arange(self.nocc, device=self.h.device)
        self.P0[k, k] = 2.0

    def fock(self, P):
        n = P.shape[0]
        J = (self._Jm @ P.transpose(0, 1).reshape(-1)).reshape(n, n)
        K = (self._Km @ P.reshape(-1)).reshape(n, n)
        return self.h + J - 0.5 * K

    def run(self, dt, nt, efield: Optional[Callable] = None, kick=0.0):
        """Propagate; returns (times, dipole(t)) as NumPy (the dipole after
        each of the ``nt`` steps). ``efield``: t (float) -> float.

        kick != 0 applies a delta kick e^{-i kick mu} to P at t=0 (the
        standard linear-response absorption protocol)."""
        mu = self.mu
        P = self.P0
        if kick:
            w, V = torch.linalg.eigh(mu)
            U = (V * torch.exp(-1j * kick * w)) @ V.conj().T
            P = U @ P @ U.conj().T
        efield = efield or (self.pulse.efield if self.pulse is not None
                            else (lambda t: 0.0))

        def rhs(P, t):
            F = self.fock(P)
            e = float(efield(t))
            if e != 0.0:
                F = F + e * mu
            return -1j * (F @ P - P @ F)

        dip = torch.empty(nt, dtype=torch.float64, device=P.device)
        for k in range(nt):
            t = k * dt
            k1 = rhs(P, t)
            k2 = rhs(P + k1 * (dt / 2), t + dt / 2)
            k3 = rhs(P + k2 * (dt / 2), t + dt / 2)
            k4 = rhs(P + k3 * dt, t + dt)
            P = P + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
            dip[k] = torch.real(torch.sum(mu.T * P))
        self.P = P
        return np.arange(nt) * dt, dip.cpu().numpy()

    def absorption(self, dt, nt, kick=1e-3, damp=5e-3):
        """Delta-kick absorption: S(w) ∝ w·Im[d(w)] / kick (host FFT of
        the dipole trace)."""
        ts, dip = self.run(dt, nt, kick=kick)
        d = (dip - dip[0]) * np.exp(-damp * ts)
        freqs = np.fft.rfftfreq(nt, dt) * 2 * np.pi
        dw = np.fft.rfft(d) * dt
        S = freqs * np.imag(dw) / kick
        return freqs, S

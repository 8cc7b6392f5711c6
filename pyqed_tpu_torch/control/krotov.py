"""Krotov's method for quantum optimal control (PyTorch).

Counterpart of ``pyqed_tpu/control/krotov.py`` (no counterpart in the
reference). Unlike GRAPE's concurrent gradient step, Krotov's method
[Reich, Ndong & Koch, JCP 136, 104103 (2012)] updates the pulse
sequentially in time inside one forward sweep, with the costate from a
backward sweep of the previous iteration:

    du(t) = S(t)/lambda * Im < chi(t) | dH/du | psi(t) >

with psi propagated under the already-updated pulse, which makes the
fidelity monotonically non-decreasing for any lambda > 0 (first-order
Krotov with J_T = 1 - |<tgt|psi(T)>|^2). No autograd: the update is in
closed form. The frozen pulse's propagators are one batched
``matrix_exp``; the sweeps are loops of small products on the device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import default_complex, default_real, resolve_device
from ..ops.linalg import as_tensor

__all__ = ["Krotov"]


class Krotov:
    """First-order Krotov state-transfer optimization.

    H(t) = H0 + sum_j u_j(t) Hc_j, piecewise constant on n_steps slices.
    ``lam`` is the Krotov step-size parameter (larger = smaller, safer
    updates); ``shape`` an optional (n_steps,) update-shape function S(t)
    in [0, 1] (default: a sin^2 ramp keeping the pulse ends pinned).
    ``device``: the card when None (raises without one).
    """

    def __init__(self, H0, Hc: Sequence, dt: float, n_steps: int,
                 lam: float = 1.0, shape=None, device=None):
        self.device = resolve_device(device)
        cdt = default_complex()
        self.H0 = as_tensor(H0, cdt, self.device)
        self.Hc = torch.stack([as_tensor(h, cdt, self.device) for h in Hc])
        self.dt = float(dt)
        self.n_steps = int(n_steps)
        self.lam = float(lam)
        if shape is None:
            tmid = (np.arange(n_steps) + 0.5) / n_steps
            shape = np.sin(np.pi * tmid) ** 2
        self.shape = as_tensor(shape, default_real(), self.device)

    def _props(self, u):
        """exp(-i (H0 + u_k . Hc) dt) for every slice k of u (n, n_ctrl)
        (or one slice, u (n_ctrl,))."""
        H = self.H0 + torch.einsum("...j, jab -> ...ab",
                                   u.to(self.Hc.dtype), self.Hc)
        return torch.linalg.matrix_exp(-1j * H * self.dt)

    def _normalized(self, psi):
        psi = as_tensor(psi, default_complex(), self.device)
        return psi / torch.linalg.vector_norm(psi)

    def fidelity(self, u, psi0, target):
        """|<target|psi(T)>|^2 under the pulse u, both states normalized
        as in optimize_state_transfer."""
        psi = self._normalized(psi0)
        for U in self._props(as_tensor(u, default_real(), self.device)):
            psi = U @ psi
        return torch.abs(torch.vdot(self._normalized(target), psi)) ** 2

    def _iteration(self, u, psi0, target):
        """One Krotov iteration: the backward costate sweep under the
        frozen pulse (whose propagators also give psi(T)), then the
        sequential forward update sweep. Returns (u_new,
        fidelity(u_new))."""
        Us = self._props(u)
        psiT = psi0
        for U in Us:
            psiT = U @ psiT
        chi = torch.vdot(target, psiT) * target          # dJ/d<psi(T)|
        chis = [None] * self.n_steps
        for k in range(self.n_steps - 1, -1, -1):
            chi = Us[k].mH @ chi
            chis[k] = chi
        psi = psi0
        u_new = torch.empty_like(u)
        for k in range(self.n_steps):
            # du_j = S/lam * Im <chi | Hc_j | psi>
            du = (self.shape[k] / self.lam) * torch.imag(torch.einsum(
                "i, jik, k -> j", chis[k].conj(), self.Hc, psi))
            u_new[k] = u[k] + du
            psi = self._props(u_new[k]) @ psi
        return u_new, torch.abs(torch.vdot(target, psi)) ** 2

    def optimize_state_transfer(self, psi0, target, u0=None,
                                iters: int = 50):
        """Returns (u_opt, fidelities), the fidelities monotone
        non-decreasing in ``iters`` (the first-order Krotov guarantee)."""
        psi0 = self._normalized(psi0)
        target = self._normalized(target)
        if u0 is None:
            u0 = 1e-2 * np.ones((self.n_steps, self.Hc.shape[0]))
        u = as_tensor(u0, default_real(), self.device)
        fids = []
        for _ in range(iters):
            u, fid = self._iteration(u, psi0, target)
            fids.append(fid)
        return u, torch.stack(fids)

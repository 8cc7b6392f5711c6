"""Light-driven free (or harmonically confined) electron trajectories
(PyTorch).

Counterpart of ``pyqed_tpu/floquet/free_electron.py`` (reference:
pyqed/floquet/free_electron.py:18-74). The classical equations of motion

    dq/dt = p/m,   dp/dt = -e E(t) - m w0^2 q

are integrated with a fixed-step RK4, batched over carrier-envelope
phases: a CEP scan is one (B, 3) state on ``device`` (the card when
None). For the truly free electron (w0 = 0) the quiver solution is
analytic.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device


def efield(t, E0=1.0, omega=1.0, cep=0.0, polarization="circular"):
    """Field E(t), (..., 3): circular (cos ex - sin ey) or linear x. ``t``
    and ``cep`` are tensors or numbers; with tensors the field is on their
    device."""
    ph = torch.as_tensor(omega * t + cep)
    zero = torch.zeros_like(ph)
    if polarization == "circular":
        return E0 * torch.stack([torch.cos(ph), -torch.sin(ph), zero], dim=-1)
    return E0 * torch.stack([torch.cos(ph), zero, zero], dim=-1)


def _trajectories(ceps, tf, nt, q0, p0, E0, omega, omega0, mass, charge,
                  polarization):
    """RK4 of B trajectories, one per CEP in ``ceps`` (B,): (t, q, p) with
    q, p (B, nt+1, 3) on the device of ``ceps``."""
    dt = tf / nt
    dev = ceps.device
    B = ceps.shape[0]
    q = torch.as_tensor(np.asarray(q0, float), device=dev).expand(B, 3)
    p = torch.as_tensor(np.asarray(p0, float), device=dev).expand(B, 3)
    qs = torch.empty((B, nt + 1, 3), dtype=torch.float64, device=dev)
    ps = torch.empty_like(qs)
    qs[:, 0], ps[:, 0] = q, p

    def rhs(t, q, p):
        f = (-charge * efield(t, E0, omega, ceps, polarization)
             - mass * omega0 ** 2 * q)
        return p / mass, f

    t = 0.0
    for k in range(nt):
        k1q, k1p = rhs(t, q, p)
        k2q, k2p = rhs(t + dt / 2, q + dt / 2 * k1q, p + dt / 2 * k1p)
        k3q, k3p = rhs(t + dt / 2, q + dt / 2 * k2q, p + dt / 2 * k2p)
        k4q, k4p = rhs(t + dt, q + dt * k3q, p + dt * k3p)
        q = q + dt / 6 * (k1q + 2 * k2q + 2 * k3q + k4q)
        p = p + dt / 6 * (k1p + 2 * k2p + 2 * k3p + k4p)
        t = t + dt
        qs[:, k + 1], ps[:, k + 1] = q, p
    times = torch.arange(nt + 1, dtype=torch.float64, device=dev) * dt
    return times, qs, ps


def light_driven_free_electron(tf=100.0, nt=2000, q0=(0.4, 0.0, 0.0),
                               p0=(0.0, 0.0, 0.0), E0=1.0, omega=1.0,
                               cep=0.0, omega0=0.0, mass=1.0, charge=1.0,
                               polarization="circular", device=None):
    """Propagate q(t), p(t) on ``device`` (the card when None); returns
    (t (nt+1,), q (nt+1, 3), p (nt+1, 3)). omega0: harmonic confinement
    frequency (0 = free electron)."""
    ceps = torch.tensor([float(cep)], dtype=torch.float64,
                        device=resolve_device(device))
    t, q, p = _trajectories(ceps, tf, nt, q0, p0, E0, omega, omega0, mass,
                            charge, polarization)
    return t, q[0], p[0]


def cep_scan(ceps, tf=100.0, nt=2000, q0=(0.4, 0.0, 0.0),
             p0=(0.0, 0.0, 0.0), E0=1.0, omega=1.0, omega0=0.0, mass=1.0,
             charge=1.0, polarization="circular", device=None):
    """The trajectory for each carrier-envelope phase in ``ceps``, all in
    one batched RK4: (t, q, p), each (B, nt+1, ...) as the JAX package's
    vmap returns them."""
    ceps = torch.as_tensor(np.asarray(ceps, float),
                           device=resolve_device(device))
    t, q, p = _trajectories(ceps, tf, nt, q0, p0, E0, omega, omega0, mass,
                            charge, polarization)
    return t.expand(len(ceps), -1), q, p

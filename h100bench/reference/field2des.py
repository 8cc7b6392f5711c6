"""Explicit-field rephasing 2DES with phase cycling, written from its
definition.

Three Gaussian pulses E_k(t) = A_k exp(-(t - t_k)^2 / (2 sigma^2))
cos(omega (t - t_k) + phi_k) drive the hierarchy through H + E(t) mu.
The first pulse is centred ``pad`` (4 sigma by default) after t = 0 at
the largest t1; pulse 3 comes t1_max + t2 after that, pulse 2 t2 before
pulse 3 and pulse 1 t1 before pulse 2, so detection starts at the same
time for every t1: at t_det = pad + t1_max + t2 + pad, after
round(t_det / dt) RK4 steps of dt; P(t) = tr(mu rho(t)) is read after
each of the next nt3 steps. Pulses 1 and 2 carry the phases
phi1 = 2 pi a / N1, phi2 = 2 pi b / N2 (pulse 3: 0), and the rephasing
signal is the (-1, +1) phase component,
P3(t1, t3) = (1 / N1 N2) sum_ab exp(i phi1_a) exp(-i phi2_b) P_ab.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .heom import REAL


def schedule(t1s, t2, nt3, dt, width, pad=None):
    """(tc2, tc3, first, nt_total): the centres of pulses 2 and 3, the
    step after which detection starts and the number of RK4 steps."""
    pad = 4.0 * width if pad is None else pad
    t1_max = float(np.max(t1s))
    tc3 = pad + t1_max + t2
    nt_total = int(round((tc3 + pad) / dt)) + nt3
    return tc3 - t2, tc3, nt_total - nt3, nt_total


def rephasing_rows(heom, rho0, mu, t1s, rows, t2, nt3, dt, width, amps,
                   omega, n_phase=(4, 4), pad=None):
    """P3[rows, :] ((len(rows), nt3) complex) of the map over the delays
    ``t1s``, propagated by ``heom`` (a :class:`~.heom.PlainHEOM`): the
    N1 x N2 phase pairs of each requested t1 as one batch."""
    N1, N2 = n_phase
    dev, rdt = heom.device, REAL[heom.dtype]
    tc2, tc3, first, nt_total = schedule(t1s, t2, nt3, dt, width, pad)
    t1s = np.asarray(t1s, dtype=float)
    a, b, r = np.meshgrid(np.arange(N1), np.arange(N2), np.asarray(rows),
                          indexing="ij")
    phi1 = torch.as_tensor(2 * math.pi * a.ravel() / N1, dtype=rdt,
                           device=dev)
    phi2 = torch.as_tensor(2 * math.pi * b.ravel() / N2, dtype=rdt,
                           device=dev)
    tc1 = torch.as_tensor(tc2 - t1s[r.ravel()], dtype=rdt, device=dev)

    def pulse(t, tc, phi, amp):
        return amp * torch.exp(
            -((t - tc) ** 2) / (2 * width ** 2)) * torch.cos(
            omega * (t - tc) + phi)

    def field(t):
        t = torch.tensor(t, dtype=rdt, device=dev)
        return (pulse(t, tc1, phi1, amps[0])
                + pulse(t, tc2, phi2, amps[1])
                + pulse(t, tc3, 0.0, amps[2]))

    B = phi1.shape[0]
    rho0 = torch.as_tensor(np.asarray(rho0)).to(dev, heom.dtype)
    mu_t = torch.as_tensor(np.asarray(mu)).to(dev, heom.dtype)
    y = heom.start(rho0.expand(B, -1, -1))
    P = torch.empty((nt3, B), dtype=heom.dtype, device=dev)
    for k in range(nt_total):
        fields = tuple(field(m * dt / 2) for m in (2 * k, 2 * k + 1,
                                                     2 * k + 2))
        y = heom.rk4(y, dt, fields, mu_t)
        if k >= first:
            P[k - first] = torch.einsum("ij, bji -> b", mu_t, y[0])
    P = P.T.reshape(N1, N2, len(rows), nt3)
    w1 = torch.exp(1j * torch.as_tensor(2 * math.pi * np.arange(N1) / N1))
    w2 = torch.exp(-1j * torch.as_tensor(2 * math.pi * np.arange(N2) / N2))
    return torch.einsum("a, b, abrt -> rt", w1.to(dev, heom.dtype),
                        w2.to(dev, heom.dtype), P) / (N1 * N2)

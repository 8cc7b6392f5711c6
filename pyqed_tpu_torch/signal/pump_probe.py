"""Pump-probe (transient absorption) and third-order susceptibility
(PyTorch).

PyTorch counterpart of ``pyqed_tpu/signal/pump_probe.py`` (reference:
pyqed/signal/sos.py:56 ``TransientAbsorption`` and ``_fft``:108;
pyqed/susceptibility.py — ``response1_freq``..``response4_freq`` and the
frequency-domain ``response*_fd``/``susceptibility``).

The JAX package ``vmap``s a driven RK4 scan over the probe delays. Here
the pump-only run and every delay form one (n, nd + 1) block of states:
one product with the stacked [H; mu] per RK4 stage, the fields of every
stage time and delay tabulated on the device beforehand (the port's
pulses take tensors), so no step calls the host.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor


# ====================================================== pump-probe (TA)

class TransientAbsorption:
    """Pump-probe transient absorption of an N-level system
    (reference: pyqed/signal/sos.py:56).

    mol : Mol-like (``H``, ``edip``); pump, probe : pulses whose
    ``efield`` takes tensors (the probe is evaluated at t - delay);
    delays : (nd,) probe delays; device : the card when None.
    """

    def __init__(self, mol, pump, probe, delays, device=None):
        self.device = resolve_device(device)
        self.mol = mol
        self.pump = pump
        self.probe = probe
        self.delays = as_tensor(delays, torch.float64, self.device)

    def run(self, dt, nt, freqs=None, t0=None, damp=1e-5):
        """Returns (freqs (nfreq,) NumPy, S (nfreq, ndelays) complex128
        tensor on the device): the dispersed pump-probe spectrum, the
        windowed Fourier transform about each probe arrival of the
        probe-induced polarization <mu>(t) - <mu>_pump-only(t)."""
        dev = self.device
        H = as_tensor(self.mol.H, device=dev).to(torch.complex128)
        mu = as_tensor(self.mol.edip, device=dev).to(torch.complex128)
        n = H.shape[0]
        w0, v0 = torch.linalg.eigh(H)
        pump, probe = self.pump, self.probe
        if t0 is None:
            t0 = -5.0 * pump.duration
        if freqs is None:
            freqs = np.linspace(0.0, 2.0 * float((w0 - w0[0]).max()), 200)
        freqs = np.asarray(freqs, dtype=float)
        delays = self.delays
        nd = delays.shape[0]
        times = t0 + dt * torch.arange(nt, dtype=torch.float64, device=dev)

        # fields at the three RK4 stage times of every step: (nt, 3, nd+1),
        # the last column the pump-only run
        ts = times[:, None] + torch.tensor([0.0, dt / 2, dt],
                                           dtype=torch.float64, device=dev)
        E = pump.efield(ts)[..., None] + torch.cat(
            [probe.efield(ts[..., None] - delays),
             torch.zeros_like(ts)[..., None]], dim=-1)
        E = E.to(torch.complex128)
        HM = torch.cat([H, mu])                        # (2n, n)

        def rhs(psi, e):
            P = HM @ psi
            return -1j * (P[:n] - P[n:] * e), P[n:]

        psi = v0[:, :1].expand(n, nd + 1).clone()
        pol = torch.empty((nt, nd + 1), dtype=torch.complex128, device=dev)
        for i in range(nt):
            k1, mpsi = rhs(psi, E[i, 0])
            if i > 0:                  # <psi|mu|psi> after step i - 1
                pol[i - 1] = (psi.conj() * mpsi).sum(0)
            k2, _ = rhs(psi + k1 * (dt / 2), E[i, 1])
            k3, _ = rhs(psi + k2 * (dt / 2), E[i, 1])
            k4, _ = rhs(psi + k3 * dt, E[i, 2])
            psi = psi + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
        pol[nt - 1] = (psi.conj() * (mu @ psi)).sum(0)

        dp = pol[:, :nd] - pol[:, nd:]                  # (nt, nd)
        # windowed FT about the probe arrival (reference _fft: sos.py:108):
        # S[f, j] = e^{-i f d_j} sum_t e^{i f t} e^{-damp (t - d_j)^2}
        #           dp[t, j] dt
        f = torch.as_tensor(freqs, device=dev)
        lag = times[:, None] - delays[None, :]
        W = torch.exp(-damp * lag ** 2) * dp
        S = (torch.exp(1j * f[:, None] * times[None, :]) @ W) * dt
        S = S * torch.exp(-1j * f[:, None] * delays[None, :])
        return freqs, S


# =============================================== third-order responses

def _tensors(device, *arrays):
    dev = resolve_device(device)
    return [as_tensor(a, device=dev).to(torch.complex128
                                        if torch.is_complex(as_tensor(a))
                                        else torch.float64)
            for a in arrays]


def _resp_core(en, dip, gamma, omega1, omega3, t2, kind, device=None):
    """R_k(w3, t2, w1) (nw3, nw1): the reference's triple state loops
    (susceptibility.py:20-60) as one einsum over (b, c, d) with broadcast
    (w1, w3) grids."""
    en, dip, gamma, w1, w3 = _tensors(device, en, dip, gamma, omega1, omega3)
    w1, w3 = w1.reshape(-1), w3.reshape(-1)
    dip = dip.to(torch.complex128)
    a = 0
    d4 = torch.einsum("b, bc, cd, d -> bcd", dip[a, :], dip, dip, dip[:, a])
    Ed = en[:, None] - en[None, :]
    gsum = 0.5 * (gamma[:, None] + gamma[None, :])

    def Gm(w):
        return 1.0 / (w[:, None, None] - Ed[None] + 1j * gsum[None])

    G3, G1 = Gm(w3), Gm(w1)
    U = torch.exp(-1j * Ed * t2 - gsum * t2)
    if kind == 1:       # G(d,c,w3) U(d,b,t2) G(d,a,w1)
        return torch.einsum("bcd, xdc, db, yd -> xy", d4, G3, U, G1[:, :, a])
    if kind == 2:       # G(d,c,w3) U(d,b,t2) G(a,b,w1)
        return torch.einsum("bcd, xdc, db, yb -> xy", d4, G3, U, G1[:, a, :])
    if kind == 3:       # G(d,c,w3) U(a,c,t2) G(a,b,w1)
        return torch.einsum("bcd, xdc, c, yb -> xy", d4, G3, U[a, :],
                            G1[:, a, :])
    if kind == 4:       # G(d,a,w3) U(c,a,t2) G(d,a,w1)
        return torch.einsum("bcd, xd, c, yd -> xy", d4, G3[:, :, a],
                            U[:, a], G1[:, :, a])
    raise ValueError(kind)


def response1_freq(en, dip, gamma, omega3, t2, omega1, device=None):
    """(reference: pyqed/susceptibility.py:28); on ``device``, the card
    when None."""
    return _resp_core(en, dip, gamma, omega1, omega3, t2, 1, device)


def response2_freq(en, dip, gamma, omega3, t2, omega1, device=None):
    """(reference: pyqed/susceptibility.py:37, where the loop restricts
    d >= c; the unrestricted sum is kept, as in the JAX package)."""
    return _resp_core(en, dip, gamma, omega1, omega3, t2, 2, device)


def response3_freq(en, dip, gamma, omega3, t2, omega1, device=None):
    """(reference: pyqed/susceptibility.py:46)."""
    return _resp_core(en, dip, gamma, omega1, omega3, t2, 3, device)


def response4_freq(en, dip, gamma, omega3, t2, omega1, device=None):
    """(reference: pyqed/susceptibility.py:56)."""
    return _resp_core(en, dip, gamma, omega1, omega3, t2, 4, device)


def chi1(en, dip, gamma, omega, device=None):
    """Linear susceptibility chi^(1)(w) of an N-level system in its
    ground state: sum_e |mu_ge|^2 [G_eg(w) - G_ge(w)], on ``device``."""
    en, dip, gamma, w = _tensors(device, en, dip, gamma, omega)
    w = w.reshape(-1)
    de = en - en[0]
    g = 0.5 * (gamma + gamma[0])
    mu2 = dip[0, :].abs() ** 2
    return (mu2[None, :] * (1.0 / (de[None, :] - w[:, None] - 1j * g[None, :])
                            + 1.0 / (de[None, :] + w[:, None]
                                     + 1j * g[None, :]))).sum(1)


def chi3(en, dip, gamma, omega3, t2, omega1, device=None):
    """Third-order susceptibility map: the sum of the four response
    pathways (reference: pyqed/susceptibility.py)."""
    return sum(fn(en, dip, gamma, omega3, t2, omega1, device=device)
               for fn in (response1_freq, response2_freq, response3_freq,
                          response4_freq))


# fully frequency-domain responses and the permutation-symmetrized
# chi^(3) (reference: pyqed/susceptibility.py:68-111 response*_fd /
# ``susceptibility``; the Mukamel sum is done in full, as in the JAX
# package)

def _resp_fd_core(en, dip, gamma, w123, w12, w1, kind, eps=1e-12,
                  device=None):
    """Frequency-domain pathway R_kind(w123, w12, w1) (numbers or
    broadcastable arrays); ``eps`` regularizes the population poles."""
    en, dip, gamma, w123, w12, w1 = _tensors(device, en, dip, gamma, w123,
                                             w12, w1)
    dip = dip.to(torch.complex128)
    a = 0
    d4 = torch.einsum("b, bc, cd, d -> bcd", dip[a, :], dip, dip, dip[:, a])
    Ed = en[:, None] - en[None, :]
    Gam = 0.5 * (gamma[:, None] + gamma[None, :]) + eps
    n = en.shape[0]
    idx = torch.arange(n, device=en.device)
    b, c, d = torch.meshgrid(idx, idx, idx, indexing="ij")

    def G(w, i, j):
        return 1.0 / (w[..., None, None, None] - Ed[i, j] + 1j * Gam[i, j])

    if kind == 1:
        val = G(w123, d, c) * G(w12, d, b) * G(w1, d, a)
    elif kind == 2:
        val = G(w123, d, c) * G(w12, d, b) * G(w1, a, b)
    elif kind == 3:
        val = G(w123, d, c) * G(w12, a, c) * G(w1, a, b)
    elif kind == 4:
        val = G(w123, d, a) * G(w12, c, a) * G(w1, d, a)
    else:
        raise ValueError(kind)
    return (d4 * val).sum(dim=(-3, -2, -1))


def response1_fd(en, dip, gamma, w123, w12, w1, device=None):
    return _resp_fd_core(en, dip, gamma, w123, w12, w1, 1, device=device)


def response2_fd(en, dip, gamma, w123, w12, w1, device=None):
    return _resp_fd_core(en, dip, gamma, w123, w12, w1, 2, device=device)


def response3_fd(en, dip, gamma, w123, w12, w1, device=None):
    return _resp_fd_core(en, dip, gamma, w123, w12, w1, 3, device=device)


def response4_fd(en, dip, gamma, w123, w12, w1, device=None):
    return _resp_fd_core(en, dip, gamma, w123, w12, w1, 4, device=device)


def susceptibility(en, dip, gamma, omega_in, device=None):
    """chi^(3)(-w_s; w1, w2, w3) of an N-level system, w_s = sum w_n, on
    ``device``: Mukamel's four Liouville pathways and their conjugates at
    negated frequencies, symmetrized over the 3! permutations of the
    input frequencies with the -1/3! prefactor."""
    if len(omega_in) != 3:
        raise ValueError("need exactly 3 incoming frequencies")
    chi = 0.0
    for (wa, wb, wc) in itertools.permutations(omega_in):
        w123, w12, w1 = wa + wb + wc, wa + wb, wa
        for kind in (1, 2, 3, 4):
            chi = chi + _resp_fd_core(en, dip, gamma, w123, w12, w1, kind,
                                      device=device)
            chi = chi + _resp_fd_core(en, dip, gamma, -w123, -w12, -w1,
                                      kind, device=device).conj()
    return -chi / 6.0

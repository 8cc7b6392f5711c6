"""Electron-phonon self-energies and spectral functions (Holstein).

PyTorch counterpart of ``pyqed_tpu/negf/eph.py`` (reference:
pyqed/gw/eph.py — ``gf0:49`` free-electron GF, ``gf0_ph:72`` free-phonon
GF, ``band:97``/``dispersion:102``, ``vertex:123``). The lowest-order
(Migdal/Fan) self-energy of a 1D tight-binding band coupled to an
Einstein phonon is one broadcast sum over (ω, k, q) on the device: the
device of a tensor argument, else ``device`` (the card when None).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device


def _t(x, device=None):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=float),
                           device=resolve_device(device))


def band(k, t=1.0, device=None):
    """1D tight-binding dispersion (reference: eph.py:97)."""
    return -2.0 * t * torch.cos(_t(k, device))


def gf0(omega, ek, eta=1e-3, device=None):
    """Free-electron retarded GF (reference: eph.py:49), broadcast over
    (omega, k)."""
    omega = _t(omega, device)
    ek = _t(ek, omega.device)
    return 1.0 / (omega[..., None] - ek[None, :] + 1j * eta)


def gf0_ph(omega, w0, eta=1e-3, device=None):
    """Free-phonon retarded GF D0(ω) = 2ω0/(ω² − ω0² + 2iηω0)
    (reference: eph.py:72)."""
    w = _t(omega, device)
    return 2.0 * w0 / (w ** 2 - w0 ** 2 + 2j * eta * w0)


def fan_migdal_sigma(omegas, ks, g, w0, t=1.0, nq=128, T=0.0,
                     mu=0.0, eta=1e-3, device=None):
    """Lowest-order Fan-Migdal self-energy of the Holstein model:

        Σ(k, ω) = (g²/N) Σ_q [ (n_B + 1 − f_{k−q}) / (ω − ε_{k−q} − ω0 + iη)
                             + (n_B + f_{k−q})     / (ω − ε_{k−q} + ω0 + iη) ]

    one broadcast sum over (ω, k, q); (omega, k) complex.
    """
    omegas = _t(omegas, device)
    dev = omegas.device
    ks = torch.atleast_1d(_t(ks, dev))
    qs = torch.linspace(-np.pi, np.pi, nq + 1, dtype=torch.float64,
                        device=dev)[:-1]
    ekq = band(ks[:, None] - qs[None, :], t)             # (k, q)
    if T > 0:
        f = 1.0 / (torch.exp((ekq - mu) / T) + 1.0)
        nb = 1.0 / (np.exp(w0 / T) - 1.0)
    else:
        f = (ekq < mu).to(torch.float64)
        nb = 0.0
    den_em = omegas[:, None, None] - ekq[None] - w0 + 1j * eta
    den_ab = omegas[:, None, None] - ekq[None] + w0 + 1j * eta
    return (g ** 2 / nq) * torch.sum(
        (nb + 1.0 - f)[None] / den_em + (nb + f)[None] / den_ab, dim=-1)


def spectral_function(omegas, ks, g, w0, t=1.0, mu=0.0, eta=5e-3,
                      device=None, **kw):
    """A(k, ω) = −Im G(k, ω)/π with the Migdal self-energy, (omega, k)."""
    omegas = _t(omegas, device)
    sig = fan_migdal_sigma(omegas, ks, g, w0, t=t, mu=mu, eta=eta, **kw)
    ek = band(torch.atleast_1d(_t(ks, omegas.device)), t)
    G = 1.0 / (omegas[:, None] - ek[None, :] - sig + 1j * eta)
    return -torch.imag(G) / np.pi

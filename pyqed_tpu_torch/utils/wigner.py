"""Wigner-Ville distributions, spectrograms and Wigner sampling
(PyTorch).

PyTorch counterpart of ``pyqed_tpu/utils/wigner.py`` (reference:
pyqed/wigner.py — ``spectrogram:152``, ``wigner:216``). The reference's
per-column loop and per-column FFT become one masked gather and one
batched FFT over all time columns.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor


def _wv_matrix(x):
    """Instantaneous autocorrelation K[tau_idx, t] = x(t+tau) x*(t-tau),
    zero outside the valid window."""
    N = x.shape[0]
    tausec = N // 2
    winlength = tausec - 1
    j = torch.arange(N, device=x.device)
    taumax = torch.minimum(torch.minimum(j, N - j - 1),
                           torch.full_like(j, winlength))
    tau = torch.arange(-tausec, tausec, device=x.device)
    TT, JJ = torch.meshgrid(tau, j, indexing="ij")
    valid = TT.abs() <= taumax[None, :]
    ip = torch.clamp(JJ + TT, 0, N - 1)
    im = torch.clamp(JJ - TT, 0, N - 1)
    K = torch.where(valid, x[ip] * x.conj()[im], 0.0)
    return K, tau


def wigner(x, d=1.0, device=None):
    """Wigner-Ville distribution W(w, t) of a 1D signal on ``device``
    (the card when None; reference: pyqed/wigner.py:216, whose layout is
    the transpose). Returns (W (N, N) complex tensor, freqs (N,) NumPy)."""
    x = as_tensor(x, device=resolve_device(device))
    x = x.to(torch.complex128 if x.dtype != torch.complex64
             else torch.complex64)
    K, tau = _wv_matrix(x)
    N = x.shape[0]
    g = torch.fft.fftshift(torch.fft.ifft(K, dim=0), dim=0) * (d * N)
    freq = 2.0 * np.pi * np.fft.fftshift(np.fft.fftfreq(N, d=d))
    phase = torch.exp(1j * torch.as_tensor(freq, device=x.device)
                      * (float(tau[0]) * d))
    return g * phase[:, None].to(g.dtype), freq / 2.0


def spectrogram(x, d=1.0, device=None):
    """Alias with the reference's (w, t) output (pyqed/wigner.py:152)."""
    return wigner(x, d, device=device)


def wvd(x, d=1.0, device=None):
    return wigner(x, d, device=device)


def wigner_sample_harmonic(key, n, omega, mass=1.0, beta=None,
                           x0=0.0, p0=0.0, device=None):
    """Sample (x, p) from the harmonic-oscillator Wigner distribution,
    the initial conditions of trajectory ensembles (FSSH, Ehrenfest).

    Ground state (beta=None): sigma_x^2 = 1/(2 m omega),
    sigma_p^2 = m omega / 2; thermal: both scaled by coth(beta omega / 2).
    omega/mass/x0/p0 may be scalars or (ndim,) arrays; returns (x, p),
    each (n, ndim) float64 on ``device`` (the card when None).

    The normal draws come from ``torch.Generator().manual_seed(key)`` on
    the CPU (``key`` an integer), so the card and the CPU see the same
    numbers; they are not JAX's ``jax.random`` draws."""
    if not isinstance(key, (int, np.integer)):
        raise TypeError("key must be an integer seed")
    dev = resolve_device(device)
    omega, mass = np.broadcast_arrays(
        np.atleast_1d(np.asarray(omega, dtype=float)),
        np.atleast_1d(np.asarray(mass, dtype=float)))
    ndim = omega.shape[0]
    scale = 1.0 if beta is None else 1.0 / np.tanh(beta * omega / 2.0)
    sx = torch.as_tensor(np.sqrt(scale / (2.0 * mass * omega)))
    sp = torch.as_tensor(np.sqrt(scale * mass * omega / 2.0))
    gen = torch.Generator().manual_seed(int(key))
    zx = torch.randn((n, ndim), generator=gen, dtype=torch.float64)
    zp = torch.randn((n, ndim), generator=gen, dtype=torch.float64)
    x = torch.as_tensor(np.asarray(x0, dtype=float)) + sx[None, :] * zx
    p = torch.as_tensor(np.asarray(p0, dtype=float)) + sp[None, :] * zp
    return x.to(dev), p.to(dev)

"""FFT with physicists' continuous-Fourier-transform conventions, on
``torch.fft``.

Counterpart of ``pyqed_tpu/ops/fft.py``. Forward transform

    g(w) = int dt f(t) e^{-i w t}    ->  fft(a) * dx * e^{-i w x0}, shifted

inverse

    g(t) = int dw f(w) e^{+i w t}   ->  ifft(a) * dx * n * e^{+i w x0}, shifted

Both return (g, freq) with ``freq`` the angular-frequency grid, on the
device of the input (a NumPy input becomes a CPU tensor). The private
``_fft2`` of ``models/pulse.py`` stays as it is.
"""
from __future__ import annotations

import math

import torch

from .linalg import as_tensor


def _freqs(nx, dx, like):
    dev = like.device
    return 2.0 * math.pi * torch.fft.fftshift(torch.fft.fftfreq(
        nx, d=float(dx), dtype=torch.float64, device=dev))


def _grid(x, nx, like):
    if x is None:
        return torch.arange(nx, dtype=torch.float64, device=like.device)
    return as_tensor(x).to(like.device)


def _transform(fn, a, x, axis, norm, sign):
    a = as_tensor(a)
    axis = axis % a.dim()
    nx = a.shape[axis]
    x = _grid(x, nx, a)
    dx = x[1] - x[0]
    g = torch.fft.fftshift(fn(a, dim=axis), dim=axis) * dx
    if norm:
        g = g * nx
    freq = _freqs(nx, float(dx), a)
    shape = [1] * a.dim()
    shape[axis] = nx
    phase = torch.exp(sign * 1j * freq * x[0])
    return g * phase.reshape(shape), freq


def fft(a, x=None, axis=-1):
    """Continuous FT along ``axis``: g(w) = int dx f(x) e^{-iwx}.
    Returns (g, freq)."""
    return _transform(torch.fft.fft, a, x, axis, False, -1.0)


def ifft(a, x=None, axis=-1):
    """Inverse continuous FT, g(t) = int dw f(w) e^{+iwt}, with the
    dx * nx normalization. Returns (g, freq)."""
    return _transform(torch.fft.ifft, a, x, axis, True, 1.0)


def fft2(f, dx=1.0, dy=1.0):
    """2D continuous FT. Returns (freqx, freqy, g); freqy uses ny."""
    f = as_tensor(f)
    nx, ny = f.shape
    g = torch.fft.fftshift(torch.fft.fft2(f)) * dx * dy
    return _freqs(nx, dx, f), _freqs(ny, dy, f), g


def dft(x, f, k):
    """DFT at arbitrary momenta, one product over the grid."""
    x = as_tensor(x)
    f, k = as_tensor(f).to(x.device), as_tensor(k).to(x.device)
    dx = (x[1] - x[0]).real
    return torch.sum(f[None, :] * torch.exp(-1j * torch.outer(k, x)),
                     dim=-1) * dx


def dft2(x, y, f, kx, ky):
    """2D DFT at arbitrary momenta, as one contraction over the grid."""
    x = as_tensor(x)
    dev = x.device
    y, f = as_tensor(y).to(dev), as_tensor(f).to(dev)
    kx, ky = as_tensor(kx).to(dev), as_tensor(ky).to(dev)
    dx = x[1] - x[0]
    dy = y[1] - y[0]
    X, Y = torch.meshgrid(x, y, indexing="xy")
    px = torch.exp(-1j * kx[:, None, None] * X[None])
    py = torch.exp(-1j * ky[:, None, None] * Y[None])
    return torch.einsum("axy, bxy, xy -> ab", px, py,
                        f.to(px.dtype)) * dx * dy

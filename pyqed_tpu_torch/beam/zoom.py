"""Chirp-z / Bluestein zoomed Fourier transforms for diffraction.

PyTorch counterpart of ``pyqed_tpu/beam/zoom.py``, on ``torch.fft``.
From the Bluestein identity

    nk = (n^2 + k^2 - (k - n)^2) / 2
    X_k = w^{k^2/2} sum_n [x_n a^{-n} w^{n^2/2}] w^{-(k-n)^2/2}

a chirp-z transform is one zero-padded FFT convolution. The chirp phases
are built on the host in float64 with mod-2π argument reduction, as the
JAX package builds them for concrete parameters, and the transforms run
on the device of the input.
"""
from __future__ import annotations

import numpy as np
import torch

from .fieldutils import _as_tensor

__all__ = ["czt", "zoom_dft", "zoom_dft2", "fraunhofer_zoom"]


def _cpow(base, expo):
    ang = np.mod(np.angle(base) * expo, 2 * np.pi)
    mag = np.abs(base) ** expo
    return mag * np.exp(1j * ang)


def czt(x, m, w, a=1.0 + 0.0j, axis=-1):
    """Chirp-z transform along ``axis``:

        X_k = sum_{n=0}^{N-1} x_n a^{-n} w^{n k},   k = 0..m-1.

    With a = 1, w = exp(-2 pi i / N), m = N this is the DFT. ``w`` and
    ``a`` are numbers."""
    x = _as_tensor(x)
    dev = x.device
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    L = int(2 ** np.ceil(np.log2(n + m - 1)))
    wc, ac = complex(w), complex(a)
    ns64 = np.arange(n, dtype=np.float64)
    j64 = np.arange(-(n - 1), m, dtype=np.float64)
    ks64 = np.arange(m, dtype=np.float64)
    pre = torch.as_tensor(_cpow(ac, -ns64) * _cpow(wc, ns64 ** 2 / 2.0),
                          device=dev)
    v = torch.as_tensor(_cpow(wc, -(j64 ** 2) / 2.0), device=dev)
    post = torch.as_tensor(_cpow(wc, ks64 ** 2 / 2.0), device=dev)
    y = x * pre
    nv = n + m - 1
    vpad = torch.zeros(L, dtype=torch.complex128, device=dev)
    vpad[:nv] = v
    ypad = torch.zeros(tuple(x.shape[:-1]) + (L,), dtype=y.dtype,
                       device=dev)
    ypad[..., :n] = y
    conv = torch.fft.ifft(torch.fft.fft(ypad, dim=-1) * torch.fft.fft(vpad),
                          dim=-1)
    Xk = conv[..., n - 1: n - 1 + m] * post
    return torch.movedim(Xk, -1, axis)


def zoom_dft(u, x, fout, axis=-1):
    """Continuous-FT samples U(f) = sum_n u_n e^{-2 pi i f x_n} dx on an
    ARBITRARY uniform frequency window ``fout`` (len m), independent of
    the fftfreq grid. The chirp parameters and the reference phase are
    host float64."""
    u = _as_tensor(u)
    m = np.shape(fout)[0]
    xh = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                    dtype=np.float64)
    fh = np.asarray(fout.cpu() if isinstance(fout, torch.Tensor) else fout,
                    dtype=np.float64)
    dx = float(xh[1] - xh[0])
    df = float(fh[1] - fh[0]) if m > 1 else 0.0
    w = complex(np.exp(-2j * np.pi * df * dx))
    a = complex(np.exp(+2j * np.pi * fh[0] * dx))
    phase = torch.as_tensor(np.exp(-2j * np.pi * np.mod(fh * xh[0], 1.0)),
                            device=u.device)
    X = czt(u, m, w, a, axis=axis)
    shape = [1] * u.dim()
    shape[axis] = m
    return X * phase.reshape(shape) * dx


def zoom_dft2(u, x, y, fx_out, fy_out):
    """Separable 2D zoom DFT: U(fx, fy) on an arbitrary rectangular
    frequency window; two chirp-z passes."""
    U = zoom_dft(u, x, fx_out, axis=0)
    return zoom_dft(U, y, fy_out, axis=1)


def fraunhofer_zoom(u, x, y, wavelength, z, xout, yout):
    """Far-field (Fraunhofer) diffraction evaluated on an arbitrary
    output window (xout, yout) at distance z:

    U(x', y') = e^{ikz} e^{ik(x'^2+y'^2)/2z} / (i lambda z)
                * FT[u](fx = x'/(lambda z), fy = y'/(lambda z))
    """
    u = _as_tensor(u).to(torch.complex128)
    dev = u.device
    xo = np.asarray(xout, dtype=np.float64)
    yo = np.asarray(yout, dtype=np.float64)
    k = 2 * np.pi / wavelength
    fx = xo / (wavelength * z)
    fy = yo / (wavelength * z)
    U = zoom_dft2(u, x, y, fx, fy)
    xt = torch.as_tensor(xo, device=dev)
    yt = torch.as_tensor(yo, device=dev)
    quad = torch.exp(1j * k * (xt[:, None] ** 2 + yt[None, :] ** 2)
                     / (2 * z))
    return complex(np.exp(1j * k * z)) * quad / (1j * wavelength * z) * U

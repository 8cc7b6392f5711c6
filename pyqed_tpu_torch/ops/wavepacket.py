"""Gaussian wavepacket constructors (PyTorch).

Counterpart of ``pyqed_tpu/ops/wavepacket.py`` (reference: pyqed/phys.py
``gwp:877``, ``rgwp:855``, ``gwp2:472``, ``gwp_k:952``). Inputs may be
arrays or tensors; results are tensors on the device of ``x`` (float64 or
complex128 for NumPy input).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _t(x):
    """A tensor of ``x``; lists and scalars go through NumPy, so they
    become float64 as in the JAX package."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def rgwp(x, x0=0.0, sigma=1.0):
    """Real Gaussian wavepacket, L2-normalized on the line
    (reference: pyqed/phys.py:855)."""
    x = _t(x)
    return (1.0 / math.sqrt(math.sqrt(math.pi) * sigma)
            * torch.exp(-((x - x0) ** 2) / 2.0 / sigma ** 2))


def gwp(x, a=None, x0=0.0, p0=0.0, ndim=1):
    """Complex Gaussian wavepacket with width matrix ``a``
    (reference: pyqed/phys.py:877):

        g(x) = det(a)^{1/4}/pi^{n/4} exp(-1/2 (x-x0)ᵀ a (x-x0) + i p0·(x-x0))

    For ndim == 1, x may be a grid. For ndim > 1, x is a single point.
    """
    x = _t(x)
    if ndim == 1:
        if a is None:
            a = 1.0
        return (a / math.pi) ** 0.25 * torch.exp(
            -a * (x - x0) ** 2 / 2.0 + 1j * p0 * (x - x0))
    x = x.to(torch.float64)
    a = (torch.eye(ndim, dtype=x.dtype, device=x.device) if a is None
         else _t(a).to(x))
    x0 = torch.broadcast_to(_t(x0).to(x), (ndim,))
    p0 = torch.broadcast_to(_t(p0).to(x), (ndim,))
    u = x - x0
    delta = u @ (a @ u)
    return (torch.linalg.det(a) ** 0.25 / math.pi ** (ndim / 4)
            * torch.exp(-0.5 * delta + 1j * (p0 @ u)))


def gwp_k(k, sigma, x0, k0):
    """Analytic FT of the 1D Gaussian packet (reference: pyqed/phys.py:952)."""
    k = _t(k)
    a = 1.0 / sigma ** 2
    return ((a / math.sqrt(math.pi)) ** 0.5
            * torch.exp(-0.5 * (a * (k - k0)) ** 2 - 1j * (k - k0) * x0))


def gwp2(x, y, sigma=None, xc=(0.0, 0.0), kc=(0.0, 0.0)):
    """2D Gaussian packet on a meshgrid (reference: pyqed/phys.py:472)."""
    x, y = _t(x), _t(y)
    sigma = (torch.eye(2, dtype=torch.float64) if sigma is None
             else _t(sigma).to(torch.float64))
    A = torch.linalg.inv(sigma)
    dx = x - xc[0]
    dy = y - xc[1]
    delta = (A[0, 0] * dx ** 2 + (A[0, 1] + A[1, 0]) * dx * dy
             + A[1, 1] * dy ** 2)
    phase = kc[0] * dx + kc[1] * dy
    return (torch.linalg.det(A) ** 0.25 / math.pi ** 0.5
            * torch.exp(-0.5 * delta + 1j * phase))

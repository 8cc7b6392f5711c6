"""Colored-noise generation.

Counterpart of ``pyqed_tpu/utils/noise.py``: the Ornstein-Uhlenbeck
generator of R. F. Fox et al., PRA 38, 5938 (1988), every sample batched
and the time recursion one fixed-shape step run by
:class:`~pyqed_tpu_torch.core.dynamics.GraphScan`. The draws (the initial
normals and the Box-Muller uniform pairs) come from a ``torch.Generator``
on ``device`` seeded by the integer ``key``, or are given as ``draws=``,
so the JAX package's own draws can be fed in.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device
from ..core.dynamics import GraphScan
from ..ops.linalg import as_tensor


def cnoise(key, nstep, nsample, dt=0.001, tau=0.0025, ave=0.0, D=0.0025,
           device=None, draws=None):
    """Exponentially correlated Gaussian noise,
    <eps(t) eps(s)> = D/tau exp(-|t-s|/tau).

    Returns eps of shape (nstep, nsample) on ``device`` (the card when
    None). ``draws`` = (eps0 normals (nsample,), uniforms (nstep - 1, 2,
    nsample) in [1e-12, 1)), else drawn from ``key``."""
    dev = resolve_device(device)
    sigma = math.sqrt(D / tau)
    E = math.exp(-dt / tau)
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(int(key))
        kw = dict(generator=gen, device=dev, dtype=torch.float64)
        z0 = torch.randn((nsample,), **kw)
        a = 1e-12 + (1.0 - 1e-12) * torch.rand((nstep - 1, 2, nsample),
                                                **kw)
    else:
        z0, a = (torch.as_tensor(np.array(d, dtype=np.float64), device=dev)
                 for d in draws)
    eps0 = z0 * sigma

    def step(eps, ak):
        h = torch.sqrt(-2.0 * D / tau * (1.0 - E ** 2) * torch.log(ak[0])) \
            * torch.cos(2.0 * math.pi * ak[1])
        new = eps * E + h
        return new, new

    _, path = GraphScan(step)(eps0, a)
    rows = [eps0[None]] + ([path] if path is not None else [])
    return torch.cat(rows, dim=0) + ave


def autocorrelation(eps, nlag=None):
    """Sample autocorrelation over the ensemble, (nlag,)."""
    eps = as_tensor(eps)
    nstep, nsample = eps.shape
    if nlag is None:
        nlag = nstep // 2
    return torch.stack([torch.mean(eps[: nstep - lag] * eps[lag:nstep])
                        for lag in range(nlag)])


def cross_correlation(a, b, nlag=None):
    """Sample cross-correlation <a(t) b(t+lag)> over the ensemble, the
    mean over the (nstep - lag) * nsample products; a, b (nstep, nsample).
    Returns (nlag,)."""
    a = as_tensor(a)
    b = as_tensor(b).to(a.device)
    nstep, _ = a.shape
    if nlag is None:
        nlag = nstep // 2
    return torch.stack([torch.mean(a[: nstep - lag] * b[lag:nstep])
                        for lag in range(nlag)])


cross_corr = cross_correlation

"""Quasi-Monte Carlo: Sobol low-discrepancy sequences.

Counterpart of ``pyqed_tpu/qmc/sobol.py``. SciPy's generator supplies
the points on the host; the integrand is evaluated as one
``torch.func.vmap`` batch over the points on the device.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from scipy.stats import qmc

from ..config import resolve_device


def sobol_sequence(n, dim, scramble=True, seed=0):
    """First n points of a (scrambled) Sobol sequence in [0, 1)^dim."""
    eng = qmc.Sobol(d=dim, scramble=scramble, seed=seed)
    m = int(np.ceil(np.log2(max(n, 1))))
    pts = eng.random_base2(m=m) if n > 1 else eng.random(1)
    return pts[:n]


def qmc_integrate(f: Callable, bounds: Sequence, n=4096, scramble=True,
                  seed=0, device=None):
    """Integrate f over a box with a Sobol rule; f maps a (dim,) tensor to
    a scalar in torch operations and is evaluated as one
    ``torch.func.vmap`` batch on ``device`` (the card when None)."""
    dev = resolve_device(device)
    lo = np.array([b[0] for b in bounds], float)
    hi = np.array([b[1] for b in bounds], float)
    pts = sobol_sequence(n, len(bounds), scramble, seed)
    x = torch.as_tensor(lo + pts * (hi - lo), device=dev)
    vol = float(np.prod(hi - lo))
    return float(torch.mean(torch.func.vmap(f)(x)) * vol)

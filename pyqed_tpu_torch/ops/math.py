"""Small math helpers (PyTorch).

Counterpart of the part of ``pyqed_tpu/ops/math.py`` that the ported
solvers use: ``interval`` and ``morse`` (reference: pyqed/phys.py
``interval:606``, ``morse:447``).
"""
from __future__ import annotations

import numpy as np
import torch


def interval(x):
    """Grid spacing of a uniform grid (reference: pyqed/phys.py:606)."""
    return x[1] - x[0]


def morse(r, D, a, re):
    """Morse potential D(1-e^{-a(r-re)})^2 as a tensor
    (reference: pyqed/phys.py:447)."""
    if not isinstance(r, torch.Tensor):
        r = torch.as_tensor(np.asarray(r))      # float64, as in the JAX package
    return D * (1.0 - torch.exp(-a * (r - re))) ** 2

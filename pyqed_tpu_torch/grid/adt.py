"""Adiabatic-to-diabatic transformation (ADT) for two coupled states
(PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/adt.py`` (reference:
pyqed/models/jahn_teller.py:463, a stub there). For two states in one
nuclear coordinate the mixing angle integrates the derivative coupling,

    theta(x) = theta0 + int_{x0}^{x} tau(x') dx',
    tau(x) = <phi_1(x) | d phi_2(x) / dx>,

and the diabatic potential is V_dia = R(theta) diag(E_1, E_2) R(theta)^T.
"""
from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor

__all__ = ["adt_angle", "adt_1d", "ADT"]


def _cumtrapz(y, x):
    dy = 0.5 * (y[1:] + y[:-1]) * (x[1:] - x[:-1])
    return torch.cat([dy.new_zeros(1), torch.cumsum(dy, dim=0)])


def adt_angle(x, nac, theta0=0.0, device=None):
    """Mixing angle theta(x) (float64 tensor on ``device``, the card when
    None) from the scalar derivative coupling tau(x) = <phi_1|d phi_2/dx>
    by cumulative trapezoid integration."""
    dev = resolve_device(device)
    x = as_tensor(x, torch.float64, dev)
    nac = as_tensor(nac, torch.float64, dev)
    return theta0 + _cumtrapz(nac, x)


def adt_1d(x, apes, nac, theta0=0.0, device=None):
    """Diabatize two adiabatic surfaces on ``device`` (the card when None).

    x : (nx,) grid; apes : (nx, 2) adiabatic energies (lower, upper);
    nac : (nx,) derivative coupling <phi_1|d phi_2/dx>; theta0 : the
    mixing angle at x[0].

    Returns (V (nx, 2, 2) diabatic potential matrices, theta (nx,)). The
    upper adiabat's eigenvector is (cos t, sin t) and the lower's
    (-sin t, cos t), so tau = d theta/dx exactly."""
    dev = resolve_device(device)
    apes = as_tensor(apes, torch.float64, dev)
    theta = adt_angle(x, nac, theta0, device=dev)
    c, s = torch.cos(theta), torch.sin(theta)
    el, eu = apes[:, 0], apes[:, 1]
    v11 = s ** 2 * el + c ** 2 * eu
    v22 = c ** 2 * el + s ** 2 * eu
    v12 = c * s * (eu - el)
    V = torch.stack([torch.stack([v11, v12], dim=-1),
                     torch.stack([v12, v22], dim=-1)], dim=-2)
    return V, theta


ADT = adt_1d    # reference drop-in name (pyqed/models/jahn_teller.py:463)

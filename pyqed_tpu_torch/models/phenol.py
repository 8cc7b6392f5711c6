"""Phenol photodissociation model: 3-state 2D PES in (r_OH, theta)
(PyTorch).

PyTorch counterpart of ``pyqed_tpu/models/phenol.py`` (reference:
pyqed/models/phenol.py:16 ``Phenol``, :189 ``dpes1`` — the S0/1pipi*/
1pisigma* diabatic surfaces of Z. Lan et al. / C. Xie et al., J. Chem.
Phys. 144, 124312 (2016), Tables I-IV). ``dpes`` broadcasts over
coordinate tensors (NumPy arrays become float64 CPU tensors); ``buildV``
and ``apes`` run on the model's device (the card when None).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor
from ..units import au2ev, au2angstrom


def _p(x):
    return x / au2ev


class Phenol:
    """S0 / 1pipi* / 1pisigma* phenol surfaces along the O-H stretch r
    (bohr) and the CCOH torsion theta (rad)."""

    nstates = 3

    def __init__(self, r=None, theta=None, mass=None, device=None):
        self.device = resolve_device(device)
        self.r = r
        self.theta = theta
        # reduced masses: O-H stretch and torsional inertia (a.u.);
        # reference _reduced_mass (phenol.py:51)
        self.mass = mass if mass is not None else [1728.46, 48490.0]

    @staticmethod
    def dpes(r, theta):
        """Diabatic (3, 3) matrix, broadcasting over r/theta tensors
        (reference: pyqed/models/phenol.py:189 ``dpes1``; constants from
        JCP 144, 124312 (2016) Tables I-IV)."""
        A2ang = au2angstrom
        De1, r1, a1 = _p(4.26302), 0.96994 / A2ang, 2.66021 * A2ang
        A1, A2, A3 = _p(0.27037), 1.96606 / A2ang, 0.685264 / A2ang
        (B201, B202, B203, B204, B205, B206, B207, B208, chi20) = (
            _p(0.192205), 5.67356 * A2ang, 1.03171 / A2ang, _p(5.50696),
            _p(4.70601), 2.49826 * A2ang, 0.988188 / A2ang, _p(3.3257),
            0.326432 / au2ev ** 2)
        (B211, B212, B213, B214, B215, B216, B217, chi21) = (
            _p(-0.2902), 2.05715 / A2ang, 1.01574 / A2ang, _p(-73.329),
            1.48285 / A2ang, -0.1111 / A2ang, _p(-0.00055),
            0.021105 / au2ev ** 2)
        (B221, B222, B223, B224, B225, B226, chi22) = (
            _p(27.3756), 1.66881 / A2ang, 0.20557 / A2ang,
            0.35567 / A2ang, _p(1.43492), 0.56968 / A2ang, 0.0)
        De3, r3, a3, a30 = (_p(4.47382), 0.96304 / A2ang,
                            2.38671 * A2ang, _p(4.85842))
        C1, C2, C3 = _p(0.110336), 1.21724 / A2ang, 0.06778 / A2ang
        l12max, d12, b12 = _p(1.47613), 1.96984 / A2ang, 0.494373 / A2ang
        l23max, d23, b23 = (_p(0.327204), 1.22594 / A2ang,
                            0.0700604 / A2ang)

        r = as_tensor(r, torch.float64)
        theta = as_tensor(theta, torch.float64)
        v10 = De1 * (1 - torch.exp(-a1 * (r - r1))) ** 2
        v11 = 0.5 * A1 * (1 - torch.tanh((r - A2) / A3))
        v201 = B201 * (1 - torch.exp(-B202 * (r - B203))) ** 2 + B204
        v202 = B205 * torch.exp(-B206 * (r - B207)) + B208
        v211 = 0.5 * B211 * (1 - torch.tanh((r - B212) / B213))
        v212 = 0.5 * B214 * (1 - torch.tanh((r - B215) / B216)) + B217
        v221 = 0.5 * B221 * (1 + torch.tanh((r - B222) / B223))
        v222 = 0.5 * B224 * (1 - torch.tanh((r - B225) / B226))
        v20 = 0.5 * (v201 + v202) - 0.5 * torch.sqrt(
            (v201 - v202) ** 2 + chi20)
        v21 = 0.5 * (v211 + v212) + 0.5 * torch.sqrt(
            (v211 - v212) ** 2 + chi21)
        v22 = 0.5 * (v221 + v222) - 0.5 * torch.sqrt(
            (v221 - v222) ** 2 + chi22)
        v30 = De3 * (1 - torch.exp(-a3 * (r - r3))) ** 2 + a30
        v31 = 0.5 * C1 * (1 - torch.tanh((r - C2) / C3))
        l12 = 0.5 * l12max * (1 - torch.tanh((r - d12) / b12))
        l23 = 0.5 * l23max * (1 - torch.tanh((r - d23) / b23))

        c2t = 1 - torch.cos(2 * theta)
        V11 = v10 + v11 * c2t
        V22 = v20 + v21 * c2t + v22 * c2t ** 2
        V33 = v30 + v31 * c2t
        V12 = l12 * torch.sin(theta)
        V23 = l23 * torch.sin(theta)
        Z = torch.zeros_like(V11)
        row0 = torch.stack([V11, V12, Z], dim=-1)
        row1 = torch.stack([V12, V22, V23], dim=-1)
        row2 = torch.stack([Z, V23, V33], dim=-1)
        return torch.stack([row0, row1, row2], dim=-2)

    def buildV(self):
        """Global diabatic PES on the (r, theta) grid, on the device
        (reference: phenol.py:59)."""
        R, T = np.meshgrid(self.r, self.theta, indexing="ij")
        self.v = self.dpes(torch.as_tensor(R, device=self.device),
                           torch.as_tensor(T, device=self.device))
        return self.v

    def apes(self):
        """Adiabatic surfaces (batched eigh; reference: phenol.py:129)."""
        if getattr(self, "v", None) is None:
            self.buildV()
        w, _ = torch.linalg.eigh(self.v)
        self.va = w
        return w

    def inertia(self, r):
        """Torsional inertia I(r) for Jacobi-coordinate SPO
        (reference: phenol.py:164): treated constant here."""
        return np.full_like(np.asarray(r, dtype=float), self.mass[1])

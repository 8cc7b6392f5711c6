"""Pyrrole N-H photodissociation model: S0/1pisigma* conical intersection
in Jacobi coordinates (r, q) (PyTorch).

PyTorch counterpart of ``pyqed_tpu/models/pyrrole.py`` (reference:
pyqed/models/pyrrole.py:33 ``Pyrrole``, :243 ``PyrroleCation``). The PES
functions broadcast over coordinate tensors (NumPy arrays and numbers
become float64 CPU tensors); ``dpes``, ``apes``, ``S0`` and
``eigenstates`` run on the model's device (the card when None).
"""
from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor
from ..units import au2ev, atomic_mass, au2amu


def _t(a, device=None):
    """``a`` as a float64 tensor (on ``device`` where given)."""
    return as_tensor(a, torch.float64, device)


def _morse(r, D, a, r0):
    return D * (1.0 - torch.exp(-a * (r - r0))) ** 2


class Pyrrole:
    """Two-state (S0 / 1pisigma*) pyrrole model in Jacobi coordinates:
    r the H--ring distance, q the dissociation-path bending angle
    (reference: pyqed/models/pyrrole.py:33)."""

    nstates = 2
    r0 = 1.959                      # N-H equilibrium distance (bohr)
    rMN = 2.168                     # ring-center -- N distance

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.reduced_mass = self._reduced_mass()

    @staticmethod
    def _reduced_mass():
        mH = atomic_mass["H"] / au2amu
        mN = atomic_mass["N"] / au2amu
        mM = 4.0 * (atomic_mass["C"] / au2amu + mH)
        return mH * (mM + mN) / (mH + mM + mN)

    def transform(self, r, q):
        """Jacobi (r, q) -> internal (r_NH, theta)."""
        r, q = _t(r), _t(q)
        rNH = torch.sqrt(r ** 2 * torch.sin(q) ** 2
                         + (r * torch.cos(q) - self.rMN) ** 2)
        theta = torch.arcsin(r / rNH * torch.sin(q))
        return rNH, theta

    @staticmethod
    def v11(r):
        return _morse(_t(r), 5.117 / au2ev, 1.196, 1.959)

    @staticmethod
    def v21(r):
        return _morse(_t(r), 8.07 / au2ev, 0.882, 1.922) + 5.584 / au2ev

    @staticmethod
    def v22(r):
        return 0.091 / au2ev * torch.exp(-1.290 * (_t(r) - 5.203)) \
            + 4.092 / au2ev

    @staticmethod
    def omegac1(r):
        r = _t(r)
        f1 = 0.5 * (1.0 + torch.tanh((r - 2.696) / 0.00015))
        return ((5.147 / au2ev - 1.344 / au2ev * r) * (1.0 - f1)
                + 0.884 / au2ev * torch.exp(-1.2910 * (r - 3.1)) * f1)

    @staticmethod
    def omegac2(r):
        r = _t(r)
        B22 = -1.219 / au2ev
        return torch.where(
            r <= 2.55,
            0.5 * (3.819 / au2ev + B22 * r)
            - 0.5 * torch.sqrt((2.335 / au2ev + B22 * r) ** 2
                               + 4 * (0.226 / au2ev) ** 2),
            0.0)

    @staticmethod
    def l12(r):
        return 0.5 * (2.4 / au2ev) * (1 - torch.tanh((_t(r) - 3.454) / 1.942))

    def dpes(self, r, q):
        """Diabatic matrix on the (r, q) product grid -> (nx, ny, 2, 2)
        (reference: pyqed/models/pyrrole.py:112 ``DPES``)."""
        R, Q = torch.meshgrid(_t(r, self.device), _t(q, self.device),
                              indexing="ij")
        rNH, theta = self.transform(R, Q)
        l22 = 1.669 / au2ev
        v21, v22 = self.v21(rNH), self.v22(rNH)
        v00 = self.v11(rNH) + 0.5 * self.omegac1(rNH) * theta ** 2
        v11 = (0.5 * (v21 + v22)
               - 0.5 * torch.sqrt((v21 - v22) ** 2 + 4 * l22 ** 2)
               + 0.5 * self.omegac2(rNH) * theta ** 2)
        v01 = self.l12(rNH) * theta
        return torch.stack([torch.stack([v00, v01], -1),
                            torch.stack([v01, v11], -1)], -2)

    DPES = dpes

    def apes(self, r, q):
        return torch.linalg.eigvalsh(self.dpes(r, q))

    def S0(self, r, q):
        rNH, theta = self.transform(_t(r, self.device), _t(q, self.device))
        return self.v11(rNH) + 0.5 * self.omegac1(rNH) * theta ** 2

    def moment_of_inertia(self, r):
        mH = atomic_mass["H"] / au2amu
        mN = atomic_mass["N"] / au2amu
        mM = 4.0 * (atomic_mass["C"] / au2amu + mH)
        mu_MN = mM * mN / (mM + mN)
        return 1.0 / (1.0 / (self.reduced_mass * r ** 2)
                      + 1.0 / (mu_MN * self.rMN ** 2))

    def eigenstates(self, nstates=3, domain=(1.5, 4.0), npts=128):
        """Vibrational levels on the S0 1D cut by a sine DVR (the
        reference's ``eigenstates`` is a stub)."""
        from ..grid.dvr import SineDVR
        dvr = SineDVR(*domain, npts, mass=self.reduced_mass,
                      device=self.device)
        H = dvr.t() + torch.diag(self.v11(_t(dvr.x, self.device)))
        w, u = torch.linalg.eigh(H)
        return w[:nstates], u[:, :nstates]


class PyrroleCation:
    """Pyrrole-cation D0/D1 adiabatic surfaces in the same Jacobi
    coordinates (reference: pyqed/models/pyrrole.py:243)."""

    nstates = 2
    r0 = 1.9404
    E0 = 0.2999
    rMN = 2.168

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.reduced_mass = Pyrrole._reduced_mass()

    transform = Pyrrole.transform
    moment_of_inertia = Pyrrole.moment_of_inertia

    @staticmethod
    def _omega(r, d2, alpha1, B11, B12, B13, B14):
        f1 = 0.5 * (1.0 + torch.tanh((r - d2) / alpha1))
        return (B11 + B12 * r) * (1.0 - f1) + B13 * torch.exp(-B14 * r) * f1

    def D0(self, r, q):
        rNH, theta = self.transform(_t(r, self.device), _t(q, self.device))
        return (_morse(rNH, 0.2167, 1.055, self.r0)
                + 0.5 * self._omega(rNH, 4.6353, 2.0202, 0.0851,
                                    -0.0126, 6.1015, 1.9383) * theta ** 2)

    def D1(self, r, q):
        rNH, theta = self.transform(_t(r, self.device), _t(q, self.device))
        return (_morse(rNH, 0.2028, 1.0732, 1.9537)
                + 0.5 * self._omega(rNH, 4.4689, 0.5077, 0.1278,
                                    -0.0257, 36.7638, 1.6474) * theta ** 2)

    def apes(self, r, q, n=0):
        return self.D0(r, q) if n == 0 else self.D1(r, q)

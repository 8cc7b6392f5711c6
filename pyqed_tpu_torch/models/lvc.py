"""Linear vibronic coupling (LVC) model in the Fock (HO) basis (PyTorch).

PyTorch counterpart of ``pyqed_tpu/models/lvc.py`` (reference:
pyqed/mol.py — ``Mode:953``, ``LVC:959`` (``buildH:1003``, ``APES:1060``,
``promote:1081``, ``vertical:1090``, ``rdm_el:1222``,
``add_coupling:1241``); pyqed/phys.py — ``multimode:1878``).

Hilbert-space ordering: electronic (x) vibrational,
H = h_el (x) I_vib + I_el (x) h_vib + sum_j V_j (x) x_j, for any number of
electronic states. Like :class:`~pyqed_tpu_torch.models.mol.Mol`, the
operators are small CPU tensors (complex128) built on the host; ``APES``
and the dynamics take ``device`` and run there (the card when None).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor, dag, tensor
from ..ops.operators import basis, boson, jump, quadrature
from .mol import Mol, SESolver


@dataclasses.dataclass
class Mode:
    """A vibrational mode (reference: pyqed/mol.py:953)."""
    omega: float
    couplings: list = dataclasses.field(default_factory=list)
    truncate: int = 2


def multimode(omegas, nmodes, J=0.0, truncate=2):
    """Direct-product multi-mode boson Hamiltonian and position operators
    (reference: pyqed/phys.py:1878). Returns (H, [x_j]), complex128 CPU
    tensors."""
    N = truncate
    idm = torch.eye(N, dtype=torch.complex128)
    x1 = quadrature(N)
    H = 0.0
    xs = []
    for j in range(nmodes):
        ops_h = [idm] * nmodes
        ops_h[j] = boson(omegas[j], N)
        H = H + tensor(ops_h)
        ops_x = [idm] * nmodes
        ops_x[j] = x1
        xs.append(tensor(ops_x))
    if J != 0.0:
        for j in range(nmodes - 1):
            H = H + J * xs[j] @ xs[j + 1]
    return H, xs


class LVC(Mol):
    """(reference: pyqed/mol.py:959)."""

    def __init__(self, E, modes: Sequence[Mode]):
        self.e_fc = np.asarray(E)
        self.nel = self.nstates = len(E)
        self.nmodes = len(modes)
        self.modes = list(modes)
        self.fock_dims = [m.truncate for m in modes]
        self.nvib = int(np.prod(self.fock_dims))
        self.idm_vib = torch.eye(self.nvib, dtype=torch.complex128)
        self.idm_el = torch.eye(self.nstates, dtype=torch.complex128)
        self.omegas = [m.omega for m in modes]
        self.H = None
        self.dim = None
        self._x = None
        self.gamma = None
        self.dephasing = 0.0
        self._edip = None
        self._edip_rms = None

    @classmethod
    def from_reference(cls, ref):
        """The port's LVC with the parameters of a JAX ``LVC`` ``ref`` (its
        energies and modes) and, once built there, its Hamiltonian (which
        keeps couplings added by ``add_coupling``)."""
        modes = [Mode(m.omega, [(tuple(c[0]), c[1]) for c in m.couplings],
                      m.truncate) for m in ref.modes]
        out = cls(np.asarray(ref.e_fc), modes)
        if ref.H is not None:
            out.buildH()
            out.H = torch.as_tensor(np.asarray(ref.H)).to(torch.complex128)
        return out

    def buildH(self):
        """(reference: pyqed/mol.py:1003)."""
        nel = self.nstates
        h_el = torch.diag(torch.as_tensor(self.e_fc, dtype=torch.float64))
        hv, xs = multimode(self.omegas, self.nmodes,
                           truncate=self.fock_dims[0])
        H = (torch.kron(h_el.to(hv.dtype), torch.eye(hv.shape[0],
                                                     dtype=hv.dtype))
             + torch.kron(self.idm_el, hv))
        for j, mode in enumerate(self.modes):
            V = torch.zeros((nel, nel), dtype=H.dtype)
            for c in mode.couplings:
                a, b = c[0]
                V = V + c[1] * jump(a, b, nel)
            H = H + torch.kron(V, xs[j])
        self.H = H
        self.dim = H.shape[0]
        self._x = xs
        return H

    def APES(self, x, device=None):
        """Adiabatic PES at the nuclear point x, ascending, on ``device``
        (the card when None) (reference: pyqed/mol.py:1060)."""
        dev = resolve_device(device)
        x = np.atleast_1d(np.asarray(x, dtype=float))
        V = torch.diag(torch.as_tensor(self.e_fc, dtype=torch.float64)).to(
            torch.complex128)
        V = V + 0.5 * float(np.sum(np.asarray(self.omegas) * x ** 2)) \
            * self.idm_el
        for j, mode in enumerate(self.modes):
            for c in mode.couplings:
                a, b = c[0]
                V = V + c[1] * jump(a, b, self.nstates) * float(x[j])
        return torch.sort(torch.linalg.eigvalsh(V.to(dev))).values

    def promote(self, A, which="el"):
        """(reference: pyqed/mol.py:1081)."""
        A = as_tensor(A)
        if which in ("el", "e", "electronic"):
            return torch.kron(A, self.idm_vib.to(A.dtype))
        elif which in ("v", "vib", "vibrational"):
            return torch.kron(self.idm_el.to(A.dtype), A)
        raise ValueError(which)

    def buildop(self, i, f=None, isherm=True):
        """Electronic jump operator lifted to the vibronic space
        (reference: pyqed/mol.py:1130)."""
        if f is None:
            op = jump(i, i, self.nel, isherm=False)
        else:
            op = jump(f, i, self.nel, isherm=isherm)
        return self.promote(op, "el")

    def coordinate(self, n):
        """n-th mode position operator in the full space
        (reference: pyqed/mol.py:1163)."""
        if self._x is None:
            self.buildH()
        return self.promote(self._x[n], "vib")

    def vertical(self, n=1):
        """Franck-Condon (vertical excitation) initial state
        (reference: pyqed/mol.py:1090)."""
        psi = basis(self.nstates, n)
        chi = basis(self.fock_dims[0], 0)
        for j in range(1, self.nmodes):
            chi = torch.kron(chi, basis(self.fock_dims[j], 0))
        return torch.kron(psi, chi)

    def groundstate(self):
        return self.vertical(n=0)

    def rdm_el(self, psi):
        """(reference: pyqed/mol.py:1222)."""
        p = as_tensor(psi).reshape(self.nel, self.nvib)
        return p @ dag(p)

    def add_coupling(self, coupling):
        """(reference: pyqed/mol.py:1241)."""
        a, b = coupling[0]
        self.H = self.H + coupling[1] * torch.kron(
            jump(a, b, self.nel), self.idm_vib.to(self.H.dtype))
        return self.H

    def wavepacket_dynamics(self, method="RK4", device=None):
        """An SESolver of H on ``device`` (reference: pyqed/mol.py:1185)."""
        if self.H is None:
            self.buildH()
        sol = SESolver(self.H, device=device)
        sol.groundstate = self.groundstate()
        return sol

    def run(self, psi0=None, dt=0.01, nt=1, device=None, **kwargs):
        """Wave-packet dynamics under H on ``device`` (the card when
        None), from the vertical excitation to state 1 by default."""
        if self.H is None:
            self.buildH()
        if psi0 is None:
            psi0 = self.vertical(1)
        return SESolver(self.H, device=device).run(psi0=psi0, dt=dt, Nt=nt,
                                                   **kwargs)

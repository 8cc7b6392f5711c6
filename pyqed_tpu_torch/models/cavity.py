"""Cavity QED: single-mode cavity, composite systems, polaritons (PyTorch).

Counterpart of ``pyqed_tpu/models/cavity.py`` (reference:
pyqed/polariton/cavity.py — ``Composite:28``, ``Cavity:404``,
``Polariton:577`` (``getH:608`` length/velocity gauge + DSE + RWA),
``eigenstates:735`` photon fractions, ``get_cav_leak:726``).

Like :class:`~pyqed_tpu_torch.models.mol.Mol`, these build their
operators on the host, as small CPU tensors (Kronecker products). What
computes takes ``device``, the card when None: ``eigenstates``,
``spectrum``, ``transform_basis`` and ``driven_dynamics``, and the solvers
the operators are handed to (``SESolver``, ``LindbladSolver``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor, dag, ket2dm, ptrace, transform
from ..ops.operators import basis, create, destroy, ham_ho
from .mol import Mol


def _kron(a, b):
    """kron of two tensors in the dtype that holds both."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.kron(a.to(dt).contiguous(), b.to(dt).contiguous())


class Cavity:
    """Single-mode cavity (reference: pyqed/polariton/cavity.py:404)."""

    def __init__(self, freq, n_cav=None, x=None, decay=None, g=None,
                 quality_factor=None):
        self.freq = self.omega = self.omegac = freq
        self.resonance = freq
        self.ncav = self.n_cav = n_cav
        self.n = self.dim = n_cav
        self.idm = torch.eye(n_cav, dtype=torch.float64)
        self.decay = decay
        self.quality_factor = quality_factor
        self._g = g
        self.H = self.getH()
        if x is not None:
            self.x = np.asarray(x)
            self.nx = len(x)

    @classmethod
    def from_reference(cls, ref):
        """The port's cavity with the parameters of a JAX Cavity ``ref``."""
        return cls(ref.freq, ref.n_cav, x=getattr(ref, "x", None),
                   decay=ref.decay, g=ref.g,
                   quality_factor=ref.quality_factor)

    @property
    def g(self):
        return self._g

    @g.setter
    def g(self, value):
        self._g = value

    def getH(self, zpe=False):
        return ham_ho(self.freq, self.n_cav, ZPE=zpe)

    def nonhermH(self):
        """H with cavity decay (reference: pyqed/polariton/cavity.py:451)."""
        return ham_ho(self.omega - 0.5j * self.decay, self.ncav)

    def get_nonhermitianH(self):
        if self.quality_factor is None:
            raise ValueError("The quality factor cannot be None.")
        kappa = self.freq / 2.0 / self.quality_factor
        self.nonhermHmat = self.H - 1j * kappa * torch.eye(
            self.ncav, dtype=torch.float64)
        return self.nonhermHmat

    get_nonhermH = get_nonhermitianH

    def annihilate(self):
        return destroy(self.n_cav)

    def create(self):
        return create(self.n_cav)

    def num(self):
        return torch.diag(torch.arange(self.n_cav, dtype=torch.float64)).to(
            torch.complex128)

    get_number_operator = num

    def quadrature(self):
        a = self.annihilate()
        return (a + dag(a)) / np.sqrt(2.0)

    def vacuum(self):
        return basis(self.n_cav, 0)

    ground_state = vacuum

    def vacuum_dm(self):
        return ket2dm(self.vacuum())

    get_dm = vacuum_dm


class Composite(Mol):
    """Tensor product of two subsystems (reference:
    pyqed/polariton/cavity.py:28)."""

    def __init__(self, A, B):
        self.A = A
        self.B = B
        self.ida = A.idm
        self.idb = B.idm
        self.idm = _kron(A.idm, B.idm)
        self.H = None
        self.nonhermH = None
        self.dim = A.dim * B.dim
        self.nstates = self.dim
        self.dims = [A.dim, B.dim]
        self.eigvals_ = None
        self.eigvecs_ = None
        self.gamma = None
        self.dephasing = 0.0
        self._edip = None
        self._edip_rms = None

    def getH(self, a_ops=None, b_ops=None, g=0):
        """H = H_A (x) I + I (x) H_B + sum_i g_i a_i (x) b_i
        (reference: pyqed/polariton/cavity.py:58)."""
        H = _kron(self.A.H, self.idb) + _kron(self.ida, self.B.H)
        if a_ops is not None:
            if not isinstance(a_ops, (list, tuple)):
                a_ops, b_ops, g = [a_ops], [b_ops], [g]
            for gi, a_op, b_op in zip(np.atleast_1d(g), a_ops, b_ops):
                H = H + gi.item() * _kron(as_tensor(a_op), as_tensor(b_op))
        self.H = H
        return H

    def promote(self, o, subspace="A"):
        """Lift an operator into the product space
        (reference: pyqed/polariton/cavity.py:144)."""
        if subspace in ("A", "a"):
            return _kron(as_tensor(o), self.B.idm)
        if subspace in ("B", "b"):
            return _kron(self.A.idm, as_tensor(o))
        raise ValueError("The subspace option can only be A or B.")

    def promote_ops(self, ops, subspaces=None):
        if subspaces is None:
            subspaces = ["A"] * len(ops)
        return [self.promote(op, s) for op, s in zip(ops, subspaces)]

    def eigenstates(self, k: Optional[int] = None, device=None):
        """(eigvals, eigvecs) of H, solved on ``device``."""
        if self.H is None:
            raise ValueError("Please call getH to compute the Hamiltonian "
                             "first.")
        evals, evecs = torch.linalg.eigh(self.H.to(resolve_device(device)))
        self.eigvals_ = evals
        self.eigvecs_ = evecs
        if k is not None and k < self.dim:
            return evals[:k], evecs[:, :k]
        return evals, evecs

    def rdm(self, psi, which="A"):
        """Reduced density matrix of a pure state of the composite."""
        return ptrace(ket2dm(as_tensor(psi)), self.dims,
                      which="B" if which == "A" else "A")

    def spectrum(self, device=None):
        """(eigvals, eigvecs) of the composite, solved on ``device``."""
        if self.H is None:
            raise ValueError("Call getH() to compute the full Hamiltonian "
                             "first.")
        return self.eigenstates(device=device)

    def transform_basis(self, a, device=None):
        """Operator from the product basis to the eigenbasis: U† a U, with
        the eigenvectors of the last :meth:`eigenstates` (solved on
        ``device`` if there are none yet), on their device."""
        if self.eigvecs_ is None:
            self.eigenstates(device=device)
        U = self.eigvecs_
        a = as_tensor(a)
        dt = torch.promote_types(a.dtype, U.dtype)
        return transform(a.to(U.device, dt), U.to(dt))

    def purity(self, psi, which="A"):
        """tr(rdm^2) of a subsystem — 1 for a product state."""
        r = self.rdm(psi, which=which)
        return torch.trace(r @ r).real

    def get_nonhermH(self, a_ops=None, b_ops=None, g=0):
        """Composite non-Hermitian H from the subsystems' nonhermH plus
        V_AB = sum_i g_i a_i (x) b_i."""
        ha = (self.A.get_nonhermH() if hasattr(self.A, "get_nonhermH")
              else self.A.nonhermH)
        hb = (self.B.get_nonhermH() if hasattr(self.B, "get_nonhermH")
              else self.B.nonhermH)
        H = _kron(ha, self.idb) + _kron(self.ida, hb)
        if a_ops is not None:
            if not isinstance(a_ops, (list, tuple)):
                a_ops, b_ops, g = [a_ops], [b_ops], [g]
            for gi, a_op, b_op in zip(np.atleast_1d(g), a_ops, b_ops):
                H = H + gi.item() * _kron(as_tensor(a_op), as_tensor(b_op))
        self.nonhermH = H
        return H


class Polariton(Composite):
    """Molecule + cavity (reference: pyqed/polariton/cavity.py:577)."""

    def __init__(self, mol, cav, g=None, gauge="length"):
        super().__init__(mol, cav)
        self.mol = mol
        self.cav = cav
        self.dims = [mol.dim, cav.n_cav]
        self.dim = mol.dim * cav.n_cav
        self.nstates = self.dim
        self.gauge = gauge
        self._g = g
        self.H = None
        self.cav_leak = None

    @classmethod
    def from_reference(cls, ref):
        """The port's polariton with the molecule, cavity, coupling and
        gauge of a JAX Polariton ``ref`` (its Hamiltonian, if built, as
        NumPy)."""
        out = cls(Mol.from_reference(ref.mol),
                  Cavity.from_reference(ref.cav), g=ref.g, gauge=ref.gauge)
        if ref.H is not None:
            out.H = as_tensor(np.asarray(ref.H))
        return out

    @property
    def g(self):
        return self._g

    @g.setter
    def g(self, value):
        self._g = value

    def getH(self, RWA=False):
        """Light-matter Hamiltonian (reference:
        pyqed/polariton/cavity.py:608):

        length gauge:    H_int = i g mu (x) (a - a†) + g^2/w_c (mu·mu) (x) I
        (DSE included); RWA: g (sigma^+ (x) a + sigma^- (x) a†);
        velocity gauge:  p (x) A + I (x) A^2/2 with A = g/w_c (a + a†).
        """
        mol, cav = self.mol, self.cav
        omegac = cav.omegac
        edip = mol.edip
        Icav, Imol = cav.idm, mol.idm
        a = cav.annihilate()
        ad = dag(a)
        g = self._g
        if self.gauge in ("length", "dipole", "dip"):
            if RWA:
                hint = g * (_kron(mol.raising, a) + _kron(mol.lowering, ad))
            else:
                dse = g ** 2 / omegac * _kron(edip @ edip, Icav)
                hint = 1j * g * _kron(edip, a - ad) + dse
        elif self.gauge == "velocity":
            if mol.E is None:
                mol.E = mol.eigenenergies()
            # p_ij = -i m w_ij x_ij (reference: pyqed/mol.py:298)
            p = -1j * (mol.E[:, None] - mol.E[None, :]) * edip
            A = g / omegac * (a + ad)
            hint = _kron(p, A) + 0.5 * _kron(Imol, A @ A)
        else:
            raise ValueError(f"unknown gauge {self.gauge!r}")
        self.H = (_kron(mol.getH(), Icav).to(hint.dtype)
                  + _kron(Imol, cav.getH()).to(hint.dtype) + hint)
        return self.H

    get_ham = getH

    def setH(self, h):
        self.H = h

    def get_nonhermitianH(self, g=None, RWA=False):
        """(reference: pyqed/polariton/cavity.py:683)."""
        mol, cav = self.mol, self.cav
        if g is None:
            g = self._g
        hmol = mol.get_nonhermitianH()
        hcav = cav.get_nonhermitianH()
        if RWA:
            hint = g * (_kron(mol.raising, cav.annihilate())
                        + _kron(mol.lowering, cav.create()))
        else:
            hint = g * _kron(mol.dip, cav.create() + cav.annihilate())
        H = _kron(hmol, cav.idm) + _kron(mol.idm, hcav) + hint
        self.nonhermH = H
        return H

    def get_dm(self):
        """Product initial density matrix: molecular ground state x cavity
        vacuum."""
        return _kron(self.mol.get_dm(), self.cav.vacuum_dm())

    def get_edip(self, basis="product"):
        return _kron(self.mol.edip, self.cav.idm)

    get_dip = get_edip

    def get_cav_leak(self):
        """Collapse operator for cavity decay
        (reference: pyqed/polariton/cavity.py:726)."""
        if self.cav_leak is None:
            self.cav_leak = _kron(self.mol.idm, self.cav.annihilate())
        return self.cav_leak

    def eigenstates(self, k: Optional[int] = None, device=None):
        """Polariton spectrum and photon fractions, solved on ``device``
        (reference: pyqed/polariton/cavity.py:735)."""
        if self.H is None:
            raise ValueError("Please call getH() to compute the Hamiltonian "
                             "first.")
        evals, evecs = torch.linalg.eigh(self.H.to(resolve_device(device)))
        num_op = _kron(self.mol.idm, self.cav.num()).to(evecs.device,
                                                          evecs.dtype)
        n_ph = torch.einsum("ik, ij, jk -> k", evecs.conj(), num_op,
                            evecs).real
        self.eigvals_ = evals
        self.eigvecs_ = evecs
        if k is not None and k < self.dim:
            return evals[:k], evecs[:, :k], n_ph[:k]
        return evals, evecs, n_ph

    def promote_op(self, a, kind="mol"):
        if kind in ("mol", "m"):
            return _kron(as_tensor(a), self.cav.idm)
        if kind in ("cav", "c"):
            return _kron(self.mol.idm, as_tensor(a))
        raise ValueError(kind)

    def rdm_photon(self, psi):
        """Reduced photon density matrix."""
        return ptrace(ket2dm(as_tensor(psi)), self.dims, which="A")

    def driven_dynamics(self, psi0, pulse, dt=0.001, nt=1, e_ops=None,
                        nout=1, t0=0.0, device=None):
        """SESolver under H − E(t) μ ⊗ I on ``device`` (the card when
        None)."""
        from .mol import SESolver
        return SESolver(self.H, device=device).run(
            psi0=psi0, dt=dt, Nt=nt, e_ops=e_ops, nout=nout, t0=t0,
            pulse=pulse, edip=self.get_edip())


def QRM(omega0, omegac, ncav=2):
    """Quantum Rabi model / Jaynes-Cummings factory (reference:
    pyqed/cavity.py:741 ``QRM``): a two-level atom with transition
    frequency ``omega0`` and sigma_x dipole coupled to an ``ncav``-level
    cavity at ``omegac``. Returns a :class:`Polariton`; ``getH(RWA=...)``
    gives the Rabi (False) or Jaynes-Cummings (True) Hamiltonian."""
    from ..ops.operators import pauli
    s0, sx, sy, sz = pauli()
    mol = Mol(0.5 * omega0 * (-sz + s0), edip=sx)
    return Polariton(mol, Cavity(omegac, ncav))

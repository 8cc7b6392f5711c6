"""Multi-level system (`Mol`) (PyTorch).

Counterpart of ``Mol`` and ``mls`` in ``pyqed_tpu/models/mol.py``
(reference: pyqed/mol.py — ``Mol:184``, ``mls:1988``): the Hamiltonian,
transition dipoles, decay and dephasing of an N-level system, its
eigenstates, and the spectroscopy methods that hand it to
:mod:`pyqed_tpu_torch.signal.sos`.

The molecule's operators are tensors where they were given (CPU tensors
for array-likes); the spectroscopy methods take ``device`` and run there
(the card when None). Wave-function dynamics (``run``,
``quantum_dynamics``, ``driven_dynamics``, ``Floquet``) and ``SESolver``
belong to the polariton slice and are not yet ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import not_yet_ported
from ..ops.linalg import as_tensor, isdiag, obs
from ..ops.operators import basis
from ..units import au2ev


class Mol:
    """N-level system: Hamiltonian + transition dipole(s)
    (reference: pyqed/mol.py:184)."""

    def __init__(self, H, edip=None, lowering=None, edip_rms=None, gamma=None):
        self.H = as_tensor(H)
        self.E = torch.diagonal(self.H).real if isdiag(self.H) else None
        self.nonhermH = None
        self._edip = as_tensor(edip) if edip is not None else None
        self.dip = self._edip
        self._edip_rms = as_tensor(edip_rms) if edip_rms is not None else None
        if lowering is not None:
            self.lowering = as_tensor(lowering)
            self.raising = _conj_transpose(self.lowering)
        elif edip is not None:
            # default: split the dipole in the (ascending-energy) basis —
            # lowering connects high -> low, the strict upper triangle
            # (as in the JAX package)
            self.lowering = torch.triu(self._edip, diagonal=1)
            self.raising = _conj_transpose(self.lowering)
        else:
            self.lowering = self.raising = None
        self.nstates = self.dim = self.size = self.H.shape[0]
        self.idm = torch.eye(self.dim, dtype=self.H.dtype,
                             device=self.H.device)
        self.gamma = gamma
        self.mdip = None
        self.dephasing = 0.0

    # ---------------------------------------------------------------- dipole
    @property
    def edip(self):
        return self._edip

    @edip.setter
    def edip(self, edip):
        self._edip = as_tensor(edip)

    @property
    def edip_rms(self):
        """Root-mean-square dipole over Cartesian components
        (reference: pyqed/mol.py:287)."""
        if self._edip_rms is None:
            if self._edip is None:
                raise ValueError("edip not set")
            if self._edip.ndim == 3:
                self._edip_rms = torch.sqrt(
                    torch.sum(self._edip.abs() ** 2, dim=-1))
            else:
                self._edip_rms = self._edip.abs()
        return self._edip_rms

    @edip_rms.setter
    def edip_rms(self, v):
        self._edip_rms = as_tensor(v) if v is not None else None

    def set_dipole(self, dip):
        self.dip = as_tensor(dip)

    def set_edip(self, edip, pol=None):
        self.edip_rms = edip

    def set_mdip(self, mdip):
        self.mdip = mdip

    # ----------------------------------------------------------------- decay
    def set_decay_for_all(self, gamma):
        """The same decay rate for every state but the ground state."""
        g = [gamma] * self.nstates
        g[0] = 0.0
        self.gamma = np.asarray(g)

    def set_decay(self, gamma):
        self.gamma = np.asarray(gamma)

    def set_dephasing(self, gamma):
        self.dephasing = gamma

    def set_lifetime(self, tau):
        self.lifetime = tau

    def get_nonhermH(self):
        """H − i diag(gamma) (reference: pyqed/mol.py:417)."""
        if self.gamma is None:
            raise ValueError("Please set gamma first.")
        gamma = torch.as_tensor(np.asarray(self.gamma, dtype=float),
                                device=self.H.device)
        self.nonhermH = self.H - 1j * torch.diag(gamma)
        return self.nonhermH

    get_nonhermitianH = get_nonhermH

    def getH(self):
        return self.H

    def get_dip(self):
        return self.dip

    def get_edip(self):
        return self._edip

    def get_dm(self):
        """Ground-state density matrix |0><0| (reference: pyqed/mol.py:434)."""
        psi = self.groundstate()
        return torch.outer(psi, psi.conj())

    def get_p_from_r(self):
        """Momentum matrix from the position/dipole matrix,
        p_ij = i m (E_i - E_j) x_ij from p = i m [H, x] (the JAX package's
        sign; the reference's pyqed/mol.py:304 is inert)."""
        E = self.E if self.E is not None else self.eigenenergies()
        return 1j * (E[:, None] - E[None, :]) * self.edip

    # ----------------------------------------------------------- eigenstates
    def eigenenergies(self):
        return torch.linalg.eigvalsh(self.H)

    def eigvals(self):
        if isdiag(self.H):
            return torch.diagonal(self.H).real
        return torch.linalg.eigvalsh(self.H)

    def eigenstates(self, k=None):
        w, v = torch.linalg.eigh(self.H)
        if k is not None and k < self.dim:
            return w[:k], v[:, :k]
        return w, v

    def groundstate(self, method="trivial"):
        if method == "trivial":
            return basis(self.dim, 0, dtype=self.H.dtype).to(self.H.device)
        w, v = self.eigenstates(k=1)
        return v[:, 0]

    ground_state = groundstate

    def energy(self, psi):
        psi = as_tensor(psi)
        dt = torch.promote_types(psi.dtype, self.H.dtype)
        return obs(psi.to(dt), self.H.to(dt))

    # -------------------------------------------------------------- dynamics
    def run(self, *args, **kwargs):
        raise not_yet_ported("Mol.run")

    evolve = run

    def quantum_dynamics(self, *args, **kwargs):
        raise not_yet_ported("Mol.quantum_dynamics")

    def driven_dynamics(self, *args, **kwargs):
        raise not_yet_ported("Mol.driven_dynamics")

    def Floquet(self, *args, **kwargs):
        raise not_yet_ported("Mol.Floquet")

    def deom(self, bath, coupling=None, lmax=4, decomposition="pade",
             nexp=2, **kwargs):
        """Hierarchical-equations-of-motion solver for this system in
        `bath` (reference: pyqed/mol.py Mol.deom -> DEOMSolver).

        `coupling`: system operator(s) the bath couples to (defaults to
        the dipole). Returns a :class:`~pyqed_tpu_torch.open.heom.HEOMSolver`
        (``device`` among ``kwargs``: the card when None)."""
        from ..open.heom import HEOMSolver
        if coupling is None:
            coupling = self.edip
        ops = coupling if isinstance(coupling, (list, tuple)) else [coupling]
        if hasattr(bath, "set_bath_ops") and getattr(bath, "bath_ops", None) is None:
            bath.set_bath_ops([as_tensor(o).to(torch.complex128) for o in ops])
        return HEOMSolver(self.H.to(torch.complex128), bath=bath, lmax=lmax,
                          decomposition=decomposition, nexp=nexp, **kwargs)

    def multi(self, nmol=2):
        """Direct-product aggregate of `nmol` identical copies:
        H_tot = sum_n 1x..xHx..x1 and the total dipole likewise
        (reference: pyqed/mol.py Mol.multi). Returns (H_tot, edip_tot)."""
        H, I, edip = self.H, self.idm, self.edip

        def embed(op, n):
            ops = [I.to(op.dtype)] * nmol
            ops[n] = op
            out = ops[0]
            for o in ops[1:]:
                out = torch.kron(out, o)
            return out

        h_tot = sum(embed(H, n) for n in range(nmol))
        edip_tot = sum(embed(edip, n) for n in range(nmol))
        return h_tot, edip_tot

    # ---------------------------------------------------------- spectroscopy
    def absorption(self, omegas, method="sos", **kwargs):
        """Linear absorption (reference: pyqed/mol.py:766)."""
        from ..signal.sos import absorption as sos_absorption
        return sos_absorption(self, omegas, **kwargs)

    def PE(self, pump, probe, t2=0.0, **kwargs):
        from ..signal.sos import photon_echo
        return photon_echo(self, pump=pump, probe=probe, t2=t2, **kwargs)

    photon_echo = PE

    def PE2(self, omega1, omega2, t3=0.0, **kwargs):
        from ..signal.sos import photon_echo_t3
        return photon_echo_t3(self, omega1=omega1, omega2=omega2, t3=t3,
                              **kwargs)

    def cars(self, *args, **kwargs):
        """Not defined: ``pyqed_tpu/models/mol.py:267-269`` hands the
        molecule to ``sos.cars`` where the energies belong, a TypeError
        there; the port does not invent a meaning for it."""
        raise NotImplementedError(
            "Mol.cars passes the molecule where sos.cars takes the "
            "energies (pyqed_tpu/models/mol.py:267-269); call "
            "signal.sos.cars(E, edip, shift, omega1) instead")

    def tpa(self, *args, **kwargs):
        """Not defined: ``pyqed_tpu/models/mol.py:271-273`` hands the
        molecule to ``sos.TPA`` where the energies belong, a TypeError
        there; the port does not invent a meaning for it."""
        raise NotImplementedError(
            "Mol.tpa passes the molecule where sos.TPA takes the energies "
            "(pyqed_tpu/models/mol.py:271-273); call "
            "signal.sos.TPA(E, dip, omegap, ...) instead")


def _conj_transpose(a):
    """The conjugate with every axis reversed, as the JAX package's
    ``dag`` (``.conj().T``) gives it: the Hermitian conjugate of an
    operator; for a (n, n, 3) Cartesian dipole, (3, n, n)."""
    return a.conj().permute(*reversed(range(a.ndim))).resolve_conj()


class SESolver:
    """Time-dependent Schrödinger equation solver: not yet ported (the
    polariton slice)."""

    def __init__(self, *args, **kwargs):
        raise not_yet_ported("SESolver")


def mls(dim=3):
    """A simple 3-level model system (reference: pyqed/mol.py:1988)."""
    E = np.array([0.0, 0.6, 10.0]) / au2ev
    dip = np.zeros((3, 3))
    dip[1, 2] = dip[2, 1] = dip[0, 1] = dip[1, 0] = 1.0
    return Mol(np.diag(E), edip=dip)

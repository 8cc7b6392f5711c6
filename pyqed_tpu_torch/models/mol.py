"""Multi-level system (`Mol`) (PyTorch).

Counterpart of ``Mol`` and ``mls`` in ``pyqed_tpu/models/mol.py``
(reference: pyqed/mol.py — ``Mol:184``, ``mls:1988``): the Hamiltonian,
transition dipoles, decay and dephasing of an N-level system, its
eigenstates, and the spectroscopy methods that hand it to
:mod:`pyqed_tpu_torch.signal.sos`.

The molecule's operators are tensors where they were given (CPU tensors
for array-likes); the spectroscopy and dynamics methods take ``device``
and run there (the card when None).

``SESolver`` propagates the time-dependent Schrödinger equation with RK4
(or, for a constant H, ``method='expm'``: one eigendecomposition, then a
diagonal phase per step) through :func:`~pyqed_tpu_torch.core.dynamics.
run_solver`. The driven form is H(t) = H0 − Σ_k E_k(t) μ_k (reference:
pyqed/mol.py:1905); the fields are evaluated on the host, once per RK4
stage, as Python floats.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import complex_dtype_for, resolve_device
from ..core.dynamics import rk4_step_t, run_solver
from ..core.result import Result
from ..ops.linalg import as_tensor, dag, isdiag, obs
from ..ops.operators import basis
from ..units import au2ev


def tdse(psi, H):
    """RHS of the TDSE: -i H psi (reference: pyqed/mol.py:1322)."""
    return -1j * (H @ psi)


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

    @classmethod
    def from_reference(cls, ref):
        """The port's Mol with the arrays of a JAX Mol ``ref``: its H,
        dipole, lowering operator, rms dipole and decay rates."""
        def host(a):
            return None if a is None else np.asarray(a)
        m = cls(host(ref.H), edip=host(ref.edip),
                lowering=host(getattr(ref, "lowering", None)),
                edip_rms=host(ref._edip_rms), gamma=host(ref.gamma))
        m.dephasing = ref.dephasing
        return m

    # -------------------------------------------------------------- dynamics
    def run(self, psi0=None, dt=0.01, e_ops=None, nt=1, Nt=None, nout=1,
            t0=0.0, pulse=None, edip=None, method="rk4", store_states=True,
            device=None):
        """Wave-function dynamics under H, or under H − E(t) μ with a
        ``pulse`` (μ the molecule's dipole unless ``edip`` is given), on
        ``device`` (reference: pyqed/mol.py:628)."""
        nt = Nt if Nt is not None else nt
        if psi0 is None:
            psi0 = self.groundstate()
        if pulse is not None and edip is None:
            edip = self.edip
        return SESolver(self.H, device=device).run(
            psi0=psi0, dt=dt, Nt=nt, e_ops=e_ops, nout=nout, t0=t0,
            pulse=pulse, edip=edip, method=method, store_states=store_states)

    evolve = run

    def quantum_dynamics(self, psi0, dt=0.001, Nt=1, e_ops=None, nout=1,
                         t0=0.0, device=None):
        return SESolver(self.H, device=device).run(
            psi0=psi0, dt=dt, Nt=Nt, e_ops=e_ops, nout=nout, t0=t0)

    def driven_dynamics(self, psi0, pulse, dt=0.001, Nt=1, e_ops=None,
                        nout=1, t0=0.0, device=None):
        return SESolver(self.H, device=device).run(
            psi0=psi0, dt=dt, Nt=Nt, e_ops=e_ops, nout=nout, t0=t0,
            pulse=pulse, edip=self.edip)

    def Floquet(self, omegad, E0, nt=31, device=None):
        """Sambe-space Floquet treatment of this system under the drive
        H0 − E0 cos(omegad t) μ (:class:`pyqed_tpu_torch.floquet.Floquet`)."""
        from ..floquet import Floquet as _Floquet
        return _Floquet(self.H, self.edip, omegad, E0, nt=nt, device=device)

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
    """Time-dependent Schrödinger equation solver on ``device`` (the card
    when None; reference: pyqed/mol.py:1369)."""

    def __init__(self, H=None, device=None):
        self.device = resolve_device(device)
        self.H = None if H is None else as_tensor(H).to(self.device)
        self.groundstate = None

    def run(self, psi0=None, dt=0.01, Nt=1, e_ops=None, nout=1, t0=0.0,
            edip=None, pulse=None, method="rk4", store_states=True,
            nt=None) -> Result:
        """Propagate ``psi0`` for ``Nt`` steps of ``dt`` (``nt`` is an
        alias), sampling every ``nout``. Without a pulse ``method`` is
        'rk4' or 'expm'; with one, RK4 under H(t) = H0 − Σ_k E_k(t) μ_k,
        where ``pulse`` is a pulse (its ``efield`` is used) or a callable
        of a float that returns a float, or a list of them, one per dipole
        in ``edip``."""
        if nt is not None:
            Nt = nt
        if psi0 is None:
            psi0 = self.groundstate
        psi0 = as_tensor(psi0).to(self.device)
        H0 = self.H
        cdtype = complex_dtype_for(H0, psi0)
        psi0 = psi0.to(cdtype)
        H0 = H0.to(cdtype)

        if pulse is None:
            if method == "expm":
                # exact stepping: psi -> V e^{-i w dt} V† psi
                w, V = torch.linalg.eigh(H0)
                phase = torch.exp(-1j * w * dt)
                Vh = dag(V)

                def step(psi, t):
                    return V @ (phase * (Vh @ psi))
            else:
                rk4 = rk4_step_t(lambda y, tt: -1j * (H0 @ y))

                def step(psi, t):
                    return rk4(psi, t, dt)
        else:
            pulses = pulse if isinstance(pulse, (list, tuple)) else [pulse]
            if edip is None:
                raise ValueError(
                    "Electric dipole must be provided for laser-driven "
                    "dynamics.")
            edips = (edip if isinstance(edip, (list, tuple))
                     else [edip] * len(pulses))
            edips = [as_tensor(d).to(self.device, cdtype) for d in edips]
            fields = [p.efield if hasattr(p, "efield") else p
                      for p in pulses]

            def Ht(t):
                H = H0
                for d, E in zip(edips, fields):
                    H = H - float(E(t)) * d
                return H

            rk4 = rk4_step_t(lambda y, tt: -1j * (Ht(tt) @ y))

            def step(psi, t):
                return rk4(psi, t, dt)

        return run_solver(step, psi0, dt, Nt, e_ops=e_ops, nout=nout, t0=t0,
                          store_states=store_states, is_dm=False)

    def propagator(self, dt, Nt, method="diag"):
        from ..ops.expm import propagators
        return propagators(self.H, dt, Nt, method=method)

    # ---------------------------------------------------- correlation suite
    def _ops(self, *ops):
        """The operators and states as tensors of one complex dtype on the
        solver's device."""
        dtype = complex_dtype_for(self.H, *ops)
        return [as_tensor(o).to(self.device, dtype) for o in ops]

    def correlation_3op_1t(self, psi0, oplist, dt, Nt):
        """<A B(t) C> (reference: pyqed/mol.py:1475). Returns (Nt,)."""
        psi0, a_op, b_op, c_op = self._ops(psi0, *oplist)
        ket = self.run(psi0=c_op @ psi0, dt=dt, Nt=Nt).states
        bra = self.run(psi0=dag(a_op) @ psi0, dt=dt, Nt=Nt).states
        return torch.einsum("ti, ij, tj -> t", bra.conj(), b_op, ket)[:Nt]

    def correlation_2op_1t(self, psi0, oplist, dt, Nt):
        a_op, b_op = oplist
        eye = torch.eye(self.H.shape[0], dtype=self.H.dtype)
        return self.correlation_3op_1t(psi0, [a_op, b_op, eye], dt, Nt)

    def correlation_3op_2t(self, psi0, oplist, dt, Nt, Ntau):
        """<A(t) B(t+tau) C(t)> (reference: pyqed/mol.py:1503): one pair
        of Ntau-step runs per t. Returns (Nt, Ntau)."""
        psi0, a_op, b_op, c_op = self._ops(psi0, *oplist)
        psi_t = self.run(psi0=psi0, dt=dt, Nt=Nt).states[:Nt]
        rows = []
        for psi in psi_t:
            ket = self.run(psi0=c_op @ psi, dt=dt, Nt=Ntau).states[:Ntau]
            bra = self.run(psi0=dag(a_op) @ psi, dt=dt, Nt=Ntau).states[:Ntau]
            rows.append(torch.einsum("ti, ij, tj -> t", bra.conj(), b_op,
                                     ket))
        return torch.stack(rows)

    def correlation_4op_1t(self, psi0, oplist, dt=0.005, Nt=1):
        a, b, c, d = self._ops(*oplist)
        return self.correlation_3op_1t(psi0, [a, b @ c, d], dt, Nt)

    def correlation_4op_2t(self, psi0, oplist, dt=0.005, Nt=1, Ntau=1):
        a, b, c, d = self._ops(*oplist)
        return self.correlation_3op_2t(psi0, [a, b @ c, d], dt, Nt, Ntau)


def quantum_dynamics(ham, psi0, dt=0.001, Nt=1, obs_ops=None, nout=1,
                     t0=0.0, device=None):
    """Field-free TDSE propagation, reference drop-in (reference:
    pyqed/phys.py:1325): a :class:`SESolver` run returning a Result."""
    return SESolver(ham, device=device).run(psi0=psi0, dt=dt, Nt=Nt,
                                            e_ops=obs_ops, nout=nout, t0=t0)


def driven_dynamics(ham, dip, psi0, pulse, dt=0.001, Nt=1, obs_ops=None,
                    nout=1, t0=0.0, device=None):
    """Laser-driven TDSE propagation, reference drop-in (reference:
    pyqed/phys.py:1393): H(t) = H - E(t) mu."""
    return SESolver(ham, device=device).run(
        psi0=psi0, dt=dt, Nt=Nt, e_ops=obs_ops, nout=nout, t0=t0,
        pulse=pulse, edip=dip)


def read_input(fname_e, fname_edip, g_included=True):
    """Read energy levels and Cartesian dipole-moment files of a quantum
    chemistry output (reference: pyqed/mol.py read_input). Returns
    (E (nstates,), edip (nstates, nstates, 3)) as NumPy arrays."""
    E = np.genfromtxt(fname_e)
    if not g_included:
        E = np.insert(E, 0, 0.0)
    nstates = len(E)
    edip = np.zeros((nstates, nstates, 3))
    for k in range(3):
        edip[:, :, k] = np.genfromtxt(fname_edip[k], unpack=False)
    return E, edip


def mls(dim=3):
    """A simple 3-level model system (reference: pyqed/mol.py:1988)."""
    E = np.array([0.0, 0.6, 10.0]) / au2ev
    dip = np.zeros((3, 3))
    dip[1, 2] = dip[2, 1] = dip[0, 1] = dip[1, 0] = 1.0
    return Mol(np.diag(E), edip=dip)

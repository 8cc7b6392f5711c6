"""Open-quantum-system front door (PyTorch).

PyTorch counterpart of ``pyqed_tpu/open/oqs.py`` (reference:
pyqed/oqs.py:574, a holder class whose dispatch stubs are dead there):
one object holding (H, c_ops, e_ops) that dispatches to the port's
Lindblad, Redfield, TCL2 and HEOM solvers on ``device`` (the card when
None, raises without one). ``lindblad`` runs the commutator kernel and
``heom`` the coupling kernel on the card, as those solvers do.
"""
from __future__ import annotations

from ..config import resolve_device
from ..ops.linalg import as_tensor
from .heom import HEOMSolver
from .lindblad import LindbladSolver
from .redfield import RedfieldSolver
from .tcl import TCL2Solver


class OQS:
    """Open quantum system: system Hamiltonian + environment couplings
    (reference: pyqed/oqs.py:574)."""

    def __init__(self, H, c_ops=None, e_ops=None, device=None):
        self.device = resolve_device(device)
        self.set_hamiltonian(H)
        self.c_ops = c_ops
        self.e_ops = e_ops

    # -- reference setter surface (pyqed/oqs.py:592-608) -----------------
    def set_hamiltonian(self, h):
        self.H = as_tensor(h)
        self.nstates = self.H.shape[-1]

    def setH(self, h):
        self.set_hamiltonian(h)

    def set_c_ops(self, c_ops):
        self.c_ops = c_ops

    def set_e_ops(self, e_ops):
        self.e_ops = e_ops

    def configure(self, c_ops, e_ops):
        self.c_ops = c_ops
        self.e_ops = e_ops

    # -- solver dispatch --------------------------------------------------
    def _e_ops(self, e_ops):
        return e_ops if e_ops is not None else self.e_ops

    def lindblad(self, rho0, dt, nt, e_ops=None, **kwargs):
        solver = LindbladSolver(self.H, c_ops=self.c_ops,
                                e_ops=self._e_ops(e_ops), device=self.device)
        return solver.run(rho0, dt, nt, **kwargs)

    def redfield(self, rho0, dt, nt, a_ops=None, c_ops=None, spectra=None,
                 e_ops=None, **kwargs):
        solver = RedfieldSolver(
            self.H, a_ops=a_ops,
            c_ops=c_ops if c_ops is not None else self.c_ops,
            spectra=spectra, device=self.device)
        return solver.run(rho0, dt, nt, e_ops=self._e_ops(e_ops), **kwargs)

    def tcl2(self, rho0, dt, nt, c_op=None, bath=None, corr=None,
             e_ops=None, **kwargs):
        if c_op is None:
            if self.c_ops is not None and len(self.c_ops) == 1:
                c_op = self.c_ops[0]
            else:
                raise ValueError(
                    "tcl2 requires a single coupling operator: pass c_op=, or "
                    "construct OQS with exactly one entry in c_ops")
        solver = TCL2Solver(self.H, c_op, bath=bath, corr=corr,
                            device=self.device)
        return solver.run(rho0, dt, nt, e_ops=self._e_ops(e_ops), **kwargs)

    def heom(self, rho0, dt, nt, bath=None, lmax=4, e_ops=None, c_ops=None,
             **kwargs):
        solver = HEOMSolver(self.H, bath=bath, lmax=lmax,
                            c_ops=c_ops if c_ops is not None else self.c_ops,
                            device=self.device)
        return solver.run(rho0, dt, nt, e_ops=self._e_ops(e_ops), **kwargs)

    def correlation_2p_1t(self, rho0, ops, dt, nt, method="lindblad"):
        """<A(t) B(0)> through the Lindblad solver
        (reference: pyqed/oqs.py:657 — lindblad only there)."""
        if method != "lindblad":
            raise ValueError(f"unsupported method {method!r}; use 'lindblad'")
        solver = LindbladSolver(self.H, c_ops=self.c_ops, device=self.device)
        return solver.correlation_2op_1t(rho0, ops[0], ops[1], dt, nt)

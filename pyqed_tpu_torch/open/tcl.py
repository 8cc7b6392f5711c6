"""Second-order time-convolutionless (TCL2, time-dependent Redfield)
master equation (PyTorch).

PyTorch counterpart of ``pyqed_tpu/open/tcl.py`` (reference: pyqed/oqs.py
— ``make_lambda:990``, the commented ``tcl2`` entry point :689):

  d rho/dt = -i[H, rho] - [S, Lambda(t) rho - rho Lambda(t)^dag],
  Lambda(t) = int_0^t dtau C(tau) S(-tau),

with Lambda on the whole time grid from one cumulative trapezoid over the
interaction-picture operators, and an RK4 loop on the device that writes
every step's observables into a preallocated tensor.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import resolve_device
from ..core.result import Result
from ..ops.linalg import as_tensor
from .bath import DrudeBath


class TCL2Solver:
    """(reference: pyqed/oqs.py:990 and its commented tcl2 stubs).

    ``corr(t)``: the bath correlation function C(t) of a NumPy array of
    times (or pass a :class:`DrudeBath`: its 100-term Matsubara series).
    ``device``: the card when None (raises without one), ``"cpu"`` on
    request."""

    def __init__(self, H, c_op, bath: DrudeBath = None, corr: Callable = None,
                 device=None):
        self.device = resolve_device(device)
        self.H = as_tensor(H, device=self.device).to(torch.complex128)
        self.S = as_tensor(c_op, device=self.device).to(torch.complex128)
        if corr is None:
            if bath is None:
                raise ValueError("need bath or corr")
            c, nu = bath.matsubara(100)
            corr = lambda t: np.sum(c[:, None]                  # noqa: E731
                                    * np.exp(-np.outer(nu, np.atleast_1d(t))),
                                    axis=0)
        self.corr = corr

    def lambda_op(self, tgrid):
        """Lambda(t_k) for every grid time, (len(tgrid), n, n): S(-tau)
        in the eigenbasis of H and a cumulative trapezoid over tau
        (reference: pyqed/oqs.py:990)."""
        dev = self.device
        w, V = torch.linalg.eigh(self.H)
        tgrid = np.asarray(tgrid)
        dt = tgrid[1] - tgrid[0]
        Ct = torch.as_tensor(np.asarray(self.corr(tgrid)),
                             device=dev).to(torch.complex128)
        t = torch.as_tensor(tgrid, dtype=torch.float64, device=dev)
        phases = torch.exp(-1j * w[None, :] * t[:, None])        # (nt, n)
        Seb = V.mH @ self.S @ V
        Smt = phases[:, :, None] * Seb * phases.conj()[:, None, :]
        integrand = Ct[:, None, None] * Smt
        csum = torch.cumsum((integrand[1:] + integrand[:-1]) / 2 * dt, dim=0)
        lam_eb = torch.cat([torch.zeros_like(Seb)[None], csum])
        return V @ lam_eb @ V.mH

    def run(self, rho0, dt, nt, e_ops=None, nout=1) -> Result:
        """RK4 for ``nt`` steps of ``dt``. As in the JAX package, every
        step is recorded (``observables`` is (nt+1, k) on t = 0..nt dt) and
        ``nout`` is accepted and unused."""
        dev = self.device
        tgrid = np.arange(nt + 1) * dt
        lams = self.lambda_op(tgrid)
        lam_mid = (lams[:-1] + lams[1:]) / 2
        H, S = self.H, self.S
        rho0 = as_tensor(rho0, device=dev).to(torch.complex128)
        eops = (torch.stack([as_tensor(e, device=dev).to(torch.complex128)
                             for e in e_ops]) if e_ops else None)

        def rhs(rho, lam):
            X = lam @ rho - rho @ lam.mH
            return -1j * (H @ rho - rho @ H) - (S @ X - X @ S)

        obs = None
        if eops is not None:
            obs = torch.empty((nt + 1, eops.shape[0]), dtype=torch.complex128,
                              device=dev)
            obs[0] = torch.einsum("kij, ji -> k", eops, rho0)
        rho = rho0
        for k in range(nt):
            k1 = rhs(rho, lams[k])
            k2 = rhs(rho + k1 * dt / 2, lam_mid[k])
            k3 = rhs(rho + k2 * dt / 2, lam_mid[k])
            k4 = rhs(rho + k3 * dt, lams[k + 1])
            rho = rho + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            if obs is not None:
                obs[k + 1] = torch.einsum("kij, ji -> k", eops, rho)
        res = Result(times=torch.as_tensor(tgrid, device=dev), dt=dt, nt=nt)
        res.observables = obs
        res.rho = rho
        res.rho0 = rho0
        return res

"""Ehrenfest mixed quantum-classical nonadiabatic dynamics (PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/ehrenfest.py`` (reference:
pyqed/namd/ehrenfest.py, an unfinished sketch there). Classical nuclei
and TDSE electrons with the mean-field force,

    i dc/dt   = V(x(t)) c
    m d2x/dt2 = - <c| dV/dx |c> / <c|c>,

integrated with RK4 on the joint (x, p, c) state of the whole ensemble at
once: every quantity is a batched ``(ntraj, ...)`` tensor and one Python
loop runs the steps, where the JAX package ``vmap``s a per-trajectory
``lax.scan``; on CUDA the RK4 step runs as one CUDA graph. ``dv``
defaults to ``torch.func.jacfwd`` of the potential under
``torch.func.vmap`` (one pass gives V and dV), so ``v`` must be written
in torch operations.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..core.dynamics import cuda_graph_stepper
from ..core.result import Result
from ..ops.linalg import as_tensor
from .fssh import batched_potential


class Ehrenfest:
    """Mean-field (Ehrenfest) trajectories on a diabatic model.

    Parameters
    ----------
    v : callable x (ndim,) -> (ns, ns) diabatic potential matrix (real or
        complex Hermitian), written in torch operations.
    dv : callable x -> (ndim, ns, ns) gradient; default
        ``torch.func.jacfwd(v)``.
    mass : scalar or (ndim,) nuclear masses.
    device : the card when None (raises without one); ``"cpu"`` on
        request.
    """

    def __init__(self, v: Callable, dv: Optional[Callable] = None,
                 mass=1.0, nstates: int = 2, ndim: int = 1, device=None):
        self.device = resolve_device(device)
        self.v = v
        self.dv = dv
        self._vdv = batched_potential(v, dv)
        self.mass = torch.as_tensor(
            np.atleast_1d(np.asarray(mass, dtype=float)), device=self.device)
        self.nstates = nstates
        self.ndim = ndim

    # ------------------------------------------------------------------ rhs
    def _rhs(self, x, p, c):
        V, dV = self._vdv(x)                # (B, ns, ns), (B, ndim, ns, ns)
        V, dV = V.to(c.dtype), dV.to(c.dtype)
        nrm = (c.conj() * c).real.sum(-1)
        F = -torch.einsum("ba, bdac, bc -> bd", c.conj(), dV, c).real \
            / nrm[:, None]
        return p / self.mass, F, -1j * torch.einsum("bac, bc -> ba", V, c)

    def _step(self, state, dt):
        x, p, c = state
        k1 = self._rhs(x, p, c)
        k2 = self._rhs(x + 0.5 * dt * k1[0], p + 0.5 * dt * k1[1],
                       c + 0.5 * dt * k1[2])
        k3 = self._rhs(x + 0.5 * dt * k2[0], p + 0.5 * dt * k2[1],
                       c + 0.5 * dt * k2[2])
        k4 = self._rhs(x + dt * k3[0], p + dt * k3[1], c + dt * k3[2])
        return tuple(y + dt / 6 * (a + 2 * b + 2 * e + f)
                     for y, a, b, e, f in zip(state, k1, k2, k3, k4))

    def energy(self, x, p, c):
        """Conserved Ehrenfest energy p^2/2m + <c|V|c>/<c|c>, per
        trajectory (x, p (B, ndim), c (B, ns))."""
        V = torch.func.vmap(self.v)(x).to(c.dtype)
        nrm = (c.conj() * c).real.sum(-1)
        return ((p ** 2 / (2 * self.mass)).sum(-1)
                + torch.einsum("ba, bac, bc -> b", c.conj(), V, c).real
                / nrm)

    # ------------------------------------------------------------------ run
    def run(self, x0, p0, c0, dt=0.01, nt=100, nout=1) -> Result:
        """Propagate an ensemble: x0/p0 (ntraj, ndim), c0 (ntraj, ns)
        (each made at least 2-D, as ``jnp.atleast_2d`` does).

        Returns a Result with ``x``, ``p``, ``c`` (nsnap, ntraj, ...),
        ``population`` (nsnap, ntraj, ns) and ``energy`` (nsnap, ntraj),
        on the solver's device."""
        dev = self.device
        x = torch.atleast_2d(as_tensor(x0, torch.float64, dev))
        p = torch.atleast_2d(as_tensor(p0, torch.float64, dev))
        c = torch.atleast_2d(as_tensor(c0, torch.complex128, dev))
        nwin = nt // nout
        xs = torch.empty((nwin,) + tuple(x.shape), dtype=x.dtype, device=dev)
        ps = torch.empty_like(xs)
        cs = torch.empty((nwin,) + tuple(c.shape), dtype=c.dtype, device=dev)
        es = torch.empty((nwin, x.shape[0]), dtype=x.dtype, device=dev)
        advance = cuda_graph_stepper(lambda s: self._step(s, dt), (x, p, c))
        for w in range(nwin):
            for _ in range(nout):
                state = advance()
            xs[w], ps[w], cs[w] = state
            es[w] = self.energy(*state)
        res = Result(dt=dt, nt=nt, nout=nout)
        res.times = torch.arange(1, nwin + 1, dtype=torch.float64,
                                 device=dev) * dt * nout
        res.x, res.p, res.c = xs, ps, cs
        pc = cs.abs() ** 2
        res.population = pc / pc.sum(-1, keepdim=True)
        res.energy = es
        return res

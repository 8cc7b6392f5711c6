"""Monte-Carlo wave function (quantum-jump) unravelling of the Lindblad
equation (PyTorch).

PyTorch counterpart of ``pyqed_tpu/open/mcwf.py`` (Dalibard, Castin &
Mølmer, PRL 68, 580 (1992); the reference has no stochastic unravelling).
Pure states (memory n, not n²) whose ensemble average reproduces the
Lindblad density matrix as ntraj -> inf.

The no-jump evolution is the exact effective propagator
U_eff = exp(-i H_eff dt), H_eff = H - (i/2) Σ_k c_k† c_k, built once on
the device by Padé scaling and squaring; all trajectories advance together as one (ntraj, n) state, with the jump
test, the channel choice (inverse CDF over the weights ||c_k psi||², as
``jax.random.choice(p=)`` draws it) and the collapse as branch-free tensor
arithmetic. The random numbers are two (ntraj, nt) uniform draws from a
``torch.Generator`` seeded by the integer ``key``, made on the CPU and
moved to the device, so the card and the CPU see the same numbers. They
cannot reproduce the JAX package's key splits; :func:`_trajectories`
takes the draws as arguments, so JAX's own can be fed to it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..core.result import Result
from ..ops.linalg import as_tensor
from ..ops.expm import expm_pade


def _trajectories(U, cs, psi0, A, r, u2, nout):
    """Advance ``r.shape[0]`` trajectories from ``psi0`` for
    ``r.shape[1]`` steps of the no-jump propagator ``U``.

    cs: (nc, n, n) jump operators or None; A: (k, n, n) observables or
    None; r, u2: (ntraj, nt) uniform draws on the device, r for the jump
    test (a jump when r > ||U psi||²) and u2 for the channel, chosen as
    the first k with cumsum(p)_k >= cumsum(p)[-1] (1 - u2). Returns
    (observables (ntraj, nt // nout, k) or None, cumulative jump counts
    (ntraj, nt // nout) int32)."""
    ntraj, nt = r.shape
    nwin = nt // nout
    psi = psi0.expand(ntraj, -1).clone()
    UT = U.T
    nj = torch.zeros(ntraj, dtype=torch.int32, device=psi.device)
    obs = (torch.empty((ntraj, nwin, A.shape[0]), dtype=psi.dtype,
                       device=psi.device) if A is not None else None)
    njs = torch.empty((ntraj, nwin), dtype=torch.int32, device=psi.device)
    rows = torch.arange(ntraj, device=psi.device)
    for w in range(nwin):
        for i in range(w * nout, (w + 1) * nout):
            phi = psi @ UT
            p_nojump = (phi.conj() * phi).real.sum(dim=1)
            phi = phi / torch.sqrt(p_nojump)[:, None]
            if cs is None:
                psi = phi
                continue
            cpsi = torch.einsum("kij, tj -> tki", cs, psi)     # (ntraj, nc, n)
            wts = (cpsi.conj() * cpsi).real.sum(dim=2)         # (ntraj, nc)
            wsum = wts.sum(dim=1)
            cum = torch.cumsum(wts / torch.clamp(wsum, min=1e-300)[:, None],
                               dim=1)
            target = cum[:, -1] * (1 - u2[:, i])
            ch = torch.searchsorted(cum, target[:, None]).clamp_(
                max=cum.shape[1] - 1)[:, 0]
            collapsed = cpsi[rows, ch] / torch.clamp(
                torch.sqrt(wts[rows, ch]), min=1e-150)[:, None]
            # dark state (every c_k psi = 0): never jump there
            jump = (r[:, i] > p_nojump) & (wsum > 0.0)
            psi = torch.where(jump[:, None], collapsed, phi)
            nj = nj + jump.to(torch.int32)
        if obs is not None:
            obs[:, w] = torch.einsum("ti, aij, tj -> ta", psi.conj(), A, psi)
        njs[:, w] = nj
    return obs, njs


class MCWFSolver:
    """Quantum-jump unravelling of drho/dt = -i[H, rho] + Σ_k D[c_k].

    Per step (exact no-jump propagation, first order in the jump
    probability): phi = U_eff psi; with probability 1 - ||phi||² a jump
    occurs, channel k chosen with weight ||c_k psi||² and
    psi -> c_k psi / ||c_k psi||, else psi -> phi / ||phi||. ``device``:
    the card when None (raises without one), ``"cpu"`` on request."""

    def __init__(self, H, c_ops: Sequence = (), device=None):
        self.device = resolve_device(device)
        self.H = as_tensor(H, device=self.device).to(torch.complex128)
        self.c_ops = (torch.stack([as_tensor(c, device=self.device).to(
            torch.complex128) for c in c_ops]) if len(c_ops) else None)
        self.n = self.H.shape[0]

    def _u_eff(self, dt):
        """exp(-i H_eff dt) by Padé scaling and squaring on the device
        (:func:`~pyqed_tpu_torch.ops.expm.expm_pade`, the algorithm of
        jax.scipy.linalg.expm)."""
        Heff = self.H
        if self.c_ops is not None:
            Heff = Heff - 0.5j * torch.einsum("kij, kil -> jl",
                                              self.c_ops.conj(), self.c_ops)
        return expm_pade(-1j * dt * Heff)

    def run(self, psi0, dt=0.01, nt=100, ntraj=500, nout=1, key=0,
            e_ops: Optional[Sequence] = None) -> Result:
        """Propagate ``ntraj`` trajectories from psi0 with the draws of
        ``torch.Generator().manual_seed(key)`` (an integer).

        Result: ``observables`` (nsnap, k), the trajectory average of
        <psi|A|psi> after each window of ``nout`` steps;
        ``observables_std``, the complex Monte-Carlo standard error
        (std(Re) + i std(Im)) / sqrt(ntraj); ``njumps`` (nsnap, ntraj),
        cumulative jump counts."""
        if not isinstance(key, (int, np.integer)):
            raise TypeError("key must be an integer seed")
        dev = self.device
        psi0 = as_tensor(psi0, device=dev).to(torch.complex128)
        psi0 = psi0 / torch.linalg.vector_norm(psi0)
        nsteps = (nt // nout) * nout
        gen = torch.Generator().manual_seed(int(key))
        r = torch.rand((ntraj, nsteps), generator=gen,
                       dtype=torch.float64).to(dev)
        u2 = torch.rand((ntraj, nsteps), generator=gen,
                        dtype=torch.float64).to(dev)
        A = (torch.stack([as_tensor(a, device=dev).to(torch.complex128)
                          for a in e_ops]) if e_ops else None)
        obs, njumps = _trajectories(self._u_eff(dt), self.c_ops, psi0, A, r,
                                    u2, nout)
        return _result(obs, njumps, dt, nt, nout, ntraj)


def _result(obs, njumps, dt, nt, nout, ntraj):
    res = Result(dt=dt, nt=nt, nout=nout)
    res.times = torch.arange(1, nt // nout + 1, dtype=torch.float64,
                             device=njumps.device) * dt * nout
    if obs is not None:
        res.observables = obs.mean(dim=0)
        res.observables_std = ((obs.real.std(dim=0, correction=0)
                                + 1j * obs.imag.std(dim=0, correction=0))
                               / np.sqrt(ntraj))
    res.njumps = njumps.T
    return res


def mcsolve(H, psi0, c_ops=(), e_ops=(), dt=0.01, nt=100, ntraj=500,
            nout=1, key=0, device=None):
    """QuTiP-style front end of :class:`MCWFSolver`."""
    return MCWFSolver(H, c_ops, device=device).run(
        psi0, dt=dt, nt=nt, ntraj=ntraj, nout=nout, key=key,
        e_ops=list(e_ops))

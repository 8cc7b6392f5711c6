"""Diffusion and variational Monte Carlo with walker-parallel steps.

Counterpart of ``pyqed_tpu/qmc/dmc.py``. All walkers advance as one
batched tensor; branching uses continuous weights and comb resampling
(stochastic reconfiguration), so every shape is fixed and the step reads
nothing back from the device.

Random draws. The JAX package splits ``jax.random`` keys inside its
``lax.scan``; here a step is a function of its state and its draws (the
walkers' normal displacements ``xi`` and the comb's uniform ``u`` for
DMC; the proposal normals and the acceptance uniforms for VMC), so the
JAX package's own draws can be fed to :meth:`DMC.walk`/:meth:`VMC.walk`.
``run(key)`` draws blocks of them from a ``torch.Generator`` on the
device seeded by the integer ``key`` and feeds them to the step, captured
as a CUDA graph on the card (:class:`~pyqed_tpu_torch.core.dynamics.
GraphScan`). The card's generator (Philox) and the CPU's (Mersenne
Twister) give different numbers for one seed: compare the two on fed
draws.

User callables take one walker, a ``(ndim,)`` tensor, in torch
operations, and are batched by ``torch.func.vmap``. The C++ engine with
the same algorithm is :mod:`pyqed_tpu_torch.qmc.engine`.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..config import not_yet_ported, resolve_device
from ..core.dynamics import GraphScan

BLOCK = 100        # steps whose draws are made at once


def comb_resample(cum, u, n):
    """Parent indices of systematic (comb) resampling: the teeth
    ``(u + k) / n`` searched in the cumulative normalised weights ``cum``
    (side left, as ``jnp.searchsorted``), clipped to ``[0, n - 1]``."""
    pos = (u + torch.arange(n, dtype=cum.dtype, device=cum.device)) / n
    idx = torch.searchsorted(cum, pos)
    return torch.clamp(idx, 0, n - 1), pos


class DMC:
    """Importance-sampled diffusion Monte Carlo.

    Parameters
    ----------
    local_energy : callable x -> E_L(x), x of shape (ndim,)
    drift : callable x -> grad(ln psi_T)(x) (quantum force / 2)
        For pure (non-importance-sampled) DMC pass None.
    potential : callable x -> V(x), required when drift is None.
    """

    def __init__(self, ndim, local_energy=None, drift=None, potential=None,
                 mass=1.0):
        self.ndim = ndim
        self.local_energy = local_energy
        self.drift = drift
        self.potential = potential
        self.mass = mass

    def step_fn(self, dt):
        """``step((x, w, eref), xi, u) -> ((x, w, eref), E_est)``: one DMC
        step of the JAX package's scan on the draws ``xi`` (nw, ndim)
        standard normal and ``u`` (a 0-dim uniform)."""
        mass = self.mass
        sig = math.sqrt(dt / mass)
        if self.drift is not None:
            eloc = torch.func.vmap(self.local_energy)
            drift = torch.func.vmap(self.drift)
        else:
            pot = torch.func.vmap(self.potential)

        def step(carry, xi, u):
            x, w, eref = carry
            n = x.shape[0]
            if self.drift is not None:
                F = drift(x)
                xnew = x + dt * F / mass + sig * xi
                e_old, e_new = eloc(x), eloc(xnew)
            else:
                xnew = x + sig * xi
                e_old, e_new = pot(x), pot(xnew)
            # branching factor with the symmetrized local energy
            w = w * torch.exp(-dt * (0.5 * (e_old + e_new) - eref))
            W = torch.sum(w)
            E_est = torch.sum(w * e_new) / W
            # population control: eref toward keeping sum(w) = N
            eref_new = E_est - 0.5 * torch.log(W / n) / dt
            idx, _ = comb_resample(torch.cumsum(w / W, 0), u, n)
            return (xnew[idx], torch.ones_like(w), eref_new), E_est

        return step

    def walk(self, x0, xi, u, dt=0.01, eref=0.0):
        """The walk of :meth:`run` on given draws: ``x0`` (nw, ndim),
        ``xi`` (nsteps, nw, ndim) standard normal, ``u`` (nsteps,)
        uniform on [0, 1). Returns (E trajectory (nsteps,), final
        walkers)."""
        x0 = torch.as_tensor(x0)
        carry = (x0, torch.ones(x0.shape[0], dtype=x0.dtype,
                                device=x0.device),
                 torch.as_tensor(eref, dtype=x0.dtype, device=x0.device))
        (xf, _, _), E = GraphScan(self.step_fn(dt))(
            carry, torch.as_tensor(xi, device=x0.device),
            torch.as_tensor(u, device=x0.device))
        return E, xf.clone()

    def run(self, key, nwalkers=2048, nsteps=500, dt=0.01, eref=0.0,
            nequil=100, mesh=None, device=None):
        """Returns (E estimate, E trajectory, final walkers), tensors on
        ``device`` (the card when None); ``key`` an integer seed."""
        if mesh is not None:
            raise not_yet_ported("DMC.run(mesh=...)")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
        f64 = torch.float64
        x = torch.randn((nwalkers, self.ndim), generator=gen, device=dev,
                        dtype=f64) * 0.5
        carry = (x, torch.ones(nwalkers, dtype=f64, device=dev),
                 torch.tensor(eref, dtype=f64, device=dev))
        carry, E_traj = GraphScan(self.step_fn(dt)).blocks(
            carry, nsteps, BLOCK, lambda _, m: (
                torch.randn((m, nwalkers, self.ndim), generator=gen,
                            device=dev, dtype=f64),
                torch.rand((m,), generator=gen, device=dev, dtype=f64)))
        return torch.mean(E_traj[nequil:]), E_traj, carry[0].clone()

    def run_sharded(self, key, mesh, nwalkers=8192, **kwargs):
        """Walker-sharded run over a device mesh: not yet ported (it needs
        ``parallel/``)."""
        raise not_yet_ported("DMC.run_sharded")


class VMC:
    """Variational Monte Carlo with Metropolis sampling."""

    def __init__(self, log_psi: Callable, local_energy: Callable, ndim=1):
        self.log_psi = log_psi
        self.local_energy = local_energy
        self.ndim = ndim

    def step_fn(self, params, step_size):
        """``step(x, z, a) -> (x, mean E_L)`` on the draws ``z`` (nw,
        ndim) standard normal and ``a`` (nw,) uniform."""
        logp = torch.func.vmap(lambda x: 2.0 * self.log_psi(params, x))
        eloc = torch.func.vmap(lambda x: self.local_energy(params, x))

        def step(x, z, a):
            prop = x + step_size * z
            dlp = logp(prop) - logp(x)
            acc = a < torch.exp(dlp)
            x = torch.where(acc[:, None], prop, x)
            return x, torch.mean(eloc(x))

        return step

    def walk(self, params, x0, z, a, step_size=0.5):
        """The chain of :meth:`run` on given draws: ``x0`` (nw, ndim),
        ``z`` (nsteps, nw, ndim) standard normal, ``a`` (nsteps, nw)
        uniform. Returns (E trace (nsteps,), final walkers)."""
        x0 = torch.as_tensor(x0)
        xf, E = GraphScan(self.step_fn(params, step_size))(
            x0, torch.as_tensor(z, device=x0.device),
            torch.as_tensor(a, device=x0.device))
        return E, xf.clone()

    def run(self, key, params, nwalkers=2048, nsteps=1000, step_size=0.5,
            nequil=200, device=None):
        """Returns (mean E after ``nequil``, E trace, final walkers) on
        ``device`` (the card when None); ``key`` an integer seed."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
        f64 = torch.float64
        x = torch.randn((nwalkers, self.ndim), generator=gen, device=dev,
                        dtype=f64)
        x, E_trace = GraphScan(self.step_fn(params, step_size)).blocks(
            x, nsteps, BLOCK, lambda _, m: (
                torch.randn((m, nwalkers, self.ndim), generator=gen,
                            device=dev, dtype=f64),
                torch.rand((m, nwalkers), generator=gen, device=dev,
                           dtype=f64)))
        return torch.mean(E_trace[nequil:]), E_trace, x.clone()

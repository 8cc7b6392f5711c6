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

from ..config import resolve_device
from ..core.dynamics import GraphScan
from ..parallel.mesh import check_mesh

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

    def step_fn(self, dt, shard=None):
        """``step((x, w, eref), xi, u) -> ((x, w, eref), E_est)``: one DMC
        step of the JAX package's scan on the draws ``xi`` (nw, ndim)
        standard normal and ``u`` (a 0-dim uniform).

        ``shard`` = (group, d, lo, hi, nw): the walkers [lo, hi) of nw
        over the group's d ranks; x, w and xi are this rank's rows. The
        moves and weights are local; the comb is global: one all-gather
        of the moved walkers with their weights and energies, then the
        unsharded step's sums, cumsum and search on the whole population,
        each rank keeping the walkers its teeth [lo, hi) pick."""
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
            if shard is not None:
                return sharded_comb(xnew, w, e_new, eref, u)
            W = torch.sum(w)
            E_est = torch.sum(w * e_new) / W
            # population control: eref toward keeping sum(w) = N
            eref_new = E_est - 0.5 * torch.log(W / n) / dt
            idx, _ = comb_resample(torch.cumsum(w / W, 0), u, n)
            return (xnew[idx], torch.ones_like(w), eref_new), E_est

        def sharded_comb(xnew, w, e_new, eref, u):
            from ..parallel.mesh import gather_rows
            group, d, lo, hi, n = shard
            nd = xnew.shape[1]
            full = gather_rows(torch.cat([xnew, w[:, None], e_new[:, None]],
                                         1), group, d, n=n)
            # contiguous, so the sums below run as the unsharded step's
            xall, wall, eall = (t.contiguous() for t in (
                full[:, :nd], full[:, nd], full[:, nd + 1]))
            W = torch.sum(wall)
            E_est = torch.sum(wall * eall) / W
            eref_new = E_est - 0.5 * torch.log(W / n) / dt
            idx, _ = comb_resample(torch.cumsum(wall / W, 0), u, n)
            return (xall[idx[lo:hi]], torch.ones_like(w), eref_new), E_est

        return step

    def _walkers(self, mesh, nwalkers):
        """(lo, hi, shard, finish): this rank's walkers [lo, hi), the
        ``shard`` of :meth:`step_fn` and the function that gathers the
        final walkers (all walkers and no-ops without a mesh)."""
        mesh = check_mesh(mesh)
        if mesh is None:
            return 0, nwalkers, None, lambda x: x
        from ..parallel.mesh import axis_group, gather_rows, local_range
        group, rank, d = axis_group(mesh)
        lo, hi, _ = local_range(nwalkers, rank, d)
        return lo, hi, (group, d, lo, hi, nwalkers), (
            lambda x: gather_rows(x, group, d, n=nwalkers))

    def walk(self, x0, xi, u, dt=0.01, eref=0.0, mesh=None):
        """The walk of :meth:`run` on given draws: ``x0`` (nw, ndim),
        ``xi`` (nsteps, nw, ndim) standard normal, ``u`` (nsteps,)
        uniform on [0, 1). Returns (E trajectory (nsteps,), final
        walkers). With ``mesh`` every rank passes the whole walkers and
        draws and moves its chunk (:meth:`run`)."""
        x0 = torch.as_tensor(x0)
        lo, hi, shard, finish = self._walkers(mesh, x0.shape[0])
        carry = (x0[lo:hi].contiguous(),
                 torch.ones(hi - lo, dtype=x0.dtype, device=x0.device),
                 torch.as_tensor(eref, dtype=x0.dtype, device=x0.device))
        (xf, _, _), E = GraphScan(self.step_fn(dt, shard))(
            carry, torch.as_tensor(xi, device=x0.device)[:, lo:hi],
            torch.as_tensor(u, device=x0.device))
        return E, finish(xf.clone())

    def run(self, key, nwalkers=2048, nsteps=500, dt=0.01, eref=0.0,
            nequil=100, mesh=None, device=None):
        """Returns (E estimate, E trajectory, final walkers), tensors on
        ``device`` (the card when None); ``key`` an integer seed.

        ``mesh`` (a DeviceMesh): the walkers are cut over its first axis
        (chunks of ceil(nwalkers / d)); every rank draws the whole draw
        tensors from the same generator and keeps its rows, and the comb
        runs on the gathered population (:meth:`step_fn`), so the run
        equals the unsharded one draw for draw. Every rank returns the
        whole result."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
        x = torch.randn((nwalkers, self.ndim), generator=gen, device=dev,
                        dtype=torch.float64) * 0.5
        return self._run(gen, x, nsteps, dt, eref, nequil, mesh)

    def _run(self, gen, x, nsteps, dt, eref, nequil, mesh):
        """:meth:`run` from the start walkers ``x`` (nwalkers, ndim), its
        draws continuing the generator ``gen``."""
        dev, f64 = x.device, torch.float64
        nwalkers = x.shape[0]
        lo, hi, shard, finish = self._walkers(mesh, nwalkers)
        carry = (x[lo:hi].contiguous(),
                 torch.ones(hi - lo, dtype=f64, device=dev),
                 torch.tensor(eref, dtype=f64, device=dev))
        carry, E_traj = GraphScan(self.step_fn(dt, shard)).blocks(
            carry, nsteps, BLOCK, lambda _, m: (
                torch.randn((m, nwalkers, self.ndim), generator=gen,
                            device=dev, dtype=f64)[:, lo:hi],
                torch.rand((m,), generator=gen, device=dev, dtype=f64)))
        return torch.mean(E_traj[nequil:]), E_traj, finish(carry[0].clone())

    def run_sharded(self, key, mesh, nwalkers=8192, nsteps=500, dt=0.01,
                    eref=0.0, nequil=100, device=None):
        """Walker-sharded run over ``mesh`` (its first axis), as the JAX
        package's: the walkers are cut to a multiple of the ranks, the
        start walkers are drawn first (0.5 · normal) from the generator of
        ``key`` and the run continues that generator. Unlike the JAX
        package, whose ``run_sharded`` sets a start that its ``run`` never
        reads, the run starts from these walkers."""
        if check_mesh(mesh) is None:
            raise TypeError("run_sharded needs a torch.distributed "
                            "DeviceMesh")
        d = mesh.size(0)
        nwalkers = (nwalkers // d) * d
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
        x0 = torch.randn((nwalkers, self.ndim), generator=gen, device=dev,
                         dtype=torch.float64) * 0.5
        return self._run(gen, x0, nsteps, dt, eref, nequil, mesh)


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

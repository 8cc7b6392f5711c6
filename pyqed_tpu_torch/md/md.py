"""Classical molecular dynamics and Monte Carlo of a Lennard-Jones liquid.

Counterpart of ``pyqed_tpu/md/md.py``. All-pairs forces are one
``(N, N, 3)`` minimum-image pass on the device; velocity Verlet, the
steepest descent of :meth:`LJMD.minimize` and the single-particle moves
of :meth:`LJMD.monte_carlo` are fixed-shape steps run by
:class:`~pyqed_tpu_torch.core.dynamics.GraphScan` (a CUDA graph per block
of steps on the card). The velocity-Verlet step carries the forces of its
end point into the next step, where the JAX package evaluates them again:
the same numbers at half the force passes.

Random draws (the initial velocities, and per Monte Carlo move the
particle, its displacement and the acceptance uniform) come from a
``torch.Generator`` on the device seeded by the integer ``key``, or are
given as arguments, so the JAX package's own draws can be fed in.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..core.dynamics import GraphScan

BLOCK = 250        # steps or moves per GraphScan call (one graph each)


def fcc_lattice(ncell, density):
    """FCC initial positions (NumPy), and the box edge."""
    cell = (4.0 / density) ** (1.0 / 3.0)
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    pos = []
    for i in range(ncell):
        for j in range(ncell):
            for k in range(ncell):
                for b in base:
                    pos.append((np.array([i, j, k]) + b) * cell)
    L = ncell * cell
    return np.array(pos), L


def lj_forces(x, L, rc=2.5):
    """LJ energy, forces and virial with minimum-image PBC, one pairwise
    pass over the (N, N, 3) displacements of ``x`` (N, 3)."""
    disp = x[:, None, :] - x[None, :, :]
    disp = disp - L * torch.round(disp / L)
    r2 = torch.sum(disp ** 2, dim=-1)
    n = x.shape[0]
    mask = ~torch.eye(n, dtype=torch.bool, device=x.device)
    r2 = torch.where(mask, r2, 1.0)
    inside = mask & (r2 < rc ** 2)
    inv6 = 1.0 / r2 ** 3
    # shifted potential
    u = 4.0 * (inv6 ** 2 - inv6)
    u_c = 4.0 * (rc ** -12 - rc ** -6)
    U = 0.5 * torch.sum(torch.where(inside, u - u_c, 0.0))
    fmag = 24.0 * (2.0 * inv6 ** 2 - inv6) / r2
    F = torch.sum(torch.where(inside[..., None], fmag[..., None] * disp,
                              0.0), dim=1)
    virial = 0.5 * torch.sum(torch.where(inside, fmag * r2, 0.0))
    return U, F, virial


class LJMD:
    """Lennard-Jones liquid on an fcc start (reduced units); ``device``
    the card when None."""

    def __init__(self, ncell=3, density=0.8, temperature=1.0, rc=2.5,
                 device=None):
        self.x0, self.L = fcc_lattice(ncell, density)
        self.n = len(self.x0)
        self.density = density
        self.T0 = temperature
        self.rc = rc
        self.device = resolve_device(device)

    def _x(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float64)
        return torch.as_tensor(np.array(self.x0 if x is None else x,
                                        dtype=np.float64), device=self.device)

    def run(self, key, dt=0.005, nt=500, nout=10, thermostat_steps=100,
            v0_draws=None):
        """Velocity Verlet with velocity rescaling to ``temperature`` over
        the first ``thermostat_steps`` steps. The initial velocities are
        sqrt(T) times standard normals (``v0_draws`` (N, 3) where given,
        else drawn from ``key``), less their mean. ``nout`` is accepted and
        unused, as in the JAX package. Returns dict(x, v, U, T, P), U/T/P
        per step."""
        n, L, rc, T0 = self.n, self.L, self.rc, self.T0
        dev = self.device
        x0 = self._x(None)
        if v0_draws is None:
            gen = torch.Generator(device=dev).manual_seed(int(key))
            v0_draws = torch.randn((n, 3), generator=gen, device=dev,
                                   dtype=torch.float64)
        v0 = torch.as_tensor(v0_draws, device=dev) * np.sqrt(T0)
        v0 = v0 - torch.mean(v0, dim=0)
        vol = L ** 3

        def step(carry, i):
            x, v, F = carry
            v_half = v + 0.5 * dt * F
            x_new = torch.remainder(x + dt * v_half, L)
            U2, F2, W2 = lj_forces(x_new, L, rc)
            v_new = v_half + 0.5 * dt * F2
            # velocity rescaling thermostat for the first window
            KE = 0.5 * torch.sum(v_new ** 2)
            T_inst = 2.0 * KE / (3.0 * n)
            lam = torch.where(i < thermostat_steps, torch.sqrt(
                T0 / torch.clamp(T_inst, min=1e-12)), 1.0)
            v_new = v_new * lam
            P = self.density * T_inst + W2 / (3.0 * vol)
            return (x_new, v_new, F2), (U2, T_inst, P)

        _, F0, _ = lj_forces(x0, L, rc)
        steps = torch.arange(nt, device=dev)
        (xf, vf, _), (U, T, P) = GraphScan(step).blocks(
            (x0, v0, F0), nt, BLOCK, lambda s, m: (steps[s:s + m],))
        return dict(x=xf.clone(), v=vf.clone(), U=U, T=T, P=P)

    def minimize(self, x0=None, nsteps=200, step0=1e-3):
        """Steepest-descent energy minimization with backtracking: a move
        that raises U is rejected and the step halved; an accepted move
        grows the step 10%. Returns (positions, U trace)."""
        L, rc = self.L, self.rc
        x = self._x(x0)

        def body(carry):
            x, step = carry
            U, F, _ = lj_forces(x, L, rc)
            fmax = torch.max(torch.linalg.norm(F, dim=1))
            trial = torch.remainder(
                x + step * F / torch.clamp(fmax, min=1e-12), L)
            U2, _, _ = lj_forces(trial, L, rc)
            ok = U2 < U
            return ((torch.where(ok, trial, x),
                     torch.where(ok, step * 1.1, step * 0.5)),
                    (torch.where(ok, U2, U),))

        carry = (x, torch.tensor(step0, dtype=torch.float64, device=x.device))
        (xf, _), (Utrace,) = GraphScan(body).blocks(
            carry, nsteps, BLOCK, lambda s, m: ())
        return xf.clone(), Utrace

    def mc_draws(self, gen, nmoves, delta):
        """Per move: the particle (nmoves,) in [0, N), the displacement
        (nmoves, 3) uniform in [-delta, delta) and the acceptance uniform
        (nmoves,), from ``gen``."""
        kw = dict(generator=gen, device=self.device, dtype=torch.float64)
        return (torch.randint(0, self.n, (nmoves,), generator=gen,
                              device=self.device),
                delta * (2.0 * torch.rand((nmoves, 3), **kw) - 1.0),
                torch.rand((nmoves,), **kw))

    def monte_carlo(self, key, nmoves=20000, delta=0.1, x0=None,
                    temperature=None, sample_every=100, draws=None):
        """Metropolis NVT Monte Carlo: one single-particle trial move per
        step, the energy change from the moved particle's interaction row
        (O(N) per move). ``draws`` (particle, displacement, uniform) as in
        :meth:`mc_draws`, else drawn from ``key``. Returns dict with
        positions, U, U samples every ``sample_every`` moves and the
        acceptance ratio."""
        L, rc, n = self.L, self.rc, self.n
        T = self.T0 if temperature is None else temperature
        beta = 1.0 / T
        x = self._x(x0)
        dev = x.device
        if draws is None:
            gen = torch.Generator(device=dev).manual_seed(int(key))
            draws = self.mc_draws(gen, nmoves, delta)
        idx, disp, acc_u = (torch.as_tensor(d, device=dev) for d in draws)
        atoms = torch.arange(n, device=dev)
        u_c = 4.0 * (rc ** -12 - rc ** -6)

        def row_energy(x, i, xi):
            """LJ energy of particle i at position xi with all others."""
            d = xi[None, :] - x
            d = d - L * torch.round(d / L)
            r2 = torch.sum(d ** 2, dim=-1)
            mask = (atoms != i) & (r2 < rc ** 2)
            r2 = torch.where(mask, r2, 1.0)
            inv6 = 1.0 / r2 ** 3
            return torch.sum(torch.where(mask, 4.0 * (inv6 ** 2 - inv6) - u_c,
                                         0.0))

        def body(carry, i, d, a):
            x, U, nacc = carry
            xi = x.index_select(0, i.reshape(1))[0]   # no host read of i
            trial = torch.remainder(xi + d, L)
            dU = row_energy(x, i, trial) - row_energy(x, i, xi)
            accept = a < torch.exp(torch.clamp(-beta * dU, max=0.0))
            x_new = torch.where(accept & (atoms == i)[:, None], trial[None],
                                x)
            U_new = torch.where(accept, U + dU, U)
            return (x_new, U_new, nacc + accept.to(nacc.dtype)), (U_new,)

        U0, _, _ = lj_forces(x, L, rc)
        carry = (x, U0, torch.zeros((), dtype=torch.int64, device=dev))
        nm = idx.shape[0]
        (xf, Uf, nacc), (Utrace,) = GraphScan(body).blocks(
            carry, nm, BLOCK,
            lambda s, m: (idx[s:s + m], disp[s:s + m], acc_u[s:s + m]))
        return dict(x=xf.clone(), U=float(Uf), samples=Utrace[::sample_every],
                    acceptance=float(nacc) / nm)

    def rdf(self, x, nbins=100):
        """Radial distribution function g(r) (host NumPy)."""
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x)
        L = self.L
        disp = x[:, None, :] - x[None, :, :]
        disp = disp - L * np.round(disp / L)
        r = np.sqrt((disp ** 2).sum(-1))
        iu = np.triu_indices(self.n, 1)
        rs = r[iu]
        hist, edges = np.histogram(rs, bins=nbins, range=(0, L / 2))
        rc_ = 0.5 * (edges[1:] + edges[:-1])
        dr = edges[1] - edges[0]
        shell = 4 * np.pi * rc_ ** 2 * dr
        ideal = shell * self.density * self.n / 2
        return rc_, hist / ideal

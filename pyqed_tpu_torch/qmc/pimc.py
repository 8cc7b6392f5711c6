"""Path-integral Monte Carlo (finite temperature), walker-parallel.

Counterpart of ``pyqed_tpu/qmc/pimc.py``. Thousands of independent ring
polymers advance as one ``(npaths, M, ndim)`` tensor; within each polymer
the beads move in a checkerboard (even/odd) pattern, since beads couple
only to their ring neighbours, then the whole polymer moves rigidly. dV/dx
is ``torch.func.grad`` of the potential when not supplied.

A sweep is a function of the paths and its draws (:meth:`PIMC.draws`), so
the JAX package's own ``jax.random`` draws can be fed to
:meth:`PIMC.sweeps`. ``run(key)`` draws blocks of sweeps from a
``torch.Generator`` on the device seeded by the integer ``key`` and feeds
them to one sweep captured as a CUDA graph on the card; the thermalising
and the measuring sweeps are the same graph. ``mesh=`` and
``use_shard_map`` are not yet ported (they raise).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import not_yet_ported, resolve_device
from ..core.dynamics import GraphScan

BLOCK = 50         # sweeps whose draws are made at once


def _scalar_potential(potential):
    """``q -> sum(potential(q))``: scalar- and shape-(1,)-valued
    potentials alike, as the JAX package's ``jnp.sum(jnp.asarray(...))``."""
    def V(q):
        v = potential(q)
        return torch.sum(v) if isinstance(v, torch.Tensor) else \
            torch.as_tensor(v, dtype=q.dtype, device=q.device)
    return V


def _pointwise(f, nd):
    """``x (..., nd) -> f`` at every point, batched by ``torch.func.vmap``
    (``f`` maps (nd,) to a scalar or to (nd,))."""
    fb = torch.func.vmap(f)

    def apply(x):
        out = fb(x.reshape(-1, nd))
        return out.reshape(x.shape[:-1] + out.shape[1:])
    return apply


class PIMC:
    """Single-particle PIMC in ndim dimensions (ring polymer of M beads).

    Parameters
    ----------
    potential : callable q (ndim,) -> V(q) (scalar, in torch operations).
    beta : inverse temperature.
    nbeads : Trotter number M (tau = beta / M).
    mass : particle mass.
    ndim : spatial dimension.
    """

    def __init__(self, potential: Callable, beta: float, nbeads: int = 64,
                 mass: float = 1.0, ndim: int = 1,
                 dVdx: Optional[Callable] = None):
        self.V = _scalar_potential(potential)
        self.dVdx = dVdx if dVdx is not None else torch.func.grad(self.V)
        self.beta = beta
        self.M = nbeads
        self.tau = beta / nbeads
        self.mass = mass
        self.ndim = ndim

    def draws(self, gen, nsweeps, npaths, device):
        """The draws of ``nsweeps`` sweeps from ``gen``: for each
        half-sweep a bead displacement uniform on [-1, 1) (nsweeps,
        npaths, M, nd) and an acceptance uniform (nsweeps, npaths, M);
        for the centroid move a displacement (nsweeps, npaths, 1, nd) and
        an acceptance uniform (nsweeps, npaths)."""
        M, nd = self.M, self.ndim
        kw = dict(generator=gen, device=device, dtype=torch.float64)
        sym = lambda *s: 2.0 * torch.rand(s, **kw) - 1.0   # noqa: E731
        return (sym(nsweeps, npaths, M, nd),
                torch.rand((nsweeps, npaths, M), **kw),
                sym(nsweeps, npaths, M, nd),
                torch.rand((nsweeps, npaths, M), **kw),
                sym(nsweeps, npaths, 1, nd),
                torch.rand((nsweeps, npaths), **kw))

    def sweep_fn(self, step):
        """``sweep(paths, *draws) -> (paths, (e_vir, e_th, acceptance))``:
        the JAX package's sweep (two checkerboard half-sweeps, a centroid
        move, the virial and thermodynamic estimators) on one sweep of
        :meth:`draws`."""
        M, tau, nd = self.M, self.tau, self.ndim
        spring = self.mass / (2.0 * tau)
        Vflat = _pointwise(self.V, nd)
        dVflat = _pointwise(self.dVdx, nd)

        def half_sweep(paths, u, a, parity):
            prop = paths + step * u
            left = torch.roll(paths, 1, dims=1)
            right = torch.roll(paths, -1, dims=1)
            dS = (spring * torch.sum(
                (prop - left) ** 2 + (prop - right) ** 2
                - (paths - left) ** 2 - (paths - right) ** 2, dim=-1)
                + tau * (Vflat(prop) - Vflat(paths)))
            accept = a < torch.exp(-dS)
            bead_par = (torch.arange(M, device=paths.device) % 2
                        == parity)[None, :]
            take = (accept & bead_par)[..., None]
            acc = torch.mean(torch.where(bead_par, accept.to(paths.dtype),
                                         0.0) * 2.0)
            return torch.where(take, prop, paths), acc

        def centroid_move(paths, c, ac):
            # rigid whole-polymer move: the spring action is invariant
            prop = paths + step * c
            dS = tau * torch.sum(Vflat(prop) - Vflat(paths), dim=1)
            accept = (ac < torch.exp(-dS))[:, None, None]
            return torch.where(accept, prop, paths)

        def sweep(paths, u0, a0, u1, a1, c, ac):
            paths, acc0 = half_sweep(paths, u0, a0, 0)
            paths, acc1 = half_sweep(paths, u1, a1, 1)
            paths = centroid_move(paths, c, ac)
            vvals = Vflat(paths)
            e_vir = torch.mean(vvals) + 0.5 * torch.mean(
                torch.sum(paths * dVflat(paths), dim=-1))
            dx2 = torch.sum((paths - torch.roll(paths, 1, dims=1)) ** 2,
                            dim=(1, 2))
            e_th = (M * nd / (2.0 * self.beta)
                    - spring / self.beta * torch.mean(dx2)
                    + torch.mean(vvals))
            return paths, (e_vir, e_th, 0.5 * (acc0 + acc1))

        return sweep

    def sweeps(self, paths0, draws, step=0.5):
        """Sweeps of :meth:`run` on given draws (the tuple of
        :meth:`draws`, leading axis the sweep). Returns (final paths,
        (e_vir, e_th, acceptance) per sweep)."""
        paths0 = torch.as_tensor(paths0)
        paths, ys = GraphScan(self.sweep_fn(step))(
            paths0, *(torch.as_tensor(d, device=paths0.device)
                      for d in draws))
        return paths.clone(), ys

    def run(self, key, npaths=2048, nsweeps=2000, ntherm=500, step=0.5,
            mesh=None, use_shard_map=False, device=None):
        """Returns (E_virial, E_thermo, acceptance, paths_final), the
        estimators averaged over the ``nsweeps`` sweeps after ``ntherm``;
        ``key`` an integer seed, the paths a tensor on ``device`` (the
        card when None). The per-sweep estimators are kept in
        ``self.trace_`` (e_vir, e_th, acceptance), for error bars."""
        if mesh is not None or use_shard_map:
            raise not_yet_ported("PIMC.run(mesh=..., use_shard_map=...)")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
        paths = 0.5 * torch.randn((npaths, self.M, self.ndim),
                                  generator=gen, device=dev,
                                  dtype=torch.float64)
        scan = GraphScan(self.sweep_fn(step))
        draws = lambda _, m: self.draws(gen, m, npaths, dev)   # noqa: E731
        paths, _ = scan.blocks(paths, ntherm, BLOCK, draws)
        paths, (ev, et, acc) = scan.blocks(paths, nsweeps, BLOCK, draws)
        self.trace_ = (ev, et, acc)
        return (float(torch.mean(ev)), float(torch.mean(et)),
                float(torch.mean(acc)), paths.clone())


class BosonPIMC:
    """Finite-temperature PIMC for N identical BOSONS with explicit
    permutation (exchange) sampling.

    State per replica: beads (N, M, d) plus a permutation P closing the
    ring: bead M-1 of particle k springs to bead 0 of particle P(k).
    Moves: checkerboard bead moves, rigid whole-particle displacements,
    and pair-transposition moves P -> P∘(ij) accepted on the closure
    spring action; replicas are the batch axis. The permutations are
    ``(R, N)`` index tensors and a transposition is two scatters.
    """

    def __init__(self, potential: Callable, nparticles: int, beta: float,
                 nbeads: int = 32, mass: float = 1.0, ndim: int = 1):
        self.V = _scalar_potential(potential)
        self.N = nparticles
        self.beta = beta
        self.M = nbeads
        self.tau = beta / nbeads
        self.mass = mass
        self.ndim = ndim

    def draws(self, gen, nsweeps, nreplicas, device, exchange=True):
        """The draws of ``nsweeps`` sweeps from ``gen``: per bead
        half-sweep a displacement uniform on [-1, 1) (nsweeps, R, N, M,
        nd) and an acceptance uniform (nsweeps, R, N, M); the particle
        move's displacement (nsweeps, R, N, 1, nd) and uniform (nsweeps,
        R); with ``exchange`` the transposition's particles i and j
        (nsweeps, R) integers in [0, N) and its uniform (nsweeps, R)."""
        N, M, nd, R = self.N, self.M, self.ndim, nreplicas
        kw = dict(generator=gen, device=device, dtype=torch.float64)
        sym = lambda *s: 2.0 * torch.rand(s, **kw) - 1.0   # noqa: E731
        out = (sym(nsweeps, R, N, M, nd), torch.rand((nsweeps, R, N, M), **kw),
               sym(nsweeps, R, N, M, nd), torch.rand((nsweeps, R, N, M), **kw),
               sym(nsweeps, R, N, 1, nd), torch.rand((nsweeps, R), **kw))
        if exchange:
            ik = dict(generator=gen, device=device)
            out += (torch.randint(0, N, (nsweeps, R), **ik),
                    torch.randint(0, N, (nsweeps, R), **ik),
                    torch.rand((nsweeps, R), **kw))
        return out

    def sweep_fn(self, step, exchange=True):
        """``sweep((x, perm), *draws) -> ((x, perm), (E, acc_bead,
        acc_perm))``: the JAX package's sweep on one sweep of
        :meth:`draws`."""
        N, M, nd, tau = self.N, self.M, self.ndim, self.tau
        spring = self.mass / (2.0 * tau)
        Vflat = _pointwise(self.V, nd)

        def head(x, perm):
            """x[r, perm[r, k], 0]: bead 0 of each particle's successor."""
            R = x.shape[0]
            return x[torch.arange(R, device=x.device)[:, None], perm, 0]

        def springs(x, perm):
            internal = torch.sum((x[:, :, 1:] - x[:, :, :-1]) ** 2,
                                 dim=(1, 2, 3))
            closure = torch.sum((x[:, :, -1] - head(x, perm)) ** 2,
                                dim=(1, 2))
            return spring * (internal + closure)

        def neighbors(x, perm):
            R = x.shape[0]
            rows = torch.arange(R, device=x.device)[:, None]
            pinv = torch.empty_like(perm).scatter_(
                1, perm, torch.arange(N, device=perm.device).expand(R, N))
            right = torch.cat([x[:, :, 1:], head(x, perm)[:, :, None]],
                              dim=2)
            left = torch.cat([x[rows, pinv, M - 1][:, :, None],
                              x[:, :, :-1]], dim=2)
            return left, right

        def bead_move(x, perm, u, a, parity):
            prop = x + step * u
            left, right = neighbors(x, perm)
            dS = (spring * torch.sum(
                (prop - left) ** 2 + (prop - right) ** 2
                - (x - left) ** 2 - (x - right) ** 2, dim=-1)
                + tau * (Vflat(prop) - Vflat(x)))
            acc = a < torch.exp(-dS)
            bead_par = (torch.arange(M, device=x.device) % 2
                        == parity)[None, None, :]
            take = (acc & bead_par)[..., None]
            rate = torch.mean(torch.where(bead_par, acc.to(x.dtype), 0.0)
                              * 2.0)
            return torch.where(take, prop, x), rate

        def particle_move(x, perm, d, a):
            prop = x + step * d
            dS = (springs(prop, perm) - springs(x, perm)
                  + tau * torch.sum(Vflat(prop) - Vflat(x), dim=(1, 2)))
            acc = (a < torch.exp(-dS))[:, None, None, None]
            return torch.where(acc, prop, x)

        def perm_move(x, perm, i, j, a):
            i, j = i[:, None], j[:, None]
            pi, pj = perm.gather(1, i), perm.gather(1, j)
            perm_new = perm.scatter(1, i, pj).scatter(1, j, pi)
            dS = springs(x, perm_new) - springs(x, perm)
            acc = a < torch.exp(-dS)
            return (torch.where(acc[:, None], perm_new, perm),
                    torch.mean(acc.to(x.dtype)))

        def energy(x, perm):
            vmean = torch.mean(Vflat(x))
            return (N * nd * M / (2.0 * self.beta)
                    - torch.mean(springs(x, perm)) / self.beta + N * vmean)

        def sweep(state, u0, a0, u1, a1, d, ad, *ex):
            x, perm = state
            x, r0 = bead_move(x, perm, u0, a0, 0)
            x, r1 = bead_move(x, perm, u1, a1, 1)
            x = particle_move(x, perm, d, ad)
            if exchange:
                perm, ap = perm_move(x, perm, *ex)
            else:
                ap = torch.zeros((), dtype=x.dtype, device=x.device)
            return (x, perm), (energy(x, perm), 0.5 * (r0 + r1), ap)

        return sweep

    def sweeps(self, x0, perm0, draws, step=0.4, exchange=True):
        """Sweeps of :meth:`run` on given draws (the tuple of
        :meth:`draws`, leading axis the sweep). Returns ((x, perm),
        (E, acc_bead, acc_perm) per sweep)."""
        x0 = torch.as_tensor(x0)
        state, ys = GraphScan(self.sweep_fn(step, exchange))(
            (x0, torch.as_tensor(perm0, device=x0.device)),
            *(torch.as_tensor(d, device=x0.device) for d in draws))
        return (state[0].clone(), state[1].clone()), ys

    def run(self, key, nreplicas=256, nsweeps=3000, ntherm=1000,
            step=0.4, exchange=True, device=None):
        """Returns (E_thermo, acc_bead, acc_perm, fraction of replicas
        with a non-identity permutation); ``key`` an integer seed, the
        replicas on ``device`` (the card when None). The per-sweep
        estimators are kept in ``self.trace_`` (E, acc_bead, acc_perm)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
        x = 0.5 * torch.randn((nreplicas, self.N, self.M, self.ndim),
                              generator=gen, device=dev,
                              dtype=torch.float64)
        ident = torch.arange(self.N, device=dev)
        state = (x, ident[None, :].repeat(nreplicas, 1))
        scan = GraphScan(self.sweep_fn(step, exchange))
        draws = lambda _, m: self.draws(gen, m, nreplicas,   # noqa: E731
                                        dev, exchange)
        state, _ = scan.blocks(state, ntherm, BLOCK, draws)
        (x, perm), (E, ab, ap) = scan.blocks(state, nsweeps, BLOCK, draws)
        self.trace_ = (E, ab, ap)
        frac_exch = float(torch.mean(torch.any(perm != ident[None, :],
                                               dim=1).to(x.dtype)))
        return float(torch.mean(E)), float(torch.mean(ab)), \
            float(torch.mean(ap)), frac_exch

"""Fewest-switches surface hopping (FSSH) (PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/fssh.py``: Tully's
fewest-switches algorithm [Tully, J. Chem. Phys. 93, 1061 (1990)] for a
whole stochastic ensemble at once. Every quantity is a batched
``(ntraj, ...)`` tensor and one Python loop runs the windows of ``nout``
steps, where the JAX package ``vmap``s a per-trajectory ``lax.scan``.

Per step (the adiabatics E, U, dVa at x ride along, so each step does one
adiabatization):

1. adiabatize V(x_new), eigenvector signs aligned with the previous step
   (the sign of diag(U_prev^T U));
2. nuclear velocity Verlet on the active surface, F = -(U^T dV U)_aa;
3. exact electronic propagation exp(-i H_el dt) c with
   H_el = diag(E) - i v.d, d_ab = (U^T dV U)_ab / (E_b - E_a);
4. hop probabilities g_{a->b} = dt max(0, -2 Re(c_b^* c_a v.d_ba)) / |c_a|^2
   and one uniform draw per trajectory;
5. on a hop, momentum rescaled along d_ab to conserve the total energy;
   frustrated hops are rejected; optionally the energy-based decoherence
   correction (EDC).

Device work without host reads: for two states and a real V the
eigenpairs of V and the exponential of the Hermitian H_el are closed
forms, and on CUDA the whole step (some 430 small operations) is
captured once as a CUDA graph and replayed. For more states, or a
complex V, both are batched ``torch.linalg.eigh`` calls, which
synchronise with the host on CUDA and cannot be captured: that step runs
eagerly on the card, the same code. The gradient dV defaults to
``torch.func.jacfwd`` of ``v`` under ``torch.func.vmap`` over the
trajectories, so ``v`` must be written in torch operations
(``torch.where``/``torch.stack``, as :func:`tully_i` is).

The uniform draws of the hop test come from a ``torch.Generator`` seeded
by the integer ``key``, made on the CPU and moved to the device one
window at a time, so the card and the CPU see the same numbers. They are
not the JAX package's ``jax.random`` draws; :func:`trajectories` takes the
draws as an argument, so JAX's own can be fed to it. The eigenvector signs
of the first step are those of the closed form or of ``eigh`` and may
differ from JAX's per column: ``x``, ``p``, ``active``, ``|c|^2`` and the
populations do not depend on them, ``c`` only up to that sign.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..core.dynamics import cuda_graph_stepper
from ..core.result import Result
from ..ops.linalg import as_tensor
from ..parallel.mesh import check_mesh
from .spo import _eigh


def batched_potential(v: Callable, dv: Optional[Callable] = None):
    """``vdv(x (B, ndim)) -> (V (B, ns, ns), dV (B, ndim, ns, ns))`` of a
    pointwise diabatic model ``v(x (ndim,)) -> (ns, ns)``: ``dv`` under
    ``torch.func.vmap`` when given, else one ``torch.func.jacfwd`` pass
    that returns the value beside the gradient."""
    vb = torch.func.vmap(v)
    if dv is not None:
        dvb = torch.func.vmap(dv)
        return lambda x: (vb(x), dvb(x))

    def both(x):
        val = v(x)
        return val, val

    jac = torch.func.vmap(torch.func.jacfwd(both, has_aux=True))

    def vdv(x):
        J, V = jac(x)                          # J (B, ns, ns, ndim)
        return V, torch.movedim(J, -1, 1)

    return vdv


def eigh_sym2(V):
    """Eigenpairs of a batch of real symmetric 2 x 2 matrices in closed
    form, ascending as ``eigh`` orders them: (E (B, 2), U (B, 2, 2)),
    columns (-sin t, cos t) and (cos t, sin t), t = atan2(2 b, a - d) / 2."""
    a, b, d = V[..., 0, 0], V[..., 0, 1], V[..., 1, 1]
    m = 0.5 * (a + d)
    r = torch.hypot(0.5 * (a - d), b)
    th = 0.5 * torch.atan2(2.0 * b, a - d)
    c, s = torch.cos(th), torch.sin(th)
    E = torch.stack([m - r, m + r], dim=-1)
    U = torch.stack([torch.stack([-s, c], dim=-1),
                     torch.stack([c, s], dim=-1)], dim=-2)
    return E, U


def expm_herm_step(Hd, T, dt):
    """exp(-i H dt) of H = diag(Hd) - i T for a batch of real diagonals
    Hd (B, ns) and real antisymmetric T (B, ns, ns), a Hermitian H. Two
    states: the closed form e^{-i h0 dt}[cos(w dt) - i sin(w dt)/w (H - h0)];
    more: a batched ``eigh``."""
    ns = Hd.shape[-1]
    H = torch.diag_embed(Hd).to(torch.complex128) - 1j * T
    if ns == 2:
        h0 = 0.5 * (Hd[:, 0] + Hd[:, 1])
        hz = 0.5 * (Hd[:, 0] - Hd[:, 1])
        w = torch.hypot(hz, T[:, 0, 1])
        sinc = dt * torch.sinc(w * dt / np.pi)          # sin(w dt) / w
        K = H - h0[:, None, None] * torch.eye(2, dtype=H.dtype,
                                              device=H.device)
        M = (torch.cos(w * dt)[:, None, None] * torch.eye(
            2, dtype=H.dtype, device=H.device)
             - 1j * sinc[:, None, None] * K)
        return torch.exp(-1j * h0 * dt)[:, None, None] * M
    w, Q = torch.linalg.eigh(H)
    return (Q * torch.exp(-1j * w * dt)[:, None, :]) @ Q.mH


class FSSH:
    """Fewest-switches surface hopping on a diabatic model.

    Parameters
    ----------
    v : callable x (ndim,) -> (ns, ns) real symmetric diabatic potential,
        written in torch operations.
    dv : callable x -> (ndim, ns, ns) gradient; default
        ``torch.func.jacfwd(v)``.
    mass : scalar or (ndim,) nuclear masses.
    decoherence : None (standard FSSH) or ``"edc"``, the energy-based
        decoherence correction [Granucci & Persico, JCP 126, 134114
        (2007)]: after each step the non-active amplitudes are damped with
        tau_b = (1 + C/E_kin) / |E_b - E_act| and the active one rescaled
        to keep the norm.
    device : the card when None (raises without one); ``"cpu"`` on
        request.
    """

    def __init__(self, v: Callable, dv: Optional[Callable] = None,
                 mass=1.0, nstates: int = 2, ndim: int = 1,
                 decoherence: Optional[str] = None, edc_C: float = 0.1,
                 device=None):
        if decoherence not in (None, "edc"):
            raise ValueError("decoherence must be None or 'edc'")
        self.device = resolve_device(device)
        self.v = v
        self.dv = dv
        self._vdv = batched_potential(v, dv)
        self.mass = torch.as_tensor(
            np.atleast_1d(np.asarray(mass, dtype=float)), device=self.device)
        self.nstates = nstates
        self.ndim = ndim
        self.decoherence = decoherence
        self.edc_C = float(edc_C)

    # --------------------------------------------------------- adiabatics
    def _eig(self, V):
        if self.nstates == 2 and not V.is_complex():
            return eigh_sym2(V)
        return _eigh(V)

    def _adiabatic(self, x, U_prev):
        """E (B, ns), sign-aligned U (B, ns, ns), dVa = U^T dV U
        (B, ndim, ns, ns)."""
        V, dV = self._vdv(x)
        E, U = self._eig(V)
        ov = (U_prev * U).sum(dim=-2)                 # diag(U_prev^T U)
        U = U * torch.where(ov < 0, -1.0, 1.0)[:, None, :]
        dVa = torch.einsum("bia, bdij, bjc -> bdac", U, dV, U)
        return E, U, dVa

    @staticmethod
    def _nac(E, dVa):
        """d_ab = dVa_ab / (E_b - E_a), zero diagonal, (B, ndim, ns, ns)."""
        dE = E[:, None, :] - E[:, :, None]            # (a, b) -> E_b - E_a
        safe = torch.where(dE.abs() < 1e-12, 1.0, dE)
        ns = E.shape[-1]
        off = 1.0 - torch.eye(ns, dtype=E.dtype, device=E.device)
        return dVa / safe[:, None] * off

    @staticmethod
    def _force(dVa, act):
        diag = dVa.diagonal(dim1=-2, dim2=-1)         # (B, ndim, ns)
        idx = act[:, None, None].expand(-1, diag.shape[1], 1)
        return -diag.gather(2, idx)[..., 0]

    # --------------------------------------------------------------- step
    def _step(self, state, r, dt):
        """One step of every trajectory; ``r`` (B,) the uniform draws."""
        x, p, c, act, (E, U, dVa) = state
        m = self.mass
        rows = torch.arange(x.shape[0], device=x.device)
        p_half = p + 0.5 * dt * self._force(dVa, act)
        x_new = x + dt * p_half / m
        E2, U2, dVa2 = self._adiabatic(x_new, U)
        p_new = p_half + 0.5 * dt * self._force(dVa2, act)

        # electronic propagation: exact exponential of the midpoint H_el
        T = torch.einsum("bd, bdac -> bac", p_half / m, self._nac(E, dVa))
        c_new = torch.einsum("bac, bc -> ba",
                             expm_herm_step((E + E2) / 2.0, T, dt), c)

        # fewest-switches hop probabilities out of the active state
        ca = c_new[rows, act]
        g = (dt * (-2.0) * (c_new.conj() * ca[:, None]
                            * T[rows, :, act]).real
             / torch.clamp(ca.abs() ** 2, min=1e-30)[:, None])
        states = torch.arange(self.nstates, device=x.device)
        g = torch.where(act[:, None] == states, 0.0,
                        torch.clamp(g, 0.0, 1.0))
        cum = torch.cumsum(g, dim=-1)
        # first b with cum_b > r, if the total probability exceeds r
        target = torch.argmax((cum > r[:, None]).to(torch.int8), dim=-1)
        do_hop = r < cum[:, -1]

        # momentum rescaling along d[act, target] at the hop geometry
        u = self._nac(E2, dVa2)[rows, :, act, target]     # (B, ndim)
        u_norm = torch.sqrt((u ** 2).sum(-1, keepdim=True))
        p_norm = torch.sqrt((p_new ** 2).sum(-1, keepdim=True))
        u = torch.where(u_norm > 1e-12, u / torch.clamp(u_norm, min=1e-30),
                        p_new / torch.clamp(p_norm, min=1e-30))
        dE_hop = E2[rows, target] - E2[rows, act]
        a_q = (u ** 2 / (2.0 * m)).sum(-1)
        b_q = (p_new * u / m).sum(-1)
        disc = b_q ** 2 - 4.0 * a_q * dE_hop
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        g1 = (-b_q + sq) / (2.0 * a_q)
        g2 = (-b_q - sq) / (2.0 * a_q)
        gam = torch.where(g1.abs() < g2.abs(), g1, g2)
        accept = do_hop & (disc >= 0.0)
        act_new = torch.where(accept, target, act)
        p_new = torch.where(accept[:, None], p_new + gam[:, None] * u, p_new)

        if self.decoherence == "edc":
            ekin = (p_new ** 2 / (2.0 * m)).sum(-1)
            gap = (E2 - E2[rows, act_new][:, None]).abs()
            tau_inv = gap / (1.0 + self.edc_C
                             / torch.clamp(ekin, min=1e-12))[:, None]
            on = act_new[:, None] == states
            c_off = c_new * torch.where(on, 0.0, torch.exp(-dt * tau_inv))
            p_off = (c_off.abs() ** 2).sum(-1)
            c_act = c_new[rows, act_new]
            scale = torch.sqrt(torch.clamp(1.0 - p_off, min=0.0)
                               / torch.clamp(c_act.abs() ** 2, min=1e-30))
            c_new = torch.where(on, (c_act * scale)[:, None], c_off)

        return (x_new, p_new, c_new, act_new, (E2, U2, dVa2))

    def energy(self, x, p, act):
        """Total energy p^2/2m + E_active(x), per trajectory: x, p
        (B, ndim), act (B,) tensors on the solver's device."""
        E = torch.linalg.eigvalsh(torch.func.vmap(self.v)(x))
        rows = torch.arange(x.shape[0], device=x.device)
        return (p ** 2 / (2.0 * self.mass)).sum(-1) + E[rows, act]

    # ---------------------------------------------------------------- run
    def initial_state(self, x0, p0, active0=0, c0=None):
        """The batched state (x, p, c, active, adiabatics) at t = 0 on the
        solver's device: x0/p0 (ntraj, ndim) or flat (ntraj,) for 1-D
        trajectories; active0 int or (ntraj,) (adiabatic index); c0
        (ntraj, ns) or one (ns,) vector for all (default: delta on
        active0)."""
        dev = self.device
        x0 = as_tensor(x0, torch.float64, dev)
        p0 = as_tensor(p0, torch.float64, dev)
        if x0.dim() == 1:            # flat input = ntraj 1-D trajectories
            x0, p0 = x0[:, None], p0[:, None]
        if x0.shape[-1] != self.ndim:
            raise ValueError(f"x0 last axis {x0.shape[-1]} != ndim "
                             f"{self.ndim}")
        ntraj, ns = x0.shape[0], self.nstates
        act0 = as_tensor(active0, torch.int64, dev).expand(ntraj).clone()
        if c0 is None:
            c0 = torch.nn.functional.one_hot(act0, ns).to(torch.complex128)
        else:
            c0 = as_tensor(c0, torch.complex128, dev)
            c0 = torch.atleast_2d(c0).expand(ntraj, ns).clone()
        _, U0 = self._eig(self._vdv(x0)[0])          # phase reference
        return (x0, p0, c0, act0, self._adiabatic(x0, U0))

    def draws(self, key, nt, ntraj):
        """The hop-test uniforms of ``run(key=...)``: (nt, ntraj) float64
        on the CPU from ``torch.Generator().manual_seed(key)``."""
        if not isinstance(key, (int, np.integer)):
            raise TypeError("key must be an integer seed")
        gen = torch.Generator().manual_seed(int(key))
        return torch.rand((nt, ntraj), generator=gen, dtype=torch.float64)

    def run(self, x0, p0, active0=0, c0=None, dt=0.1, nt=100, nout=1,
            key=0, mesh=None) -> Result:
        """Propagate an FSSH ensemble for ``nt // nout`` windows of
        ``nout`` steps, with the hop draws of :meth:`draws` (``key`` an
        integer).

        Result carries ``x``/``p``/``c``/``active`` (nsnap, ntraj, ...),
        ``population`` (surface estimator, (nsnap, ns)),
        ``population_wf`` (|c|^2 estimator) and ``energy`` (nsnap, ntraj),
        on the solver's device.

        ``mesh`` (a DeviceMesh): the trajectories are cut over its first
        axis (chunks of ceil(ntraj / d)); every rank makes the whole draw
        table from ``key`` and keeps its columns, so the sharded run equals
        the unsharded one draw for draw. The snapshots are gathered once
        at the end, and every rank returns the whole result."""
        state = self.initial_state(x0, p0, active0, c0)
        nsteps = (nt // nout) * nout
        return self.trajectories(state, self.draws(key, nsteps,
                                                   state[0].shape[0]),
                                 dt, nt, nout, mesh=mesh)

    def _estimators(self, res):
        """The surface and |c|² population estimators of ``res`` from its
        snapshots of the active surfaces and amplitudes."""
        res.population = torch.nn.functional.one_hot(
            res.active, self.nstates).to(torch.float64).mean(dim=1)
        pc = res.c.abs() ** 2
        res.population_wf = (pc / pc.sum(-1, keepdim=True)).mean(dim=1)

    def trajectories(self, state, r, dt, nt, nout, mesh=None) -> Result:
        """Advance ``state`` (:meth:`initial_state`) with the uniform
        draws ``r`` (nsteps, ntraj), any device: row i is step i's.
        Each window's draws are moved to the solver's device when the
        window starts. On CUDA, for two states and a real V, the step
        runs as one CUDA graph
        (:func:`~pyqed_tpu_torch.core.dynamics.cuda_graph_stepper`);
        otherwise its ``eigh`` calls read the host and it runs eagerly.
        With ``mesh`` every rank passes the whole state and draws and
        advances its chunk of the trajectories (:meth:`run`)."""
        mesh = check_mesh(mesh)
        if mesh is not None:
            from torch.utils import _pytree as pytree
            from ..parallel.mesh import axis_group, gather_rows, local_range
            group, rank, d = axis_group(mesh)
            ntraj = state[0].shape[0]
            lo, hi, _ = local_range(ntraj, rank, d)
            res = self.trajectories(
                pytree.tree_map(lambda t: t[lo:hi], state), r[:, lo:hi], dt,
                nt, nout)
            for name in ("x", "p", "c", "active", "energy"):
                setattr(res, name, gather_rows(getattr(res, name), group, d,
                                               n=ntraj, dim=1))
            self._estimators(res)
            return res
        nwin = nt // nout
        if r.shape[0] < nwin * nout:
            raise ValueError(f"{r.shape[0]} rows of draws for "
                             f"{nwin * nout} steps")
        x, p, c, act, _ = state
        ntraj, ns = c.shape
        dev = x.device
        xs = torch.empty((nwin,) + tuple(x.shape), dtype=x.dtype,
                         device=dev)
        ps = torch.empty_like(xs)
        cs = torch.empty((nwin, ntraj, ns), dtype=c.dtype, device=dev)
        acts = torch.empty((nwin, ntraj), dtype=act.dtype, device=dev)
        es = torch.empty((nwin, ntraj), dtype=x.dtype, device=dev)
        rows = torch.arange(ntraj, device=dev)
        closed_form = ns == 2 and not state[4][1].is_complex()
        advance = cuda_graph_stepper(lambda s, ri: self._step(s, ri, dt),
                                     state, r[0].to(dev, torch.float64),
                                     graph=closed_form)
        for w in range(nwin):
            rw = r[w * nout:(w + 1) * nout].to(dev, torch.float64)
            for i in range(nout):
                state = advance(rw[i])
            x, p, c, act, (E, _, _) = state
            xs[w], ps[w], cs[w], acts[w] = x, p, c, act
            es[w] = (p ** 2 / (2.0 * self.mass)).sum(-1) + E[rows, act]

        res = Result(dt=dt, nt=nt, nout=nout)
        res.times = torch.arange(1, nwin + 1, dtype=torch.float64,
                                 device=dev) * dt * nout
        res.x, res.p, res.c, res.active = xs, ps, cs, acts
        res.energy = es
        self._estimators(res)
        return res


def _tully_matrix(v11, v12, v22):
    return torch.stack([torch.stack([v11, v12]), torch.stack([v12, v22])])


def tully_i(A=0.01, B=1.6, C=0.005, D=1.0):
    """Tully model I (single avoided crossing), JCP 93, 1061 (1990)."""
    def v(x):
        d = x[0]
        v11 = torch.where(d >= 0, A * (1 - torch.exp(-B * d)),
                          -A * (1 - torch.exp(B * d)))
        v12 = C * torch.exp(-D * d ** 2)
        return _tully_matrix(v11, v12, -v11)
    return v


def tully_ii(A=0.1, B=0.28, C=0.015, D=0.06, E0=0.05):
    """Tully model II (dual avoided crossing)."""
    def v(x):
        d = x[0]
        v22 = -A * torch.exp(-B * d ** 2) + E0
        v12 = C * torch.exp(-D * d ** 2)
        return _tully_matrix(0.0 * d, v12, v22)
    return v


def tully_iii(A=6e-4, B=0.1, C=0.9):
    """Tully model III (extended coupling with reflection)."""
    def v(x):
        d = x[0]
        v12 = torch.where(d < 0, B * torch.exp(C * d),
                          B * (2 - torch.exp(-C * d)))
        return _tully_matrix(A + 0.0 * d, v12, -A + 0.0 * d)
    return v

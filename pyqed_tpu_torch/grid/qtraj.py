"""Quantum (Bohmian) trajectory dynamics with the linearized quantum
force (PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/qtraj.py`` (reference:
pyqed/qt/qt.py ``QT:24``, ``NAQT:165``; pyqed/qt/lqf.py ``LQF:349``,
``qpot:405``). All trajectories propagate as one batched tensor; the
least-squares fits are small ``torch.linalg.solve_ex`` calls (no info
check, so no host read), and each run steps as one CUDA graph per step on
the card. Draws come from ``torch.Generator().manual_seed(key)`` on the
CPU and are moved to the device, so the same ``key`` gives the same
ensemble on the card and the CPU (not the JAX package's draws: hand the
same ``x``, ``p`` (and ``r``, ``w``, ``c``) to both to compare them).
Inside a run no tensor is made from host data, so the step can be
captured.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..config import resolve_device
from ..core.dynamics import cuda_graph_stepper
from ..core.result import Result
from ..ops.linalg import as_tensor


def _solve(A, B):
    """A^{-1} B without the host read of ``torch.linalg.solve``'s info
    check."""
    return torch.linalg.solve_ex(A, B)[0]


def _normal(key, shape, device):
    """Standard normal draws (float64) from
    ``torch.Generator().manual_seed(key)`` on the CPU, moved to
    ``device``."""
    if not isinstance(key, (int, np.integer)):
        raise TypeError("key must be an integer seed")
    gen = torch.Generator().manual_seed(int(key))
    return torch.randn(shape, generator=gen, dtype=torch.float64).to(device)


def _windows(step, state, nt, nout):
    """Run ``step`` (a CUDA graph per step on the card) for nt // nout
    windows of ``nout`` steps; returns the state after each window."""
    advance = cuda_graph_stepper(step, state)
    out = []
    for _ in range(nt // nout):
        for _ in range(nout):
            state = advance()
        out.append(tuple(x.clone() for x in state))
    return out


def lqf(x, w, mass):
    """Linearized quantum force (reference: pyqed/qt/lqf.py:349).

    Fits r(x) = C^T [x, 1] to the derivative-log-density with the moment
    matrix S = sum_i w_i f_i f_i^T; returns (r (ntraj, ndim), quantum
    force (ntraj, ndim), quantum potential energy).
    """
    ntraj, ndim = x.shape
    f = torch.cat([x, x.new_ones((ntraj, 1))], dim=1)
    S = torch.einsum("i, im, in -> mn", w, f, f)
    C = -0.5 * torch.eye(ndim + 1, ndim, dtype=x.dtype, device=x.device)
    c = _solve(S, C)                              # (ndim+1, ndim)
    r = f @ c                                     # (ntraj, ndim)
    dr = c[:ndim, :]                              # d r_k / d x_j  (j, k)
    # quantum force F_q = -grad(Q) = sum_k r_ik dr_jk / m_k
    fq = torch.einsum("ik, jk -> ij", r, dr / mass[None, :])
    # quantum potential energy: Eu = -1/2m <r^2 + dr>
    Eu = -torch.sum((torch.einsum("i, ik -> k", w, r ** 2)
                     + torch.diagonal(dr)) / (2.0 * mass))
    return r, fq, Eu


@dataclasses.dataclass
class ResultQT(Result):
    x: object = None
    p: object = None
    xAve: object = None


class QT:
    """Bohmian trajectory ensemble (reference: pyqed/qt/qt.py:24) on
    ``device`` (the card when None; raises without one)."""

    def __init__(self, ntraj, ndim, mass=None, device=None):
        self.device = resolve_device(device)
        self.ntraj = ntraj
        self.ndim = ndim
        self.mass = np.asarray(mass if mass is not None else [1.0] * ndim,
                               dtype=float)
        self.x = None
        self.p = None
        self.w = None
        self.force = None

    def sample(self, key=None, x0=None, p0=None, sigma=None):
        """Gaussian ensemble (reference: pyqed/qt/qt.py:40); ``key`` an
        integer seed (0 when None)."""
        dev = self.device
        x0 = np.zeros(self.ndim) if x0 is None else np.asarray(x0, float)
        p0 = np.zeros(self.ndim) if p0 is None else np.asarray(p0, float)
        sigma = (np.ones(self.ndim) / np.sqrt(2.0) if sigma is None
                 else np.asarray(sigma, float))
        t = lambda a: torch.as_tensor(a, device=dev)
        self.x = (_normal(0 if key is None else key,
                          (self.ntraj, self.ndim), dev)
                  * t(sigma)[None, :] + t(x0)[None, :])
        self.p = t(p0)[None, :].repeat(self.ntraj, 1)
        self.w = torch.full((self.ntraj,), 1.0 / self.ntraj,
                            dtype=torch.float64, device=dev)
        return self.x

    def set_force(self, force: Callable):
        """Classical force F(x) on each trajectory (torch ops)."""
        self.force = force

    def run(self, dt, nt, nout=1, friction=0.0) -> ResultQT:
        """Velocity-Verlet-like propagation with the LQF quantum force
        (reference loop: pyqed/qt/qt.py:108), from ``self.x``, ``self.p``
        and ``self.w`` (as ``sample`` sets them, or assigned)."""
        if self.force is None:
            raise ValueError("set_force(F) before run()")
        dev = self.device
        mass = torch.as_tensor(self.mass, device=dev)
        w = as_tensor(self.w, device=dev)
        force = self.force

        def total_force(x, p):
            _, fq, Eu = lqf(x, w, mass)
            return force(x) + fq - friction * p, Eu

        def step(state):
            x, p = state[:2]
            F, _ = total_force(x, p)
            p_half = p + 0.5 * dt * F
            x_new = x + dt * p_half / mass[None, :]
            F2, Eu2 = total_force(x_new, p_half)
            p_new = p_half + 0.5 * dt * F2
            xave = torch.einsum("i, ij -> j", w, x_new)
            energy = (torch.sum(torch.einsum("i, ij -> j", w, p_new ** 2)
                                / (2 * mass)) + Eu2)
            return x_new, p_new, xave, energy

        x0 = as_tensor(self.x, device=dev)
        state = (x0, as_tensor(self.p, device=dev), x0[0],
                 x0.new_zeros(()))
        rows = _windows(step, state, nt, nout)
        r = ResultQT(dt=dt, nt=nt, nout=nout)
        r.times = torch.arange(1, len(rows) + 1, dtype=torch.float64,
                               device=dev) * dt * nout
        last = rows[-1] if rows else state
        r.x, r.p = last[0], last[1]
        r.xAve = torch.stack([s[2] for s in rows]) if rows else None
        r.observables = (torch.stack([s[3] for s in rows])[:, None]
                         if rows else None)
        self.x, self.p = r.x, r.p
        return r


class NAQT:
    """Nonadiabatic quantum trajectories: Ehrenfest mean-field forces and
    the LQF quantum force, with per-trajectory electronic coefficients
    (reference: pyqed/qt/lqf.py:473 ``NAQT`` and qt/qt.py:165).

    Parameters
    ----------
    dpes1 : callable x (ndim,) -> (ns, ns), pointwise, in torch ops; the
        potential is ``torch.func.vmap(dpes1)`` and its gradient
        ``torch.func.vmap(torch.func.jacfwd(dpes1))``.
    device : the card when None (raises without one).
    """

    def __init__(self, ntraj, ndim, nstates, dpes1: Callable, mass=None,
                 device=None):
        self.device = resolve_device(device)
        self.ntraj = ntraj
        self.ndim = ndim
        self.nstates = nstates
        self.dpes1 = dpes1
        self.mass = torch.as_tensor(
            np.asarray(mass if mass is not None else np.ones(ndim), float),
            device=self.device)
        self.w = torch.full((ntraj,), 1.0 / ntraj, dtype=torch.float64,
                            device=self.device)
        self._V = torch.func.vmap(dpes1)
        self._dV = torch.func.vmap(torch.func.jacfwd(dpes1))

    def sample(self, a, x0, state=0, key=0):
        """Gaussian cloud of psi0 ~ exp(-a (x-x0)^2): the width
        convention of the reference sample (lqf.py:491). Returns
        (x, p, c) on the device."""
        dev = self.device
        a = torch.atleast_1d(torch.as_tensor(np.asarray(a, float),
                                             device=dev))
        x0 = torch.atleast_1d(torch.as_tensor(np.asarray(x0, float),
                                              device=dev))
        x = (_normal(key, (self.ntraj, self.ndim), dev)
             / torch.sqrt(2.0 * a)[None, :] + x0[None, :])
        p = torch.zeros((self.ntraj, self.ndim), dtype=torch.float64,
                        device=dev)
        c = torch.zeros((self.ntraj, self.nstates), dtype=torch.complex128,
                        device=dev)
        c[:, state] = 1.0
        return x, p, c

    def run(self, x, p, c, dt, nt, nout=1):
        """Velocity-Verlet nuclei and RK4 electronic coefficients; returns
        a ResultQT with populations (ns_steps+1, nstates) and the mean
        positions ``xave``."""
        dev = self.device
        mass, w, V, dV = self.mass, self.w, self._V, self._dV
        x = as_tensor(x, device=dev).to(torch.float64)
        p = as_tensor(p, device=dev).to(torch.float64)
        c = as_tensor(c, device=dev).to(torch.complex128)

        def forces(x, c):
            # Ehrenfest: F = -<c| dV |c> per trajectory
            dv = dV(x).to(c.dtype)                       # (N, ns, ns, D)
            F_cl = -(torch.einsum("na, nabd, nb -> nd", c.conj(), dv, c)
                     / torch.sum(c.abs() ** 2, dim=1)[:, None]).real
            _, F_q, _ = lqf(x, w, mass)
            return F_cl + F_q

        def cdot(v, c):
            return -1j * torch.einsum("nab, nb -> na", v, c)

        def step(state):
            x, p, c = state
            p = p + 0.5 * dt * forces(x, c)
            x = x + dt * p / mass[None, :]
            # RK4 on c with the new positions
            v = V(x).to(c.dtype)
            k1 = cdot(v, c)
            k2 = cdot(v, c + 0.5 * dt * k1)
            k3 = cdot(v, c + 0.5 * dt * k2)
            k4 = cdot(v, c + dt * k3)
            c = c + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
            c = c / torch.linalg.vector_norm(c, dim=1, keepdim=True)
            p = p + 0.5 * dt * forces(x, c)
            return x, p, c

        def observe(x, c):
            return (torch.einsum("n, na -> a", w, c.abs() ** 2),
                    torch.einsum("n, nd -> d", w, x))

        rows = [(x, p, c)] + _windows(step, (x, p, c), nt, nout)
        obs = [observe(s[0], s[2]) for s in rows]
        r = ResultQT(dt=dt, nt=nt, nout=nout)
        r.times = torch.arange(len(rows), dtype=torch.float64,
                               device=dev) * dt * nout
        r.population = torch.stack([o[0] for o in obs])
        r.xave = torch.stack([o[1] for o in obs])
        r.x, r.p, r.c = rows[-1]
        return r


def qpot(x, p, r, w, mass=1.0):
    """Linear quantum force with friction (the dissipative AQP variant):
    weighted linear fits of the momentum field p(x) and of r(x) over the
    ensemble (reference: pyqed/qt/lqf.py:405 ``qpot``, for any ndim).

    Returns (Eu, fq, fr): quantum potential energy, quantum force, and
    friction force fr = -(2 r dp + ddp)/2m (a linear fit: ddp = 0).
    """
    x, p, r = (as_tensor(a) for a in (x, p, r))
    x, p, r = (a.reshape(a.shape[0], -1) for a in (x, p, r))
    w = as_tensor(w, device=x.device)
    ntraj, ndim = x.shape
    mass = (torch.full((ndim,), float(mass), dtype=x.dtype, device=x.device)
            if np.isscalar(mass) else torch.broadcast_to(
                as_tensor(mass, dtype=x.dtype, device=x.device), (ndim,)))
    f = torch.cat([x, x.new_ones((ntraj, 1))], dim=1)
    S = torch.einsum("i, im, in -> mn", w, f, f)
    bp = torch.einsum("i, im, ik -> mk", w, f, p)
    br = torch.einsum("i, im, ik -> mk", w, f, r)
    cp = _solve(S, bp)                          # (ndim+1, ndim)
    cr = _solve(S, br)
    dp = cp[:ndim, :]                           # d p_k / d x_j
    dr = cr[:ndim, :]
    fq = torch.einsum("ik, jk -> ij", r, dr / mass[None, :])
    fr = -torch.einsum("ik, jk -> ij", r, dp / mass[None, :])
    Eu = -torch.sum((torch.einsum("i, ik -> k", w, r ** 2)
                     + torch.diagonal(dr)) / (2.0 * mass))
    return Eu, fq, fr


class QTF:
    """Quantum trajectories with friction (AQP ground-state relaxation;
    reference: pyqed/qt/1D/QTF_1D.py and qt/1D/HigherOrder_1D.py): the
    Bohmian ensemble (x, p, r) with the approximate quantum potential from
    a polynomial fit (``qpot_poly(order=)``; order 1 is the linear LQF)
    and a friction constant, on ``device`` (the card when None).

    ``qpot``: an optional quantum-force model (x, p, r, w, mass) ->
    (Eu, fq, fr), e.g. ``functools.partial(qpot_domains, xdom=[0.0])``.
    """

    def __init__(self, ntraj, mass=1.0, order=3, friction=0.0,
                 qpot=None, device=None):
        self.device = resolve_device(device)
        self.ntraj = ntraj
        self.mass = float(mass)
        self.order = order
        self.friction = friction
        self.qpot = qpot

    def sample(self, a0, x0=0.0, key=None):
        """Ensemble of psi0 ~ exp(-a0 (x-x0)^2 / 2): r = -a0 (x - x0),
        density exp(-a0 (x-x0)^2). By default a deterministic quadrature
        (a uniform grid over x0 +- 6 sigma, weights ~ the density);
        with an integer ``key``, Monte-Carlo draws of equal weight.

        Returns (x, p, r, w) on the device."""
        dev = self.device
        sig = 1.0 / np.sqrt(2.0 * a0)
        if key is None:
            x = x0 + torch.linspace(-6.0, 6.0, self.ntraj,
                                    dtype=torch.float64, device=dev) * sig
            w = torch.exp(-a0 * (x - x0) ** 2)
            w = w / torch.sum(w)
        else:
            x = x0 + sig * _normal(key, (self.ntraj,), dev)
            w = torch.full((self.ntraj,), 1.0 / self.ntraj,
                           dtype=torch.float64, device=dev)
        p = torch.zeros_like(x)
        r = -a0 * (x - x0)
        return x, p, r, w

    def run(self, x, p, r, w, derivs: Callable, dt, nt, nout=10):
        """RK4 of the ensemble ODE

            dx/dt = p/m,  dp/dt = -dV + fq - gamma p,  dr/dt = fr,

        ``derivs(x) -> (V, dV)`` vectorized in torch ops. Returns a
        ResultQT whose observables columns are (E_kinetic, E_potential,
        E_quantum, E_total) at the end of each window."""
        dev = self.device
        am, gam, order = self.mass, self.friction, self.order
        qp = (self.qpot if self.qpot is not None
              else (lambda x, p, r, w, mass: qpot_poly(
                  x, p, r, w, mass=mass, order=order)))
        x, p, r, w = (as_tensor(a, device=dev).to(torch.float64)
                      for a in (x, p, r, w))

        def rhs(state):
            x, p, r = state
            _, fq, fr = qp(x, p, r, w, mass=am)
            _, dv = derivs(x)
            return (p / am, -dv + fq - gam * p, fr)

        def step(state):
            carry = state[:3]
            k1 = rhs(carry)
            k2 = rhs(tuple(c + dt / 2 * k for c, k in zip(carry, k1)))
            k3 = rhs(tuple(c + dt / 2 * k for c, k in zip(carry, k2)))
            k4 = rhs(tuple(c + dt * k for c, k in zip(carry, k3)))
            x, p, r = tuple(
                c + dt / 6 * (a + 2 * b + 2 * cc + d)
                for c, a, b, cc, d in zip(carry, k1, k2, k3, k4))
            Eu, _, _ = qp(x, p, r, w, mass=am)
            v0, _ = derivs(x)
            Ek = torch.dot(p * p, w) / (2 * am)
            Ev = torch.dot(v0, w)
            return x, p, r, torch.stack([Ek, Ev, Eu])

        state = (x, p, r, x.new_zeros(3))
        rows = _windows(step, state, nt, nout)
        res = ResultQT(dt=dt, nt=nt, nout=nout)
        res.times = torch.arange(1, len(rows) + 1, dtype=torch.float64,
                                 device=dev) * dt * nout
        res.x, res.p, res.r = rows[-1][:3] if rows else state[:3]
        E = torch.stack([s[3] for s in rows])
        res.observables = torch.cat([E, E.sum(dim=1, keepdim=True)], dim=1)
        return res


def qpot_poly(x, p, r, w, mass=1.0, order=5):
    """Higher-order (polynomial) quantum and friction forces of a 1D
    ensemble (reference: pyqed/qt/1D/HigherOrder_1D.py:81 ``qpot``):
    weighted least squares of p(x) and r(x) in the monomials of the
    centred and scaled coordinate u = (x - <x>)/sigma up to ``order``;
    returns (Eu, fq, fr) with fq = (2 r dr + ddr)/2m,
    fr = -(2 r dp + ddp)/2m, Eu = -<r^2 + dr>/2m.
    """
    x, p, r = (as_tensor(a).reshape(-1) for a in (x, p, r))
    w = as_tensor(w, device=x.device).reshape(-1)
    nb = order + 1
    powers = torch.arange(nb, device=x.device)
    xm = torch.dot(w, x)
    sig = torch.sqrt(torch.dot(w, (x - xm) ** 2) + 1e-30)
    u = (x - xm) / sig
    F = u[:, None] ** powers[None, :]               # (ntraj, nb)
    S = torch.einsum("i, im, in -> mn", w, F, F)
    bp = torch.einsum("i, im, i -> m", w, F, p)
    br = torch.einsum("i, im, i -> m", w, F, r)
    cp = _solve(S, bp[:, None])[:, 0]
    cr = _solve(S, br[:, None])[:, 0]
    pw = powers[None, :]
    D1 = torch.where(pw >= 1, pw * u[:, None] ** (pw - 1).clamp_min(0),
                     torch.zeros((), dtype=u.dtype, device=u.device))
    D2 = torch.where(pw >= 2, pw * (pw - 1)
                     * u[:, None] ** (pw - 2).clamp_min(0),
                     torch.zeros((), dtype=u.dtype, device=u.device))
    dr = (D1 @ cr) / sig
    dp = (D1 @ cp) / sig
    ddr = (D2 @ cr) / sig ** 2
    ddp = (D2 @ cp) / sig ** 2
    fq = (2.0 * r * dr + ddr) / (2.0 * mass)
    fr = -(2.0 * r * dp + ddp) / (2.0 * mass)
    Eu = -torch.dot(w, r ** 2 + dr) / (2.0 * mass)
    return Eu, fq, fr


def qpot_domains(x, p, r, w, xdom, mass=1.0, sharp=8.0):
    """Domain-decomposed LQF: r(x) and p(x) are fit linearly inside each
    spatial domain and blended with smooth tanh partition functions
    (reference: pyqed/qt/1D/domain/{main,fit}.py). ``xdom``: sorted
    interior domain edges (K edges -> K+1 domains). Returns (Eu, fq, fr)
    like :func:`qpot_poly`.
    """
    x, p, r = (as_tensor(a).reshape(-1) for a in (x, p, r))
    w = as_tensor(w, device=x.device).reshape(-1)
    xdom = [float(v) for v in np.atleast_1d(np.asarray(xdom, float))]
    d = sharp
    K = len(xdom)

    ts = [torch.tanh(d * (x - xe)) for xe in xdom]
    sech2 = [1.0 - t ** 2 for t in ts]
    thetas = [0.5 * (1.0 - ts[0])]
    dthetas = [-0.5 * d * sech2[0]]
    ddthetas = [d * d * ts[0] * sech2[0]]
    for k in range(K - 1):
        thetas.append(0.5 * (ts[k] - ts[k + 1]))
        dthetas.append(0.5 * d * (sech2[k] - sech2[k + 1]))
        ddthetas.append(-d * d * (ts[k] * sech2[k]
                                  - ts[k + 1] * sech2[k + 1]))
    thetas.append(0.5 * (1.0 + ts[-1]))
    dthetas.append(0.5 * d * sech2[-1])
    ddthetas.append(-d * d * ts[-1] * sech2[-1])

    def blend(y):
        """Domain-wise weighted linear fits of y(x), blended:
        (yhat, dyhat, ddyhat)."""
        yh = torch.zeros_like(x)
        dyh = torch.zeros_like(x)
        ddyh = torch.zeros_like(x)
        for th, dth, ddth in zip(thetas, dthetas, ddthetas):
            wk = w * th
            s0 = torch.sum(wk)
            s1 = torch.dot(wk, x)
            s2 = torch.dot(wk, x * x)
            b0 = torch.dot(wk, y)
            b1 = torch.dot(wk, x * y)
            det = s0 * s2 - s1 * s1 + 1e-300
            a0 = (s2 * b0 - s1 * b1) / det
            a1 = (s0 * b1 - s1 * b0) / det
            yk = a0 + a1 * x
            yh = yh + th * yk
            dyh = dyh + dth * yk + th * a1
            ddyh = ddyh + ddth * yk + 2.0 * dth * a1
        return yh, dyh, ddyh

    rh, drh, ddrh = blend(r)
    ph, dph, ddph = blend(p)
    fq = (2.0 * rh * drh + ddrh) / (2.0 * mass)
    fr = -(2.0 * r * dph + ddph) / (2.0 * mass)
    Eu = -torch.dot(w, rh ** 2 + drh) / (2.0 * mass)
    return Eu, fq, fr


def vpot_ph2(r):
    """para-H2 dimer Morse/long-range (MLR) potential, Eh vs bohr
    (reference: pyqed/qt/1D/pH2.py). Depth 24.2288 cm^-1 at re = 3.47005
    Angstrom; the long-range tail is the damped C6/C8/C10 dispersion."""
    bohr_angstrom = 0.52917721092
    hartree_wavenumber = 219474.63
    Vmin = -24.2288
    bcoef = [-6.631e-02, 1.346e-01, -3.300e-02, 6e0, -1.4e01, -1.193e02,
             2.290e02, 1.110e03, -1.850e03, -3.5e03, 6.0e03]
    re = 3.47005
    De = 24.2288
    r = as_tensor(r).to(torch.float64) * bohr_angstrom      # to Angstrom

    def damp(r, n):
        den = 1.10
        return (1.0 - torch.exp(-3.30 * den * r / n
                                - 0.423 * (den * r) ** 2
                                / np.sqrt(float(n)))) ** (n - 1)

    def u_LR(r):
        C6, C8, C10 = 5.820364e04, 2.87052154e05, 1.80757343e06
        return (damp(r, 6) * C6 / r ** 6 + damp(r, 8) * C8 / r ** 8
                + damp(r, 10) * C10 / r ** 10)

    def y_ref(r, n):
        r_ref = 4.60
        return (r ** n - r_ref ** n) / (r ** n + r_ref ** n)

    def y_eq(r, n):
        return (r ** n - re ** n) / (r ** n + re ** n)

    re_t = torch.full((), re, dtype=torch.float64, device=r.device)
    beta_inf = torch.log(2.0 * De / u_LR(re_t))
    s = sum(bcoef[j] * y_ref(r, 1) ** j for j in range(11))
    beta = y_ref(r, 6) * beta_inf + (1.0 - y_ref(r, 6)) * s
    v = De * (1.0 - u_LR(r) / u_LR(re_t) * torch.exp(-beta * y_eq(r, 6))) ** 2
    return (v + Vmin) / hartree_wavenumber

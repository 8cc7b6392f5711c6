"""Wavepacket dynamics in fixed and moving Gaussian bases (PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/gwp.py`` (reference:
pyqed/moving_gaussian.py ``GWP:29``, ``WPD:157``; pyqed/ldr/gwp.py
``GWP:94``, ``WPD:282``, ``WPD2:562``). Pairwise matrix elements
(overlap, moments, kinetic) are closed Gaussian formulas evaluated as
broadcast outer products; dynamics in the nonorthogonal basis goes
through the generalized eigenproblem once (fixed basis). The potential
integrals of :class:`WPDN` evaluate the user's potential at complex
quadrature points through ``torch.func.vmap``, in chunks of pairs;
:class:`ThawedGaussian` takes its gradient and Hessian from
``torch.func``. Solvers live on ``device`` (the card when None; raises
without one).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor

# potential evaluations per chunk of WPDN.potential_matrix (pairs x nodes)
POTENTIAL_CHUNK = 1 << 21


def _t(a):
    """A tensor of ``a`` (float64 for NumPy input and scalars), on its own
    device if it is a tensor."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a, dtype=float))


@dataclasses.dataclass
class GWP:
    """A 1D Gaussian wavepacket basis function
    (reference: pyqed/moving_gaussian.py:29)."""
    q: float
    p: float = 0.0
    a: float = 1.0
    phase: float = 0.0

    def evaluate(self, x):
        """Values at ``x`` (a tensor on its device, or NumPy on the CPU)."""
        x = _t(x)
        return ((self.a / math.pi) ** 0.25
                * torch.exp(-0.5 * self.a * (x - self.q) ** 2
                            + 1j * self.p * (x - self.q)
                            + 1j * self.phase))


def overlap_real(aj, qj, ak, qk):
    """<g_j|g_k> for real Gaussians (reference:
    pyqed/moving_gaussian.py:96), broadcastable tensors."""
    aj, qj, ak, qk = (_t(v) for v in (aj, qj, ak, qk))
    dq = qk - qj
    return ((aj * ak) ** 0.25 * torch.sqrt(2.0 / (aj + ak))
            * torch.exp(-0.5 * aj * ak / (aj + ak) * dq ** 2))


def moment_real(aj, qj, ak, qk, n=1):
    """<g_j|(x - q_j)^n|g_k> for n = 1, 2."""
    aj, qj, ak, qk = (_t(v) for v in (aj, qj, ak, qk))
    S = overlap_real(aj, qj, ak, qk)
    if n == 1:
        return (ak * (qk - qj) / (aj + ak)) * S
    if n == 2:
        return (1.0 / (aj + ak) + ak ** 2 * (qk - qj) ** 2
                / (aj + ak) ** 2) * S
    raise ValueError(n)


def kinetic_real(aj, qj, ak, qk, mass=1.0):
    """<g_j| -1/(2m) d^2/dx^2 |g_k> for real Gaussians (closed form)."""
    aj, qj, ak, qk = (_t(v) for v in (aj, qj, ak, qk))
    S = overlap_real(aj, qj, ak, qk)
    mu = aj * ak / (aj + ak)
    dq = qj - qk
    return S * mu / (2 * mass) * (1.0 - mu * dq ** 2)


class WPD:
    """Dynamics on one PES in a fixed real-Gaussian basis
    (reference: pyqed/moving_gaussian.py:157): H and S in closed form,
    evolution through the generalized eigenproblem (Löwdin).

    ``widths`` None gives unit widths (the JAX package's constructor
    builds an object array of None there)."""

    def __init__(self, centers, widths=None, mass=1.0, device=None):
        self.device = resolve_device(device)
        self.q = np.asarray(centers, dtype=float)
        self.nb = len(self.q)
        if widths is None or np.isscalar(widths):
            self.a = np.full(self.nb, 1.0 if widths is None else
                             float(widths))
        else:
            self.a = np.asarray(widths, dtype=float)
        self.mass = mass
        self.v = None

    def _pairs(self):
        a = torch.as_tensor(self.a, device=self.device)
        q = torch.as_tensor(self.q, device=self.device)
        return a[:, None], q[:, None], a[None, :], q[None, :]

    def overlap_matrix(self):
        return overlap_real(*self._pairs())

    def kinetic_matrix(self):
        return kinetic_real(*self._pairs(), self.mass)

    def potential_matrix(self, V, nquad=40):
        """<g_j|V|g_k> by Gauss-Hermite quadrature on each pair's product
        Gaussian, all pairs at once. ``V`` is evaluated on a NumPy array
        of nodes (N, N, nquad), as in the JAX package."""
        xg, wg = np.polynomial.hermite.hermgauss(nquad)
        aj = self.a[:, None, None]
        ak = self.a[None, :, None]
        qj = self.q[:, None, None]
        qk = self.q[None, :, None]
        p_ = aj + ak
        qc = (aj * qj + ak * qk) / p_
        x = qc + xg[None, None, :] * np.sqrt(2.0 / p_)
        Vq = torch.as_tensor(np.asarray(V(x), dtype=float),
                             device=self.device)
        w = torch.as_tensor(wg, device=self.device)
        integral = torch.einsum("q, jkq -> jk", w, Vq) / math.sqrt(math.pi)
        return self.overlap_matrix() * integral

    def buildH(self, V):
        S = self.overlap_matrix()
        H = self.kinetic_matrix() + self.potential_matrix(V)
        self.S, self.H = S, H
        return self.H, self.S

    def eigenstates(self, V=None, k=5):
        if V is not None or not hasattr(self, "H"):
            self.buildH(V)
        # generalized eigenproblem by Löwdin orthogonalization
        s, U = torch.linalg.eigh(self.S)
        keep = s > 1e-10
        X = U[:, keep] * (1.0 / torch.sqrt(s[keep]))[None, :]
        w, c = torch.linalg.eigh(X.T @ self.H @ X)
        return w[:k], X @ c[:, :k]

    def project(self, psi_fn, xgrid):
        """Expansion coefficients of psi(x) sampled on ``xgrid`` by solving
        S c = b with b_j = <g_j|psi> (rectangle rule on the grid)."""
        x = np.asarray(xgrid)
        dx = x[1] - x[0]
        psi = np.asarray(psi_fn(x) if callable(psi_fn) else psi_fn)
        g = ((self.a[None, :] / np.pi) ** 0.25
             * np.exp(-0.5 * self.a[None, :]
                      * (x[:, None] - self.q[None, :]) ** 2))
        b = torch.as_tensor(g.T @ psi * dx, device=self.device)
        return torch.linalg.solve(self.overlap_matrix().to(torch.complex128),
                                  b.to(torch.complex128))

    def run(self, c0, dt, nt, V=None, nout=1):
        """Propagate the coefficients: i S dc/dt = H c. ``states`` holds
        c at t = 0, nout dt, ... (rows), ``psi`` the last."""
        from ..core.result import Result
        if V is not None or not hasattr(self, "H"):
            self.buildH(V)
        s, U = torch.linalg.eigh(self.S)
        X = U * (1.0 / torch.sqrt(s))[None, :]
        w, Z = torch.linalg.eigh(X.T @ self.H @ X)
        c0 = as_tensor(c0, device=self.device).to(torch.complex128)
        # c in the orthonormal basis: d = X^{-1} c = sqrt(s) U^T c
        d0 = ((torch.sqrt(s)[:, None] * U.T).to(c0.dtype)) @ c0
        ns = nt // nout
        times = torch.arange(ns + 1, dtype=torch.float64,
                             device=self.device) * dt * nout
        phases = torch.exp(-1j * w[None, :] * times[:, None])
        Zc = Z.to(c0.dtype)
        d_t = torch.einsum("nk, tk, k -> tn", Zc, phases, Zc.T @ d0)
        c_t = (X.to(c0.dtype) @ d_t.T).T
        r = Result(times=times, dt=dt, nt=nt, nout=nout)
        r.states = c_t
        r.psi = c_t[-1]
        return r

    def wavefunction(self, c, x):
        """psi(x) from coefficients."""
        x = as_tensor(x, device=self.device)
        a = torch.as_tensor(self.a, device=self.device)
        q = torch.as_tensor(self.q, device=self.device)
        g = ((a[None, :] / math.pi) ** 0.25
             * torch.exp(-0.5 * a[None, :] * (x[:, None] - q[None, :]) ** 2))
        c = as_tensor(c, device=self.device)
        return g.to(c.dtype) @ c


# ===================================================================
# N-dimensional static Gaussian basis with complex momenta
# (reference: pyqed/ldr/gwp.py:94 ``GWP``, :282 ``WPD``, :562 ``WPD2``)
# ===================================================================

@dataclasses.dataclass
class GWPBasis:
    """N frozen Gaussians  g(x) = prod_d (2a/pi)^{1/4}
    exp(-a_d (x_d - q_d)^2 + i p_d (x_d - q_d)).

    q, p, a : float64 tensors (N, d) on one device.
    """
    q: torch.Tensor
    p: torch.Tensor
    a: torch.Tensor

    @classmethod
    def grid(cls, centers: Sequence, a=1.0, p=0.0, device=None):
        """Direct-product lattice of Gaussians from per-dimension centre
        lists, on ``device`` (the card when None)."""
        dev = resolve_device(device)
        mesh = np.meshgrid(*[np.asarray(c, float) for c in centers],
                           indexing="ij")
        q = np.stack([m.ravel() for m in mesh], axis=-1)
        n, d = q.shape
        full = lambda v: torch.as_tensor(
            np.broadcast_to(np.asarray(v, float), (n, d)).copy(), device=dev)
        return cls(torch.as_tensor(q, device=dev), full(p), full(a))

    @classmethod
    def from_reference(cls, ref, device=None):
        """The port's basis from the JAX package's ``GWPBasis`` (its q, p
        and a, copied through NumPy) on ``device``."""
        dev = resolve_device(device)
        return cls(*(torch.as_tensor(np.asarray(getattr(ref, k), float),
                                     device=dev) for k in ("q", "p", "a")))

    @property
    def nbasis(self):
        return self.q.shape[0]

    @property
    def ndim(self):
        return self.q.shape[1]

    def evaluate(self, x):
        """Basis functions at points x (M, d) -> (M, N) complex."""
        q, p, a = self.q, self.p, self.a
        x = as_tensor(x, device=q.device)
        dx = x[:, None, :] - q[None, :, :]          # (M, N, d)
        norm = torch.prod((2 * a / math.pi) ** 0.25, dim=-1)
        phase = torch.sum(-a * dx ** 2 + 1j * p * dx, dim=-1)
        return norm[None, :] * torch.exp(phase)


def _pair_core(q, p, a):
    """Per-dimension pairwise Gaussian-product data, each (N, N, d):
    the per-dimension overlap S, the product width alpha = a_j + a_k and
    the complex product centre mu = beta / (2 alpha)."""
    aj, ak = a[:, None, :], a[None, :, :]
    qj, qk = q[:, None, :], q[None, :, :]
    pj, pk = p[:, None, :], p[None, :, :]
    alpha = aj + ak
    beta = 2 * aj * qj + 2 * ak * qk + 1j * (pk - pj)
    gamma = (-aj * qj ** 2 - ak * qk ** 2
             + 1j * (pj * qj - pk * qk))
    norm = (2 * aj / math.pi) ** 0.25 * (2 * ak / math.pi) ** 0.25
    S = norm * torch.sqrt(math.pi / alpha) * torch.exp(
        beta ** 2 / (4 * alpha) + gamma)
    return S, alpha, beta / (2 * alpha)


class WPDN:
    """Wavepacket dynamics in a static Gaussian basis (any ndim).

    Parameters
    ----------
    basis : GWPBasis; the solver runs on its device.
    mass : scalar or (d,) masses.
    potential : callable x (d,) -> scalar on tensors, evaluated at
        complex points under ``torch.func.vmap`` (write it in torch ops).
    nquad : Gauss-Hermite order of the potential integrals.

    Reference parity: pyqed/ldr/gwp.py:282 ``WPD.buildH/eigenstates/run``.
    """

    def __init__(self, basis: GWPBasis, mass=1.0,
                 potential: Optional[Callable] = None, nquad: int = 24):
        self.basis = basis
        self.device = basis.q.device
        d = basis.ndim
        self.mass = torch.as_tensor(
            np.broadcast_to(np.asarray(mass, float), (d,)).copy(),
            device=self.device)
        self.potential = potential
        self.nquad = nquad
        self._S = None
        self._H = None

    @classmethod
    def from_reference(cls, ref, potential=None, device=None):
        """The port's solver from the JAX package's ``WPDN``: its basis
        (q, p, a), masses and quadrature order; ``potential`` (a torch
        callable) replaces the JAX one."""
        return cls(GWPBasis.from_reference(ref.basis, device=device),
                   mass=np.asarray(ref.mass), potential=potential,
                   nquad=ref.nquad)

    # ---- matrices -------------------------------------------------
    def overlap(self):
        if self._S is None:
            Sd, _, _ = _pair_core(self.basis.q, self.basis.p, self.basis.a)
            self._S = torch.prod(Sd, dim=-1)
        return self._S

    def kinetic(self):
        """T = sum_d (-1/2m_d) <g_j| d^2/dx_d^2 |g_k>, closed form through
        the central moments U1, U2 about q_k."""
        q, p, a = self.basis.q, self.basis.p, self.basis.a
        Sd, alpha, mu = _pair_core(q, p, a)
        ak = a[None, :, :]
        pk = p[None, :, :]
        qk = q[None, :, :]
        M1 = Sd * mu
        M2 = Sd * (mu ** 2 + 1 / (2 * alpha))
        U1 = M1 - qk * Sd
        U2 = M2 - 2 * qk * M1 + qk ** 2 * Sd
        D2 = (-2 * ak - pk ** 2) * Sd - 4j * ak * pk * U1 + 4 * ak ** 2 * U2
        # product over the other dimensions
        allS = torch.prod(Sd, dim=-1, keepdim=True)
        rest = torch.where(Sd.abs() > 0, allS / Sd, torch.zeros_like(Sd))
        return torch.sum(-D2 * rest / (2 * self.mass), dim=-1)

    def potential_matrix(self, potential: Optional[Callable] = None):
        """V_jk by per-pair Gauss-Hermite quadrature at the complex product
        centre: the potential at n² · nquad^d complex points, in chunks of
        :data:`POTENTIAL_CHUNK` evaluations."""
        V = potential if potential is not None else self.potential
        if V is None:
            raise ValueError("no potential supplied")
        q, p, a = self.basis.q, self.basis.p, self.basis.a
        Sd, alpha, mu = _pair_core(q, p, a)
        S = torch.prod(Sd, dim=-1)
        t, w = np.polynomial.hermite.hermgauss(self.nquad)
        d = self.basis.ndim
        # tensor-product nodes (nquad^d, d) and weights (nquad^d,)
        nodes = np.stack(np.meshgrid(*([t] * d), indexing="ij"),
                         axis=-1).reshape(-1, d)
        wts = np.prod(np.stack(np.meshgrid(*([w / np.sqrt(np.pi)] * d),
                                           indexing="ij"), axis=-1)
                      .reshape(-1, d), axis=-1)
        nodes = torch.as_tensor(nodes, device=self.device)
        wts = torch.as_tensor(wts, device=self.device)
        n = self.basis.nbasis
        mu = mu.reshape(n * n, d)
        scale = (1.0 / torch.sqrt(alpha)).reshape(n * n, d)
        Vv = torch.func.vmap(V)
        vals = torch.empty(n * n, dtype=mu.dtype, device=self.device)
        step = max(1, POTENTIAL_CHUNK // nodes.shape[0])
        for i in range(0, n * n, step):
            x = (mu[i:i + step, None, :]
                 + nodes[None, :, :] * scale[i:i + step, None, :])
            v = Vv(x.reshape(-1, d)).reshape(x.shape[0], -1)
            vals[i:i + step] = torch.sum(wts * v, dim=-1)
        return S * vals.reshape(n, n)

    def buildH(self, potential: Optional[Callable] = None):
        self._H = self.kinetic() + self.potential_matrix(potential)
        return self._H

    # ---- spectra / dynamics ---------------------------------------
    def _pencil(self):
        """(E, C, X): the generalized eigenpairs through the overlap's
        eigenvectors, eigenvalues below 1e-10 of the largest cut (their
        columns of X are zero, so E holds a zero for each)."""
        if self._H is None:
            self.buildH()
        S = self.overlap()
        w, U = torch.linalg.eigh(S)
        keep = w > 1e-10 * torch.max(w)
        inv = torch.where(keep, 1 / torch.sqrt(torch.where(keep, w, 1.0)),
                          torch.zeros_like(w))
        X = U * inv.to(U.dtype)[None, :]
        Ht = X.mH @ self._H @ X
        E, C = torch.linalg.eigh(0.5 * (Ht + Ht.mH))
        return E, X @ C, X

    def eigenstates(self, k=None):
        """(E, coeffs) of the generalized problem H c = E S c."""
        E, C, _ = self._pencil()
        if k is not None:
            return E[:k], C[:, :k]
        return E, C

    def norm(self, c):
        """<c|S|c> for c (N,) or a stack (T, N)."""
        c = as_tensor(c, device=self.device)
        return torch.einsum("...j, jk, ...k -> ...", c.conj(),
                            self.overlap(), c).real

    def position(self, c, d=0):
        """<x_d> for a coefficient vector c (N,) or a stack (T, N)."""
        c = as_tensor(c, device=self.device)
        q, p, a = self.basis.q, self.basis.p, self.basis.a
        Sd, alpha, mu = _pair_core(q, p, a)
        allS = torch.prod(Sd, dim=-1)
        X = allS / Sd[..., d] * (Sd[..., d] * mu[..., d])
        return (torch.einsum("...j, jk, ...k -> ...", c.conj(), X, c).real
                / self.norm(c))

    def project(self, psi: Callable):
        """Least-squares coefficients of a target wavefunction psi(x)
        (``psi`` maps a point (d,) to a scalar in torch ops; it is
        vmapped over a dense grid spanning the basis)."""
        q = self.basis.q.cpu().numpy()
        a = self.basis.a.cpu().numpy()
        lo = q.min(0) - 4 / np.sqrt(a.min(0))
        hi = q.max(0) + 4 / np.sqrt(a.min(0))
        grids = [np.linspace(l, h, 160) for l, h in zip(lo, hi)]
        mesh = np.meshgrid(*grids, indexing="ij")
        x = torch.as_tensor(np.stack([m.ravel() for m in mesh], -1),
                            device=self.device)
        dv = float(np.prod([g[1] - g[0] for g in grids]))
        G = self.basis.evaluate(x)                    # (M, N)
        b = G.mH @ torch.func.vmap(psi)(x).to(G.dtype) * dv  # <g_j|psi>
        S = self.overlap()
        eye = torch.eye(S.shape[0], dtype=S.dtype, device=self.device)
        return torch.linalg.solve(S + 1e-12 * eye, b)

    def run(self, c0, dt, nt, nout=1, e_ops=("x",)):
        """Propagate i S dc/dt = H c exactly through the whitened pencil.

        Returns tensors (times, coeffs (nsteps, N), <x_d> (nsteps, d)).
        """
        E, C, X = self._pencil()
        S = self.overlap()
        c0 = as_tensor(c0, device=self.device).to(C.dtype)
        # c0 = C b with b = C^H S c0 (C is S-orthonormal)
        b0 = C.mH @ (S @ c0)
        times = torch.arange(1, nt // nout + 1, dtype=torch.float64,
                             device=self.device) * (dt * nout)
        phases = torch.exp(-1j * E[None, :] * times[:, None])
        cs = (phases * b0[None, :]) @ C.T             # (nsteps, N)
        xs = torch.stack([self.position(cs, d)
                          for d in range(self.basis.ndim)], dim=-1)
        return times, cs, xs


# 2D alias for reference parity (pyqed/ldr/gwp.py:562 WPD2)
WPD2 = WPDN


# ===================================================================
# Variational thawed Gaussian (Heller) dynamics
# ===================================================================

class ThawedGaussian:
    """Single thawed Gaussian wavepacket evolved by Heller's TDVP
    equations in d dimensions,

        psi(x) = exp(i [ (x-q)^T A (x-q) + p.(x-q) + gamma ]),

    with q' = p/m,  p' = -grad V,  A' = -2 A M^{-1} A - Hess V / 2,
    gamma' = p.M^{-1}p/2 - V + i tr(M^{-1} A)  (hbar = 1, Im A > 0).

    The local harmonic approximation takes the value, gradient and
    Hessian of ``potential`` (a callable of a (d,) float64 tensor, in
    torch ops) from one ``torch.func.jacrev`` of
    ``torch.func.grad_and_value`` (fewer operations per call than
    ``torch.func.hessian`` and ``grad`` called apart). The state lives on ``device`` (the card when
    None); run() steps as one CUDA graph on the card and never reads the
    host inside the loop.
    """

    def __init__(self, potential: Callable, mass=1.0, ndim: int = 1,
                 device=None):
        self.device = resolve_device(device)
        self.V = lambda x: torch.sum(potential(x))
        grad_and_v = torch.func.grad_and_value(self.V)

        def grad_twice(x):
            g, v = grad_and_v(x)
            return g, (g, v)

        # (Hess V, (grad V, V)) in one pass
        self._derivs = torch.func.jacrev(grad_twice, has_aux=True)
        self.ndim = ndim
        self.minv = 1.0 / torch.as_tensor(
            np.broadcast_to(np.asarray(mass, float), (ndim,)).copy(),
            device=self.device)

    def grad(self, x):
        return self._derivs(x)[1][0]

    def hess(self, x):
        return self._derivs(x)[0]

    def _rhs(self, q, p, A, gamma):
        Minv = torch.diag(self.minv).to(A.dtype)
        hess, (grad, v) = self._derivs(q)
        dq = self.minv * p
        dp = -grad
        dA = -2.0 * A @ Minv @ A - 0.5 * hess
        dg = (0.5 * torch.sum(self.minv * p ** 2) - v
              + 1j * torch.trace(Minv @ A))
        return dq, dp, dA, dg

    def _step(self, state, dt):
        q, p, A, g = state
        k1 = self._rhs(q, p, A, g)
        k2 = self._rhs(*(s + dt / 2 * k for s, k in zip(state, k1)))
        k3 = self._rhs(*(s + dt / 2 * k for s, k in zip(state, k2)))
        k4 = self._rhs(*(s + dt * k for s, k in zip(state, k3)))
        return tuple(s + dt / 6 * (a + 2 * b + 2 * c + d)
                     for s, a, b, c, d in zip(state, k1, k2, k3, k4))

    def run(self, q0, p0=None, a0=1.0, dt=0.01, nt=100, nout=1,
            graph=True):
        """RK4-propagate the Heller parameters.

        a0 : initial width, A(0) = i a0 / 2 (coherent for a0 = m w).
        Returns tensors (times, qs, ps, As, gammas, norms), one row per
        window of ``nout`` steps. ``graph`` (on the card): capture the
        step as a CUDA graph.
        """
        from ..core.dynamics import cuda_graph_stepper
        d = self.ndim
        dev = self.device
        q = torch.atleast_1d(torch.as_tensor(np.asarray(q0, float),
                                             device=dev))
        p = (torch.zeros(d, dtype=torch.float64, device=dev) if p0 is None
             else torch.atleast_1d(torch.as_tensor(np.asarray(p0, float),
                                                   device=dev)))
        a0 = np.asarray(a0, complex)
        A = torch.as_tensor(0.5j * (a0 * np.eye(d) if a0.ndim == 0 else a0),
                            device=dev)
        gamma = torch.zeros((), dtype=torch.complex128, device=dev)
        advance = cuda_graph_stepper(lambda s: self._step(s, dt),
                                     (q, p, A, gamma), graph=graph)
        nwin = nt // nout
        rows = [torch.empty((nwin,) + tuple(x.shape), dtype=x.dtype,
                            device=dev) for x in (q, p, A, gamma)]
        for w in range(nwin):
            for _ in range(nout):
                state = advance()
            for r, x in zip(rows, state):
                r[w] = x
        qs, ps, As, gs = rows
        times = torch.arange(1, nwin + 1, dtype=torch.float64,
                             device=dev) * dt * nout
        # |psi|^2 integrates to pi^{d/2} det(2 Im A)^{-1/2} exp(-2 Im gamma)
        norms = (math.pi ** (d / 2)
                 / torch.sqrt(torch.linalg.det(2 * As.imag))
                 * torch.exp(-2 * gs.imag))
        return times, qs, ps, As, gs, norms

    def wavefunction(self, x, q, p, A, gamma):
        x = as_tensor(x, device=self.device)
        dx = torch.atleast_2d(x) - q[None, :]
        dxc = dx.to(A.dtype)
        ph = (torch.einsum("ni, ij, nj -> n", dxc, A, dxc)
              + dxc @ p.to(A.dtype) + gamma)
        return torch.exp(1j * ph)

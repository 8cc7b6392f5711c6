r"""Equilibrium Keldysh-contour Green functions: retarded, lesser,
Matsubara and left-mixing (tv) components, plus a general high-order
Volterra integro-differential solver.

PyTorch counterpart of ``pyqed_tpu/negf/contour.py``. Reference
semantics: pyqed/gw/green.py:806 ``green_equilibrium`` (the four contour
components from a density of states; Python double loops there, one
vectorized frequency quadrature here), green.py:118 ``NEGF`` (the
component container), green.py:2133 ``volterra_intdiff`` (a
half-transcribed C++ routine with undefined symbols; implemented here as
an implicit trapezoid marcher). The equilibrium components are host
NumPy quadratures, as in the JAX package; the marcher runs on the
device.

Conventions (hbar = 1, x = omega - mu, xi = -1 fermions / +1 bosons,
f_xi(x) = 1/(e^{beta x} - xi)):

    G^R(t)      = -i theta(t) \int dw A(w) e^{-i w t}
    G^<(t, t')  = -xi i \int dw A(w) f_xi(w-mu) e^{-i w (t-t')}
    G^M(tau)    = -\int dw A(w) e^{-(w-mu) tau} f_xi(-(w-mu)),  tau in (0, beta)
    G^rc(t,tau) = -xi i \int dw A(w) e^{-i w t} e^{(w-mu) tau} f_xi(w-mu)

Internal identities used as tests: the Matsubara sum rule
G^M(0+) + G^M(beta-) = -1 (fermions), the KMS boundary
G^rc(0, tau) = i xi G^M(beta - tau), and occupation
n = -xi (-i) G^<(t,t) = \int A f.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import resolve_device


def distribution_eq(x, beta, sign=-1):
    """f_xi(x) = 1/(e^{beta x} - xi) with xi = sign (-1 fermion,
    +1 boson), evaluated overflow-safely."""
    x = np.asarray(x, dtype=float)
    if sign == -1:
        # fermi: stable logistic
        return 0.5 * (1.0 - np.tanh(0.5 * beta * x))
    out = np.empty_like(x)
    pos = beta * x > 1e-12
    out[pos] = 1.0 / np.expm1(beta * x[pos])
    out[~pos] = np.inf
    return out


class ContourGF:
    """Two-branch + imaginary-branch Green-function container
    (reference: pyqed/gw/green.py:118 ``NEGF``): components

    - ``ret`` (nt+1, nt+1, n, n): G^R(t_i, t_j), lower triangular;
    - ``les`` (nt+1, nt+1, n, n): G^<(t_i, t_j), stored for i <= j
      (the upper triangle; the reference's storage convention), the
      rest from G^<(t,t') = -G^<(t',t)^dagger;
    - ``tv``  (nt+1, ntau+1, n, n): left-mixing G^rceil(t_i, tau_m);
    - ``mat`` (ntau+1, n, n): Matsubara G^M(tau_m), real.
    """

    def __init__(self, nt, ntau, size=1, beta=None, dt=None):
        self.nt = nt
        self.ntau = ntau
        self.size = size
        self.beta = beta
        self.dt = dt
        self.dtau = (beta / ntau) if beta is not None else None
        n = size
        self.ret = np.zeros((nt + 1, nt + 1, n, n), dtype=complex)
        self.les = np.zeros((nt + 1, nt + 1, n, n), dtype=complex)
        self.tv = np.zeros((nt + 1, ntau + 1, n, n), dtype=complex)
        self.mat = np.zeros((ntau + 1, n, n), dtype=float)

    # element accessors in the reference's style -----------------
    def get_ret(self, i, j):
        return self.ret[i, j]

    def get_adv(self, i, j):
        return np.conj(self.ret[j, i].T)

    def get_les(self, i, j):
        if i <= j:
            return self.les[i, j]
        return -np.conj(self.les[j, i].T)

    def get_gtr(self, i, j):
        return self.get_ret(i, j) - self.get_adv(i, j) + self.get_les(i, j)

    def get_tv(self, n, m):
        return self.tv[n, m]

    def get_mat(self, m):
        return self.mat[m]

    # observables -------------------------------------------------
    def occupation(self, i=0):
        r"""n_a(t_i) = -i xi ... for fermions: n = Im diag G^<(t,t)."""
        return np.real(np.diagonal(-1j * self.get_les(i, i)))

    def spectral_function(self, omega, i0=0):
        r"""A(w) = -(1/pi) Im \int dt e^{i w t} G^R(t0 + t, t0) on the
        stored rows (time-translation invariance assumed for
        equilibrium; trapezoid in t)."""
        nt = self.nt
        ts = np.arange(nt + 1 - i0) * self.dt
        g = np.array([self.ret[i0 + k, i0, 0, 0]
                      for k in range(nt + 1 - i0)])
        w = np.asarray(omega, dtype=float)
        ph = np.exp(1j * np.outer(w, ts))
        tr = np.trapezoid(ph * g[None, :], ts, axis=1)
        return -np.imag(tr) / np.pi


class DOS:
    """Density of states on a finite support with a sampler (the
    reference passes dos objects with .sample/.dos)."""

    def __init__(self, fun: Callable, lo: float, hi: float):
        self.fun = fun
        self.lo = lo
        self.hi = hi

    def sample(self, limit):
        return np.linspace(self.lo, self.hi, limit)

    def dos(self, omega):
        return self.fun(np.asarray(omega))


def semicircle_dos(half_bandwidth=2.0):
    """Bethe-lattice semicircular DOS, unit-normalized."""
    D = half_bandwidth

    def fun(w):
        inside = np.abs(w) < D
        return np.where(inside,
                        2.0 / (np.pi * D ** 2)
                        * np.sqrt(np.maximum(D ** 2 - w ** 2, 0.0)),
                        0.0)
    return DOS(fun, -D, D)


def green_equilibrium(dos, beta, dt, nt, ntau, limit=512, mu=0.0,
                      sign=-1):
    r"""Equilibrium contour Green function from a density of states
    (reference: pyqed/gw/green.py:806 — Python loops over (l, i) and
    (m, n) there; here every component is ONE outer-product phase
    matrix against the frequency quadrature).

    Returns a :class:`ContourGF` with all four components filled.
    """
    G = ContourGF(nt, ntau, size=1, beta=beta, dt=dt)
    omega = dos.sample(limit)
    dw = omega[1] - omega[0]
    A = dos.dos(omega)
    x = omega - mu
    f = distribution_eq(x, beta, sign)
    fm = distribution_eq(-x, beta, sign)

    def quad(integrand):
        """trapezoid over omega for a (..., limit) integrand."""
        return np.trapezoid(integrand, dx=dw, axis=-1)

    ts = np.arange(nt + 1) * dt
    taus = np.arange(ntau + 1) * G.dtau
    ph_t = np.exp(-1j * np.outer(ts, omega))          # (nt+1, limit)

    # retarded: G^R(t_i, t_j) = r(t_i - t_j), lower triangle
    r_of_dt = -1j * quad(ph_t * A[None, :])           # (nt+1,)
    ii, jj = np.meshgrid(np.arange(nt + 1), np.arange(nt + 1),
                         indexing="ij")
    lower = ii >= jj
    G.ret[..., 0, 0] = np.where(lower, r_of_dt[np.abs(ii - jj)], 0.0)

    # lesser: G^<(t_i, t_j) = -xi i \int A f e^{-i w (t_i - t_j)};
    # stored upper triangle (i <= j), where t_i - t_j = -(j-i) dt
    l_of_dt = -sign * 1j * quad(np.conj(ph_t) * (A * f)[None, :])
    G.les[..., 0, 0] = np.where(ii <= jj, l_of_dt[np.abs(jj - ii)], 0.0)

    # left-mixing (tv): -xi i \int A e^{-i w t} e^{x tau} f(x)
    # (e^{x tau} f(x) is overflow-safe: for x>0 it's ~e^{-x(beta-tau)})
    exf = np.exp(np.minimum(np.outer(taus, x), 700.0)) * f[None, :]
    wts = np.full(omega.shape, dw)
    wts[0] = wts[-1] = dw / 2.0
    G.tv[..., 0, 0] = (-sign * 1j) * np.einsum(
        "tw, mw, w -> tm", ph_t * A[None, :], exf, wts)

    # Matsubara: G^M(tau) = -\int A e^{-x tau} f(-x)
    emf = np.exp(np.maximum(np.outer(-taus, x), -700.0)) * fm[None, :]
    G.mat[..., 0, 0] = -quad(emf * A[None, :])
    return G


def green_equilibrium_H(H, beta, dt, nt, ntau, mu=0.0, sign=-1):
    """Equilibrium contour GF of a quadratic Hamiltonian H (n x n) via
    its spectral decomposition — the matrix-valued analogue of
    :func:`green_equilibrium` (the reference's commented-out
    ``green_from_H``, green.py:900)."""
    H = np.asarray(H)
    n = H.shape[-1]
    w, v = np.linalg.eigh(H)
    x = w - mu
    f = distribution_eq(x, beta, sign)
    fm = distribution_eq(-x, beta, sign)
    G = ContourGF(nt, ntau, size=n, beta=beta, dt=dt)
    ts = np.arange(nt + 1) * dt
    taus = np.arange(ntau + 1) * G.dtau
    ph = np.exp(-1j * np.outer(ts, w))                   # (nt+1, n)

    def dress(diag):  # (..., n) eigenvalue factors -> (..., n, n)
        return np.einsum("ak, ...k, bk -> ...ab", v, diag, np.conj(v))

    r = dress(-1j * ph)
    l = dress(-sign * 1j * np.conj(ph) * f[None, :])
    ii, jj = np.meshgrid(np.arange(nt + 1), np.arange(nt + 1),
                         indexing="ij")
    G.ret = np.where((ii >= jj)[..., None, None],
                     r[np.abs(ii - jj)], 0.0)
    G.les = np.where((ii <= jj)[..., None, None],
                     l[np.abs(jj - ii)], 0.0)
    exf = np.exp(np.minimum(np.outer(taus, x), 700.0)) * f[None, :]
    G.tv = np.einsum("tk, mk, ak, bk -> tmab",
                     -sign * 1j * ph, exf, v, np.conj(v))
    emf = np.exp(np.maximum(np.outer(-taus, x), -700.0)) * fm[None, :]
    G.mat = np.real(np.einsum("mk, ak, bk -> mab", -emf, v, np.conj(v)))
    return G


# =====================================================================
# Volterra integro-differential marcher
# =====================================================================

def volterra_intdiff(q, K, y0, dt, nt, f=None, corrector_iters=2,
                     device=None):
    r"""Solve the Volterra integro-differential equation

        dy/dt = q(t) y(t) + \int_0^t K(t, s) y(s) ds + f(t)

    for a matrix-valued y (n, n) on t_k = k dt, k = 0..nt — the kernel
    form of every Kadanoff-Baym component equation (reference:
    pyqed/gw/green.py:2133 ``volterra_intdiff``, a non-functional C++
    transcription; this is the working equivalent: implicit trapezoid
    with fixed-point correctors on the full memory integral). Runs on
    ``K``'s device when it is a tensor, else on ``device`` (the card when
    None).

    q: (nt+1, n, n); K: (nt+1, nt+1, n, n) (only s <= t used);
    f: optional (nt+1, n, n); y0: (n, n). Returns y (nt+1, n, n).
    """
    dev = K.device if (device is None and isinstance(K, torch.Tensor)) \
        else resolve_device(device)

    def c(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=dev).to(torch.complex128)

    q, K = c(q), c(K)
    n = q.shape[-1]
    fs = torch.zeros_like(q) if f is None else c(f)
    idx = torch.arange(nt + 1, device=dev)

    def mem(y, row, upto):
        r"""trapezoid \int_0^{t_upto} K(row, s) y(s) ds."""
        w = (idx <= upto).to(torch.float64) * dt
        w[0] = dt / 2
        w = torch.where(idx == upto, dt / 2, w).to(torch.complex128)
        return torch.einsum("l, lab, lbc -> ac", w, K[row], y)

    y = torch.zeros((nt + 1, n, n), dtype=torch.complex128, device=dev)
    y[0] = c(y0)
    for k in range(1, nt + 1):
        yk1 = y[k - 1]
        d_prev = q[k - 1] @ yk1 + mem(y, k - 1, k - 1) + fs[k - 1]
        # predictor: explicit Euler for the unknown endpoint
        y_new = yk1 + dt * d_prev
        for _ in range(corrector_iters):
            y[k] = y_new
            d_new = q[k] @ y_new + mem(y, k, k) + fs[k]
            y_new = yk1 + 0.5 * dt * (d_prev + d_new)
        y[k] = y_new
    return y

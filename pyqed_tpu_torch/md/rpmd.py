"""Ring-polymer molecular dynamics (RPMD).

Counterpart of ``pyqed_tpu/md/rpmd.py`` [Craig & Manolopoulos, JCP 121,
3368 (2004)]: classical dynamics of the imaginary-time ring polymer, n
beads coupled by springs at omega_n = n / (beta hbar), approximates
Kubo-transformed quantum time-correlation functions.

The trajectory ensemble is one ``(ntraj, n, ndim)`` tensor: the bead axis
goes to normal modes through the orthogonal transform C (one batched
product each way), the free ring polymer advances exactly in normal modes
(symmetric splitting e^{L_V dt/2} e^{L_0 dt} e^{L_V dt/2}), and the
optional PILE-L thermostat [Ceriotti et al., JCP 133, 124104 (2010)]
takes its normal draws as arguments. The JAX package vmaps a scan over
trajectories; here the trajectory axis is explicit, and one output window
of ``nout`` steps (or one thermostatted step) is a CUDA graph on the card
(:class:`~pyqed_tpu_torch.core.dynamics.GraphScan`).

Draws come from a ``torch.Generator`` on the solver's device seeded by
the integer ``key``, or are given as arguments (``draws=``), so the JAX
package's own draws can be fed in. ``potential`` and ``dV`` take one bead
``(ndim,)`` in torch operations; ``dV`` defaults to ``torch.func.grad``
of the potential, batched by ``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..core.dynamics import GraphScan
from ..core.result import Result

__all__ = ["RPMD", "kubo_harmonic_xx"]

BLOCK = 250        # thermostatted steps whose draws are made at once


def normal_mode_matrix(n):
    """Orthogonal bead -> normal-mode transform C (n, n), and the free
    ring-polymer normal-mode frequencies omega_k = 2 omega_n sin(k pi/n)
    in units of omega_n = n/(beta hbar) (returned as sin factors)."""
    C = np.zeros((n, n))
    j = np.arange(n)
    C[0] = 1.0 / np.sqrt(n)
    for k in range(1, n // 2 + 1):
        if 2 * k == n:
            C[k] = (-1.0) ** j / np.sqrt(n)
        else:
            C[k] = np.sqrt(2.0 / n) * np.cos(2 * np.pi * j * k / n)
    for k in range(n // 2 + 1, n):
        C[k] = np.sqrt(2.0 / n) * np.sin(2 * np.pi * j * (n - k) / n)
    sin_fac = 2.0 * np.abs(np.sin(np.pi * np.minimum(np.arange(n),
                                                     n - np.arange(n)) / n))
    return C, sin_fac


def kubo_harmonic_xx(t, omega, beta, mass=1.0):
    """Exact Kubo-transformed position autocorrelation of the harmonic
    oscillator, C_xx(t) = cos(omega t) / (beta m omega^2)."""
    t = np.asarray(t)
    return np.cos(omega * t) / (beta * mass * omega ** 2)


class RPMD:
    """Ring-polymer MD on a (possibly multidimensional) potential.

    Parameters
    ----------
    potential : callable x (ndim,) -> scalar V (per bead), torch ops.
    dV : callable x -> (ndim,) gradient; default torch.func.grad.
    mass : scalar or (ndim,).
    beta : inverse temperature (atomic units, hbar = 1).
    nbeads : number of ring-polymer beads.
    device : where the ensemble lives (the card when None).
    """

    def __init__(self, potential: Callable, beta: float, nbeads: int = 32,
                 dV: Optional[Callable] = None, mass=1.0, ndim: int = 1,
                 device=None):
        self.device = resolve_device(device)
        self.potential = potential
        self.dV = dV if dV is not None else torch.func.grad(potential)
        self._V = torch.func.vmap(potential)
        self._dV = torch.func.vmap(self.dV)
        self.mass = torch.atleast_1d(torch.as_tensor(
            mass, dtype=torch.float64, device=self.device))
        self.beta = float(beta)
        self.n = int(nbeads)
        self.ndim = ndim
        self.beta_n = self.beta / self.n
        self.omega_n = 1.0 / self.beta_n                  # n/(beta hbar)
        C, sin_fac = normal_mode_matrix(self.n)
        self.C = torch.as_tensor(C, device=self.device)
        self.omega_k = torch.as_tensor(sin_fac, device=self.device) \
            * self.omega_n

    def _t(self, a):
        return torch.as_tensor(np.array(a, dtype=np.float64),
                               device=self.device) \
            if not isinstance(a, torch.Tensor) else a.to(self.device)

    # ------------------------------------------------------------- pieces
    def _forces(self, x):
        """External force -dV per bead; x (..., n, ndim)."""
        return -self._dV(x.reshape(-1, x.shape[-1])).reshape(x.shape)

    def _free_rp(self, x, p, dt):
        """Exact free ring-polymer evolution in normal modes (x, p of
        shape (..., n, ndim))."""
        X = self.C @ x
        P = self.C @ p
        w = self.omega_k[:, None]
        m = self.mass[None, :]
        c, s = torch.cos(w * dt), torch.sin(w * dt)
        # w=0 centroid mode: x += p dt / m (limit of s/w)
        sw = torch.where(w > 0, s / torch.where(w > 0, w, 1.0), dt)
        X_new = c * X + sw * P / m
        P_new = c * P - m * w * s * X
        return self.C.T @ X_new, self.C.T @ P_new

    def _pile(self, p, xi, dt, tau0=None):
        """PILE-L thermostat: Ornstein-Uhlenbeck update of the normal-mode
        momenta on the standard normals ``xi`` (the shape of ``p``)."""
        gamma = 2.0 * self.omega_k
        g0 = 1.0 / float(tau0) if tau0 else self.omega_n / self.n
        gamma = torch.cat([torch.full_like(gamma[:1], g0), gamma[1:]])
        c1 = torch.exp(-0.5 * dt * gamma)[:, None]
        m = self.mass[None, :]
        sig = torch.sqrt((1.0 - c1 ** 2) * m / self.beta_n)
        P = self.C @ p
        return self.C.T @ (c1 * P + sig * xi)

    def _step(self, x, p, dt):
        """Velocity Verlet with the exact free-RP core (symplectic)."""
        p = p + 0.5 * dt * self._forces(x)
        x, p = self._free_rp(x, p, dt)
        p = p + 0.5 * dt * self._forces(x)
        return x, p

    def energy(self, x, p):
        """Conserved ring-polymer Hamiltonian per polymer (x, p of shape
        (..., n, ndim))."""
        m = self.mass[None, :]
        ke = torch.sum(p ** 2 / (2.0 * m), dim=(-2, -1))
        spring = 0.5 * torch.sum(m * self.omega_n ** 2
                                 * (x - torch.roll(x, 1, dims=-2)) ** 2,
                                 dim=(-2, -1))
        pot = torch.sum(self._V(x.reshape(-1, x.shape[-1])).reshape(
            x.shape[:-1]), dim=-1)
        return ke + spring + pot

    # ------------------------------------------------------- thermal init
    def _draw_pair(self, key, ntraj, draws):
        if draws is not None:
            return tuple(self._t(d) for d in draws)
        gen = torch.Generator(device=self.device).manual_seed(int(key))
        shape = (ntraj, self.n, self.ndim)
        return tuple(torch.randn(shape, generator=gen, device=self.device,
                                 dtype=torch.float64) for _ in range(2))

    def sample_free(self, key, ntraj, x_center=0.0, draws=None):
        """Exact thermal sample of the FREE ring polymer (normal-mode
        Gaussians; centroid pinned at x_center) and Maxwell momenta;
        ``draws`` the two (ntraj, n, ndim) standard normals (positions,
        momenta), else drawn from ``key``."""
        zx, zp = self._draw_pair(key, ntraj, draws)
        m = self.mass[None, None, :]
        w = self.omega_k[None, :, None]
        sig_x = torch.where(w > 0, 1.0 / torch.sqrt(
            self.beta_n * m * torch.where(w > 0, w, 1.0) ** 2), 0.0)
        X = sig_x * zx
        X[:, 0, :] = float(np.sqrt(float(self.n))) * x_center
        P = torch.sqrt(m / self.beta_n) * zp
        CT = self.C.T
        return (torch.einsum("ij, tjd -> tid", CT, X),
                torch.einsum("ij, tjd -> tid", CT, P))

    def sample_harmonic(self, key, ntraj, omega, x_center=0.0, draws=None):
        """EXACT thermal sample of the ring polymer in a harmonic well
        V = m omega^2 x^2 / 2 (every normal mode Gaussian with frequency
        sqrt(omega_k^2 + omega^2)); ``draws`` as in :meth:`sample_free`."""
        zx, zp = self._draw_pair(key, ntraj, draws)
        m = self.mass[None, None, :]
        w2 = self.omega_k[None, :, None] ** 2 + omega ** 2
        sig_x = 1.0 / torch.sqrt(self.beta_n * m * w2)
        X = sig_x * zx
        X[:, 0, :] += float(np.sqrt(float(self.n))) * x_center
        P = torch.sqrt(m / self.beta_n) * zp
        CT = self.C.T
        return (torch.einsum("ij, tjd -> tid", CT, X),
                torch.einsum("ij, tjd -> tid", CT, P))

    # ------------------------------------------------------------ run/tcf
    def thermalize(self, x0, p0, key, dt=0.05, nsteps=2000, tau0=None,
                   draws=None):
        """PILE-thermostatted (T-RPMD) propagation to the canonical
        ring-polymer distribution; x0/p0 (ntraj, n, ndim). ``draws``
        (nsteps, 2, ntraj, n, ndim) standard normals, the thermostat's
        before and after each step, else drawn from ``key`` a block at a
        time. Returns (x, p)."""
        x, p = self._t(x0), self._t(p0)

        def step(carry, xi):
            x, p = carry
            p = self._pile(p, xi[0], dt, tau0)
            x, p = self._step(x, p, dt)
            p = self._pile(p, xi[1], dt, tau0)
            return (x, p), ()

        if draws is not None:
            (x, p), _ = GraphScan(step)((x, p), self._t(draws))
            return x.clone(), p.clone()
        gen = torch.Generator(device=self.device).manual_seed(int(key))
        shape = (2,) + tuple(x.shape)
        (x, p), _ = GraphScan(step).blocks(
            (x, p), nsteps, BLOCK, lambda _, m: (torch.randn(
                (m,) + shape, generator=gen, device=self.device,
                dtype=torch.float64),))
        return x.clone(), p.clone()

    def run(self, x0, p0, dt=0.05, nt=1000, nout=1) -> Result:
        """Microcanonical (NVE) ring-polymer dynamics of an ensemble;
        x0/p0 (ntraj, n, ndim). Result: .x/.p (nsnap, ntraj, n, ndim),
        .centroid (nsnap, ntraj, ndim), .energy (nsnap, ntraj), tensors on
        the solver's device."""
        x, p = self._t(x0), self._t(p0)
        ns_steps = nt // nout

        def window(carry):
            x, p = carry
            for _ in range(nout):
                x, p = self._step(x, p, dt)
            return (x, p), (x, p, torch.mean(x, dim=1), self.energy(x, p))

        _, out = GraphScan(window)((x, p), length=ns_steps)
        xs, ps, cen, es = out if out is not None else (None,) * 4
        r = Result(dt=dt, nt=nt, nout=nout)
        r.times = np.arange(1, ns_steps + 1) * dt * nout
        r.x, r.p = xs, ps
        r.centroid = cen
        r.energy = es
        return r

    def position_tcf(self, x0, p0, dt=0.05, nt=1000, nout=1):
        """RPMD (Kubo-transformed) position autocorrelation
        C_xx(t) = <xbar(0) . xbar(t)> over the ensemble; returns
        (times, C) with the t=0 point, C[0] = <|xbar(0)|^2> (NumPy)."""
        x0, p0 = self._t(x0), self._t(p0)
        res = self.run(x0, p0, dt=dt, nt=nt, nout=nout)
        cen0 = torch.mean(x0, dim=1)                     # (ntraj, ndim)
        cen = torch.cat([cen0[None], res.centroid], dim=0)
        C = torch.mean(torch.sum(cen0[None] * cen, dim=-1), dim=1)
        t = np.concatenate([[0.0], np.asarray(res.times)])
        return t, C.cpu().numpy()

"""Keldysh-contour nonequilibrium Green's functions.

PyTorch counterpart of ``pyqed_tpu/negf/keldysh.py`` (reference:
pyqed/gw/green.py — ``NEGF:118`` (ret/les/left-mixing/Matsubara
components on two-time grids), ``green_from_H_const:1043``,
``green_from_H:1143``, self-energies ``hartree:1242``/``fock:1261``/
``bubble:1432``, ``KBSolver:2053`` with ``volterra_intdiff:2133``).

All two-time components live as (nt+1, nt+1, n, n) tensors on the
device; free propagators are built from one ``eigh`` and outer phase
products (no time loop); collision integrals are contractions over the
time axis with trapezoid weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import dag  # noqa: F401  (the reference module's helper)

C128 = torch.complex128


def _tensor(x, device=None, dtype=None):
    """``x`` as a tensor: on its own device when it is one, else on
    ``device`` (the card when None)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device),
                           dtype=dtype)


def _real(x):
    """A tensor as it is; NumPy or Python input as a float64 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=float))


def fermi(beta, omega, mu=0.0):
    """Fermi function 1/(e^{beta (omega - mu)} + 1), on ``omega``'s device
    (the CPU for NumPy or Python input)."""
    return 1.0 / (torch.exp(beta * (_real(omega) - mu)) + 1.0)


def bose(beta, omega):
    """Bose function 1/(e^{beta omega} - 1)."""
    return 1.0 / (torch.exp(beta * _real(omega)) - 1.0)


def _swapT(X):
    """X(t', t) with the matrix transposed: time swap + orbital
    transpose."""
    return X.transpose(0, 1).transpose(-1, -2)


class NEGF:
    """Two-time contour Green's function container on ``device`` (the card
    when None) (reference: pyqed/gw/green.py:118)."""

    def __init__(self, nt, ntau=1, size=1, sign=-1, dt=None, beta=1e6,
                 device=None):
        self.device = resolve_device(device)
        self.nt = nt
        self.ntau = ntau
        self.size = size
        self.sign = sign           # -1 fermion, +1 boson
        self.beta = beta
        self.dt = dt
        self.dtau = beta / ntau

        def zeros(*shape):
            return torch.zeros(shape, dtype=C128, device=self.device)

        self.retarded = zeros(nt + 1, nt + 1, size, size)
        self.lesser = zeros(nt + 1, nt + 1, size, size)
        self.left_mixing = zeros(nt + 1, ntau + 1, size, size)
        self.matsubara = zeros(ntau + 1, size, size)

    def get_ret(self, n, m):
        return self.retarded[n, m]

    def get_les(self, n, m):
        return self.lesser[n, m]

    def get_gtr(self, n, m):
        """G> = G^R - G^A + G< (reference: pyqed/gw/green.py:199)."""
        GA = self.retarded[m, n].transpose(-1, -2).conj()
        return self.retarded[n, m] - GA + self.lesser[n, m]

    def rho(self, n):
        """Single-time density matrix rho_ij(t) = -i G<_ji(t, t) for
        fermions (sign=-1)."""
        return -1j * self.lesser[n, n].transpose(-1, -2)

    def spectral(self, omega, t_avg=None):
        """A(w) from the retarded component by FT over relative time (the
        t' = 0 column G^R(t, 0), trapezoid)."""
        nt, dt = self.nt, self.dt
        Gt = self.retarded[:, 0]                           # (nt+1, n, n)
        ts = torch.arange(nt + 1, dtype=torch.float64,
                          device=self.device) * dt
        omega = _tensor(omega, self.device, torch.float64)
        phases = torch.exp(1j * omega[:, None] * ts[None, :])
        wgt = torch.ones(nt + 1, dtype=torch.float64, device=self.device)
        wgt[0] = wgt[-1] = 0.5
        GR_w = torch.einsum("wt, t, tij -> wij", phases, wgt.to(C128),
                            Gt) * dt
        return -torch.imag(torch.diagonal(GR_w, dim1=-2, dim2=-1)
                           .sum(-1)) / np.pi


def green_from_H_const(H0, beta, nt, ntau, dt, sign=-1, mu=0.0,
                       device=None):
    """Equilibrium contour GF of a constant quadratic Hamiltonian
    (reference: pyqed/gw/green.py:1043), built without time loops on
    ``H0``'s device (or ``device``):

    G^R(t,t') = -i theta(t-t') e^{-iH(t-t')}
    G^<(t,t') = ∓i f(±(H-mu)) e^{-iH t} e^{+iH t'}  (upper: fermions)
    """
    H0 = _tensor(H0, device)
    dev = H0.device
    n = H0.shape[0]
    G = NEGF(nt, ntau=ntau, size=n, sign=sign, dt=dt, beta=beta, device=dev)
    w, V = torch.linalg.eigh(H0.to(C128) if H0.is_complex()
                             else H0.to(torch.float64))
    V = V.to(C128)
    ts = torch.arange(nt + 1, dtype=torch.float64, device=dev) * dt
    phase = torch.exp(-1j * w[None, :] * ts[:, None])      # (nt+1, n)
    U = torch.einsum("an, tn, bn -> tab", V, phase, V.conj())  # e^{-iHt}
    theta = (ts[:, None] - ts[None, :] >= 0).to(C128)
    GR = -1j * theta[:, :, None, None] * torch.einsum(
        "tab, scb -> tsac", U, U.conj())
    occ = fermi(beta, w, mu) if sign == -1 else bose(beta, w - mu)
    # G^<(t,t') = ±i V f e^{-iw t} e^{+i w t'} V^dag
    GL = (1j if sign == -1 else -1j) * torch.einsum(
        "an, tn, sn, bn -> tsab", V, phase * occ[None, :], phase.conj(),
        V.conj())
    G.retarded = GR
    G.lesser = GL
    # Matsubara G^M(tau) = -<T_tau c(tau) c^dag> = -e^{-w tau}(1-f), tau>0
    taus = torch.arange(ntau + 1, dtype=torch.float64, device=dev) \
        * beta / ntau
    gm = -torch.exp(-w[None, :] * taus[:, None]) * (
        (1 - occ) if sign == -1 else (1 + occ))[None, :]
    G.matsubara = torch.einsum("an, tn, bn -> tab", V, gm.to(C128), V.conj())
    return G


green_from_H = green_from_H_const


# ------------------------------------------------------------ self-energies

def hartree(G: NEGF, v):
    """Sigma_H_i(t) = sum_j v_ij n_j(t) for a local density-density
    interaction v_ij (reference: pyqed/gw/green.py:1242)."""
    v = _tensor(v, G.device)
    k = torch.arange(G.nt + 1, device=G.device)
    dens = torch.real(-1j * torch.diagonal(G.lesser[k, k], dim1=-2,
                                           dim2=-1))        # (nt+1, n)
    return torch.einsum("ij, tj -> ti", v.to(dens.dtype), dens)


def fock_exchange(G: NEGF, v):
    """Sigma_F_ij(t) = i v_ij G^<_ij(t, t) (local-orbital exchange)
    (reference: pyqed/gw/green.py:1261)."""
    v = _tensor(v, G.device)
    k = torch.arange(G.nt + 1, device=G.device)
    return 1j * v[None, :, :] * G.lesser[k, k]


def second_born(G: NEGF, U):
    """Local second-Born self-energy for a Hubbard-like interaction U
    (the 'bubble' diagram, reference: pyqed/gw/green.py:1432):

    Sigma^{≷}_ij(t,t') = U^2 G^{≷}_ij G^{≷}_ij G^{≶}_ji   (per orbital pair)
    Returns (Sigma_ret, Sigma_les) on the full two-time grid.
    """
    GL = G.lesser
    GA = _swapT(G.retarded).conj()
    GG = G.retarded - GA + GL
    Sig_g = U ** 2 * GG * GG * _swapT(GL)
    Sig_l = U ** 2 * GL * GL * _swapT(GG)
    ts = torch.arange(G.nt + 1, device=GL.device)
    theta = (ts[:, None] >= ts[None, :]).to(GL.dtype)
    return theta[:, :, None, None] * (Sig_g - Sig_l), Sig_l


class KBSolver:
    """Kadanoff-Baym two-time propagation with self-consistent collision
    integrals (reference: pyqed/gw/green.py:2053 with the Volterra
    integro-differential core :2133).

    Fixed-point variant: iterate G = G0 + G0 (Sigma[G]) G (Dyson,
    trapezoid contour convolution) on the real-time branch, on ``H0``'s
    device (or ``device``).
    """

    def __init__(self, H0, v=None, U=0.0, beta=10.0, nt=40, dt=0.05,
                 sign=-1, mu=0.0, device=None):
        self.H0 = _tensor(H0, device)
        self.U = U
        self.v = v
        self.beta = beta
        self.nt = nt
        self.dt = dt
        self.sign = sign
        self.mu = mu

    def run(self, max_iter=20, tol=1e-8):
        G0 = green_from_H_const(self.H0, self.beta, self.nt, 1, self.dt,
                                sign=self.sign, mu=self.mu)
        if self.U == 0.0:
            return G0
        dev = self.H0.device
        n = self.H0.shape[0]
        nt, dt = self.nt, self.dt
        W = torch.ones(nt + 1, dtype=C128, device=dev) * dt
        W[0] = W[-1] = 0.5 * dt
        GR0, GL0 = G0.retarded, G0.lesser
        GR, GL = GR0, GL0

        def conv(A, B):
            # (A * B)(t, t') = int ds A(t, s) B(s, t')
            return torch.einsum("tuab, u, usbc -> tsac", A, W, B)

        def new(GR, GL):
            G = NEGF(nt, 1, n, self.sign, dt, self.beta, device=dev)
            G.retarded, G.lesser = GR, GL
            return G

        for _ in range(max_iter):
            Sr, Sl = second_born(new(GR, GL), self.U)
            # Dyson: G^R = G0^R + G0^R Sr G^R
            GR_new = GR0 + conv(conv(GR0, Sr), GR)
            # Keldysh: G^< = G0^< + G0^R Sr G^< + G0^< Sa G^A + G0^R Sl G^A
            GA = _swapT(GR_new).conj()
            Sa = _swapT(Sr).conj()
            GL_new = (GL0 + conv(conv(GR0, Sr), GL)
                      + conv(conv(GL0, Sa), GA)
                      + conv(conv(GR0, Sl), GA))
            err = float(torch.max(torch.abs(GR_new - GR))
                        + torch.max(torch.abs(GL_new - GL)))
            GR = 0.5 * GR + 0.5 * GR_new
            GL = 0.5 * GL + 0.5 * GL_new
            if err < tol:
                break
        return new(GR, GL)


def volterra_int(G0R_col, K, dt):
    """Solve g = g0 + (K * g) on a single time column by forward
    substitution with trapezoid weights (reference:
    pyqed/gw/green.py:1964); the history sum of each row is one
    contraction."""
    G0R_col = torch.as_tensor(G0R_col)
    K = torch.as_tensor(K, device=G0R_col.device)
    nt = G0R_col.shape[0] - 1
    n = G0R_col.shape[-1]
    dtype = torch.promote_types(K.dtype, G0R_col.dtype)
    g = torch.zeros((nt + 1,) + tuple(G0R_col.shape[1:]), dtype=dtype,
                    device=K.device)
    g[0] = G0R_col[0]
    w = torch.full((nt + 1,), dt, dtype=dtype, device=K.device)
    w[0] = 0.5 * dt
    eye = torch.eye(n, dtype=dtype, device=K.device)
    for i in range(1, nt + 1):
        rhs = G0R_col[i] + torch.einsum("j, jab, jb... -> a...", w[:i],
                                        K[i, :i].to(dtype), g[:i])
        g[i] = torch.linalg.solve(eye - 0.5 * dt * K[i, i].to(dtype), rhs)
    return g

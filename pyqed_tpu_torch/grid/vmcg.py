"""Variational moving-basis Gaussian nonadiabatic dynamics (vMCG-style),
PyTorch.

PyTorch counterpart of ``pyqed_tpu/grid/vmcg.py``: complex frozen or
thawed Gaussians whose centres and momenta follow trajectories, with the
electronic-nuclear amplitudes propagated variationally in the
nonorthogonal moving basis,

    i S(t) dC/dt = [ H(t) - i tau(t) ] C,      tau_jk = <g_j | d g_k/dt>.

Every matrix element is a closed form on (N, N[, D]) tensors; the
kinetic and time-derivative couplings are ratios to the overlap. The
potential uses the local harmonic approximation around each pair
centroid, with the value, gradient and Hessian of the user's diabatic
matrix from one ``torch.func.jacfwd`` pass vmapped over the N² centroids.
The amplitude equation is solved through an ``eigh`` of S per
right-hand side, whose info check reads the host on CUDA, so the RK4
loop runs eagerly (no CUDA graph).

Conventions: each basis function (bra index j conjugated) is

    g_j(x) = prod_d (Re alpha_jd / pi)^{1/4}
             exp( -alpha_jd/2 (x_d - q_jd)^2 + i p_jd (x_d - q_jd) )
             * exp(i gamma_j),

with Re alpha > 0 (real alpha: frozen; complex: thawed, by the
per-dimension Heller/LHA Riccati equation d alpha_d/dt =
i (V''_dd - alpha_d^2 / m_d)).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor

__all__ = ["GWPMatrixElements", "VMCG", "gaussian_overlap_with"]


def _pair_core(q, p, alpha, gamma):
    """All pairwise 1D building blocks, batched over (N, N, D): the full
    overlap S (N, N), the complex pair centroid mu, the pair variance
    var = 1/A, the kinetic ratio kinr = <g_j|p_d^2|g_k>/S (no 1/2m) and
    delta = mu - q_k."""
    qj, qk = q[:, None, :], q[None, :, :]
    pj, pk = p[:, None, :], p[None, :, :]
    aj = alpha.conj()[:, None, :]
    ak = alpha[None, :, :]

    A = aj + ak
    B = aj * qj + ak * qk + 1j * (pk - pj)
    C0 = (-0.5 * aj * qj ** 2 - 0.5 * ak * qk ** 2
          + 1j * (pj * qj - pk * qk))
    mu = B / A
    var = 1.0 / A
    s1 = ((aj.real * ak.real) ** 0.25 * torch.sqrt(2.0 / A)
          * torch.exp(0.5 * B ** 2 / A + C0))
    S = torch.prod(s1, dim=-1) * torch.exp(
        1j * (gamma[None, :] - gamma.conj()[:, None]))
    delta = mu - qk
    kinr = (ak - ak ** 2 * (var + delta ** 2)
            + 2j * ak * pk * delta + pk ** 2)
    return {"S": S, "mu": mu, "var": var, "kinr": kinr, "delta": delta}


class GWPMatrixElements:
    """Batched matrix elements over N complex Gaussians: q, p (N, D)
    float64 tensors; alpha (N, D) complex with Re alpha > 0; gamma (N,)
    real (global phases)."""

    @staticmethod
    def overlap(q, p, alpha, gamma):
        return _pair_core(q, p, alpha, gamma)["S"]

    @staticmethod
    def kinetic(q, p, alpha, gamma, minv):
        """<g_j| sum_d p_d^2/(2 m_d) |g_k>, minv = 1/m (D,)."""
        c = _pair_core(q, p, alpha, gamma)
        return c["S"] * torch.sum(0.5 * minv * c["kinr"], dim=-1)

    @staticmethod
    def moment1(q, p, alpha, gamma):
        """<g_j| x_d |g_k> for every d: (N, N, D)."""
        c = _pair_core(q, p, alpha, gamma)
        return c["S"][..., None] * c["mu"]


def gaussian_overlap_with(q, p, alpha, gamma, q0, p0, alpha0):
    """<g_j | g0> for one target Gaussian (q0, p0, alpha0): (N,)."""
    qs = torch.cat([q, q0[None, :]])
    ps = torch.cat([p, p0[None, :]])
    als = torch.cat([alpha, alpha0[None, :]])
    gs = torch.cat([gamma, gamma.new_zeros(1)])
    S = GWPMatrixElements.overlap(qs, ps, als, gs)
    return S[:-1, -1]


class VMCG:
    """Trajectory-guided variational multi-Gaussian nonadiabatic dynamics.

    Parameters
    ----------
    potential : callable x (D,) -> (ns, ns) real symmetric diabatic
        matrix (a scalar when ns == 1), written in torch ops (it is
        differentiated with ``torch.func`` and vmapped).
    mass : float or (D,) array.
    nstates : number of electronic states ns.
    motion : 'ehrenfest' (default): each trajectory moves under
        -Re tr(rho_j grad V), rho_j from its own amplitudes; or an int s:
        all trajectories move on diabatic surface V_ss.
    thawed : evolve per-dimension widths (default False = frozen).
    svd_tol : relative eigenvalue cut of the regularized inverse of S.
    device : the card when None (raises without one).
    """

    def __init__(self, potential: Callable, mass=1.0, nstates: int = 2,
                 ndim: int = 1, motion="ehrenfest", thawed: bool = False,
                 svd_tol: float = 1e-10, device=None):
        self.device = resolve_device(device)
        self.ns = int(nstates)
        self.ndim = int(ndim)
        self.minv = 1.0 / torch.as_tensor(
            np.broadcast_to(np.asarray(mass, float), (self.ndim,)).copy(),
            device=self.device)
        self.motion = motion
        self.thawed = bool(thawed)
        self.svd_tol = float(svd_tol)
        ns = self.ns

        def vmat(x):
            return potential(x).reshape(ns, ns)

        def v_twice(x):
            v = vmat(x)
            return v, v

        grad_and_v = torch.func.jacfwd(v_twice, has_aux=True)

        def grad_twice(x):
            g, v = grad_and_v(x)
            return g, (g, v)

        # one pass: (hessian (ns, ns, D, D), (grad (ns, ns, D), value))
        self._all = torch.func.jacfwd(grad_twice, has_aux=True)

    def _derivatives(self, x):
        """(V, grad V, Hess V) at the points x (P, D)."""
        H, (G, V) = torch.func.vmap(self._all)(x)
        return V, G, H

    # ------------------------------------------------------ components

    def _potential_elements(self, core, derivs):
        """LHA diabatic potential matrix elements (N, ns, N, ns), from the
        derivatives at the pair centroids Re mu (N², ...)."""
        S, mu, var = core["S"], core["mu"], core["var"]
        w = 1j * mu.imag                         # <x - xc> / S
        N = mu.shape[0]
        V0, G, Hs = derivs
        V0 = V0.reshape(N, N, self.ns, self.ns)
        G = G.reshape(N, N, self.ns, self.ns, self.ndim)
        Hs = Hs.reshape(N, N, self.ns, self.ns, self.ndim, self.ndim)
        # second central moments about xc: w_d w_e + delta_de var_d
        eye = torch.eye(self.ndim, dtype=var.dtype, device=var.device)
        m2 = w[..., :, None] * w[..., None, :] + eye * var[..., None]
        val = (V0 + torch.einsum("jkabd, jkd -> jkab", G.to(w.dtype), w)
               + 0.5 * torch.einsum("jkabde, jkde -> jkab",
                                    Hs.to(m2.dtype), m2))
        return (S[:, :, None, None] * val).permute(0, 2, 1, 3)

    def _rho(self, C):
        wsum = torch.sum(C.abs() ** 2, dim=1).clamp_min(1e-30)
        return C[:, :, None] * C.conj()[:, None, :] / wsum[:, None, None]

    def _traj_force(self, C, derivs):
        """Per-trajectory potential and classical force (Ehrenfest or
        fixed-surface), with the Hessians for thawed widths, from the
        derivatives at the centres."""
        V, G, H = derivs
        if isinstance(self.motion, int):
            s = self.motion
            return V[:, s, s], -G[:, s, s], H[:, s, s]
        rho = self._rho(C)
        Vq = torch.einsum("nab, nba -> n", rho, V.to(rho.dtype)).real
        F = -torch.einsum("nab, nbad -> nd", rho, G.to(rho.dtype)).real
        Hq = torch.einsum("nab, nbade -> nde", rho, H.to(rho.dtype)).real
        return Vq, F, Hq

    def _reg_solve(self, S, rhs):
        """Tikhonov-regularized S^{-1} rhs through eigh (S Hermitian
        PSD): eigenvalues below svd_tol max|e| are cut."""
        e, U = torch.linalg.eigh(S)
        cut = self.svd_tol * torch.max(e.abs())
        einv = torch.where(e > cut, 1.0 / torch.where(e > cut, e, 1.0),
                           torch.zeros_like(e))
        return U @ (einv.to(U.dtype)[:, None] * (U.mH @ rhs))

    # ------------------------------------------------------------- rhs

    def _rhs(self, state):
        q, p, alpha, gamma, C = state
        core = _pair_core(q, p, alpha, gamma)
        S = core["S"]
        # V, grad V and Hess V at the N² pair centroids and the N centres
        N = q.shape[0]
        derivs = self._derivatives(torch.cat(
            [core["mu"].real.reshape(N * N, -1), q]))
        pairs = tuple(x[:N * N] for x in derivs)
        centres = tuple(x[N * N:] for x in derivs)

        # ---- classical trajectory EOM
        Vq, F, Hq = self._traj_force(C, centres)
        dq = self.minv[None, :] * p            # (N, D)
        dp = F
        dgamma = 0.5 * torch.sum(self.minv * p ** 2, dim=1) - Vq
        if self.thawed:
            hess_d = torch.diagonal(Hq, dim1=-2, dim2=-1)
            dalpha = 1j * (hess_d - alpha ** 2 * self.minv[None, :])
        else:
            dalpha = torch.zeros_like(alpha)

        # ---- tau = <g_j | d g_k / dt>  (analytic, ratio form)
        delta, var = core["delta"], core["var"]
        ak = alpha[None, :, :]
        tau_r = torch.sum(
            dq[None, :, :] * (ak * delta - 1j * p[None, :, :])
            + 1j * dp[None, :, :] * delta, dim=-1)
        tau_r = tau_r + 1j * dgamma[None, :]
        if self.thawed:
            dak = dalpha[None, :, :]
            tau_r = tau_r + torch.sum(
                dak.real / (4.0 * ak.real)
                - 0.5 * dak * (var + delta ** 2), dim=-1)
        tau = S * tau_r

        # ---- H C and the amplitude EOM
        kin = S * torch.sum(0.5 * self.minv * core["kinr"], dim=-1)
        Vel = self._potential_elements(core, pairs)
        HC = kin @ C + torch.einsum("jakb, kb -> ja", Vel, C)
        rhs = -1j * HC - tau @ C
        dC = self._reg_solve(S, rhs)
        return dq, dp, dalpha, dgamma, dC

    # ------------------------------------------------------------- run

    def _basis(self, q, p, alpha, gamma=None):
        """(q, p, alpha, gamma) as tensors on the device (gamma zero when
        None)."""
        dev = self.device
        q = torch.as_tensor(np.asarray(q, float), device=dev)
        gamma = (torch.zeros(q.shape[0], dtype=torch.float64, device=dev)
                 if gamma is None
                 else torch.as_tensor(np.asarray(gamma, float), device=dev))
        return (q, torch.as_tensor(np.asarray(p, float), device=dev),
                as_tensor(alpha, device=dev).to(torch.complex128), gamma)

    def run(self, q, p, alpha, C, dt, nt, gamma=None, nout: int = 1):
        """RK4-propagate the joint (trajectories + amplitudes) state.

        q, p : (N, D) initial centres / momenta; alpha : (N, D) complex
        widths (Re > 0); C : (N, ns) initial amplitudes (e.g. from
        ``project``). Returns a dict of tensors: times, the q, p, alpha,
        gamma and C snapshots and the electronic populations (nsnap, ns).
        """
        state = self._basis(q, p, alpha, gamma) + (
            as_tensor(C, device=self.device).to(torch.complex128),)

        def step(s):
            k1 = self._rhs(s)
            k2 = self._rhs(tuple(a + 0.5 * dt * b for a, b in zip(s, k1)))
            k3 = self._rhs(tuple(a + 0.5 * dt * b for a, b in zip(s, k2)))
            k4 = self._rhs(tuple(a + dt * b for a, b in zip(s, k3)))
            return tuple(a + dt / 6.0 * (b + 2 * c + 2 * d + e)
                         for a, b, c, d, e in zip(s, k1, k2, k3, k4))

        nsnap = max(nt // nout, 0)
        snaps = [state]
        for _ in range(nsnap):
            for _ in range(nout):
                state = step(state)
            snaps.append(state)
        out = {k: torch.stack([s[i] for s in snaps])
               for i, k in enumerate(("q", "p", "alpha", "gamma", "C"))}
        out["times"] = torch.arange(nsnap + 1, dtype=torch.float64,
                                    device=self.device) * dt * nout
        out["populations"] = torch.stack([self.populations(s)
                                          for s in snaps])
        return out

    # ---------------------------------------------------- observables

    def populations(self, state):
        q, p, alpha, gamma, C = state
        S = GWPMatrixElements.overlap(q, p, alpha, gamma)
        return torch.einsum("ja, jk, ka -> a", C.conj(), S, C).real

    def norm(self, state):
        return torch.sum(self.populations(state))

    def rdm_el(self, state):
        """Electronic reduced density matrix rho[a, b] =
        sum_jk C*_{jb} S_jk C_{ka}, so <A> = tr(rho A)
        (reference: pyqed/ldr/gwp.py:1077 ``rdm_el``)."""
        q, p, alpha, gamma, C = state
        S = GWPMatrixElements.overlap(q, p, alpha, gamma)
        return torch.einsum("jb, jk, ka -> ab", C.conj(), S, C)

    def obs_el(self, state, a):
        """Expectation of an electronic (Condon) operator a (ns, ns)."""
        rho = self.rdm_el(state)
        return torch.trace(rho @ as_tensor(a, device=rho.device).to(
            rho.dtype))

    def obs_nuc(self, state, which="x"):
        """Expectation of a nuclear one-body observable per dimension:
        ``which`` in {'x', 'x2', 'p'} -> (D,)."""
        q, p, alpha, gamma, C = state
        core = _pair_core(q, p, alpha, gamma)
        S = core["S"]
        w = torch.einsum("ja, jk, ka -> jk", C.conj(), S, C)
        if which == "x":
            val = core["mu"]
        elif which == "x2":
            val = core["mu"] ** 2 + core["var"]
        elif which == "p":
            # p g_k = (p_k + i alpha_k (x - q_k)) g_k
            val = p[None, :, :] + 1j * alpha[None, :, :] * (
                core["mu"] - q[None, :, :])
        else:
            raise ValueError("which must be 'x', 'x2' or 'p'")
        return torch.einsum("jk, jkd -> d", w, val).real

    def nuclear_density(self, state, x):
        """rho(x_m) = sum_a |psi_a(x_m)|^2 on grid points x (M, D)."""
        psi = self.wavefunction(state, x)
        return torch.sum(psi.abs() ** 2, dim=-1)

    def project(self, q, p, alpha, q0, p0, alpha0, state: int = 0,
                gamma=None):
        """Amplitudes C (N, ns) of one Gaussian (q0, p0, alpha0) on
        electronic ``state``: C = S^{-1} <g_j|g0>."""
        dev = self.device
        q, p, alpha, gamma = self._basis(q, p, alpha, gamma)
        b = gaussian_overlap_with(
            q, p, alpha, gamma,
            torch.as_tensor(np.asarray(q0, float), device=dev),
            torch.as_tensor(np.asarray(p0, float), device=dev),
            as_tensor(alpha0, device=dev).to(torch.complex128))
        S = GWPMatrixElements.overlap(q, p, alpha, gamma)
        c = self._reg_solve(S, b[:, None])[:, 0]
        C = torch.zeros((q.shape[0], self.ns), dtype=torch.complex128,
                        device=dev)
        C[:, state] = c
        return C

    def wavefunction(self, state, x):
        """psi_a(x_m) on grid points x (M, D): returns (M, ns)."""
        q, p, alpha, gamma, C = state
        x = torch.atleast_2d(as_tensor(x, device=q.device).to(q.dtype))
        dx = x[:, None, :] - q[None, :, :]          # (M, N, D)
        g = (torch.prod((alpha.real[None] / math.pi) ** 0.25
                        * torch.exp(-0.5 * alpha[None] * dx ** 2
                                    + 1j * p[None] * dx), dim=-1)
             * torch.exp(1j * gamma)[None, :])
        return g @ C

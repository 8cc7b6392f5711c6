"""Equilibrium single-site DMFT for the Bethe lattice (IPT solver), and
nonequilibrium DMFT on the two-time Kadanoff-Baym contour.

PyTorch counterpart of ``pyqed_tpu/negf/dmft.py`` (reference:
pyqed/gw/dmft.py:40 ``DMFT`` — untranslated C++ pseudocode for the
semicircular-DOS self-consistency ``eq_dmft_self_consistency`` and an
impurity step; :176 ``start_noneq_dmft``, :213
``noneq_dmft_self_consistency``). Standard formulation on the Matsubara
axis:

    semicircular DOS (bandwidth 4t):  Δ(iω) = t² G(iω)
    Weiss field      G0(iω) = 1 / (iω + μ − t² G(iω))
    IPT impurity     Σ(τ)   = −U² G0(τ)² G0(−τ)   (ph-symmetric)
    local Dyson      G(iω)  = 1 / (iω + μ − t² G(iω) − Σ(iω))

The τ ↔ iω transforms handle the 1/(iω) tail analytically; they are two
phase-matrix products on the device, the iω grid the batch axis. The
nonequilibrium solvers run the port's Kadanoff-Baym marches
(negf/kb2t.py). Every class computes on ``device`` (the card when None).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import resolve_device
from .kb2t import _march, _march3, _greater, _swapT, _f64

C128 = torch.complex128


class DMFT:
    """Half-filled single-band Hubbard model on the Bethe lattice.

    Parameters
    ----------
    U : on-site interaction.
    t : hopping (quarter bandwidth).
    beta : inverse temperature.
    niw : number of positive Matsubara frequencies.
    device : where the iteration runs (the card when None); ``G`` and
        ``Sigma`` are NumPy, as in the JAX package.
    """

    def __init__(self, U, t=0.5, beta=16.0, niw=256, device=None):
        self.device = resolve_device(device)
        self.U = U
        self.t = t
        self.beta = beta
        self.niw = niw
        n = np.arange(niw)
        self.iw = 1j * (2 * n + 1) * np.pi / beta
        self.G = None
        self.Sigma = None

    def _iw_t(self):
        return torch.as_tensor(self.iw, device=self.device)

    # ------------------------------------------------ tau <-> iw
    def _w2t(self, Gw, ntau=512):
        """G(τ) on [0, β] from positive-frequency G(iω_n), subtracting
        the 1/(iω) tail analytically: G(tau) = (2/beta) sum_n
        Re[core e^{-iw tau}] - 1/2. Tensors in, tensors out."""
        beta = self.beta
        tau = torch.linspace(0, beta, ntau, dtype=torch.float64,
                             device=self.device)
        iw = self._iw_t()
        phase = torch.exp(-1j * tau[:, None] * iw.imag[None, :])
        Gt = (2.0 / beta) * torch.real(phase @ (Gw - 1.0 / iw)) - 0.5
        return tau, Gt

    def _t2w(self, tau, Ft):
        """F(iω_n) = ∫_0^β dτ e^{iω τ} F(τ) (trapezoid)."""
        w = torch.ones_like(tau)
        w[0] = w[-1] = 0.5
        dtau = tau[1] - tau[0]
        phase = torch.exp(1j * self._iw_t().imag[:, None] * tau[None, :])
        return phase @ (w * Ft).to(C128) * dtau

    # ------------------------------------------------------------- run
    def run(self, niter=60, mix=0.7, tol=1e-8):
        iw = self._iw_t()
        t2 = self.t ** 2
        # start from the non-interacting Bethe GF
        G = 2.0 / (iw + torch.sqrt(iw ** 2 - 4 * t2))
        for _ in range(niter):
            G0 = 1.0 / (iw - t2 * G)
            tau, G0t = self._w2t(G0)
            # IPT: Sigma(tau) = -U^2 G0(tau)^2 G0(-tau)
            #                 = +U^2 G0(tau)^2 G0(beta-tau)
            St = self.U ** 2 * G0t ** 2 * G0t.flip(0)
            Sw = self._t2w(tau, St)
            G_new = 1.0 / (iw - t2 * G - Sw)
            diff = float(torch.max(torch.abs(G_new - G)))
            G = mix * G_new + (1 - mix) * G
            if diff < tol:
                break
        self.G = G.cpu().numpy()
        self.Sigma = Sw.cpu().numpy()
        return self.G

    # ----------------------------------------------------- observables
    def quasiparticle_weight(self):
        """Z = 1 / (1 − dImΣ/dω|_{ω→0}) from the first Matsubara
        frequency."""
        s1 = self.Sigma[0].imag
        w1 = self.iw[0].imag
        return 1.0 / (1.0 - s1 / w1)

    def density(self):
        """n per spin (−G(τ=β⁻)); 0.5 at particle-hole symmetry."""
        _, Gt = self._w2t(torch.as_tensor(self.G, device=self.device))
        return float(-Gt[-1])


def _ipt_sigma(UU, theta, XR, XL):
    """Σ^≶ = U(t) U(t') X^≶ X^≶ X^≷(t', t) and Σ^R = θ (Σ^> − Σ^<)."""
    Xgtr = _greater(XR, XL)
    SL = UU * XL * XL * _swapT(Xgtr)
    Sgtr = UU * Xgtr * Xgtr * _swapT(XL)
    return theta * (Sgtr - SL), SL


def _gm_weights(nt, dt, dev):
    """Trapezoid weights w[t, s] over s in [0, t] of the equal-time
    Langreth convolutions."""
    idx = torch.arange(nt, device=dev)
    w = _f64(idx[None, :] <= idx[:, None]) * dt
    w[:, 0] = dt / 2
    return torch.where(idx[None, :] == idx[:, None], dt / 2, w).to(C128)


class NoneqDMFT:
    """Nonequilibrium DMFT for the half-filled Hubbard model on the
    Bethe lattice: interaction quench U(t), two-time Kadanoff-Baym
    propagation, IPT impurity solver (reference: pyqed/gw/dmft.py:176
    ``start_noneq_dmft`` / :213 ``noneq_dmft_self_consistency`` —
    untranslated C++ pseudocode). The Bethe self-consistency closes in
    the time domain, Δ(t, t') = v² G(t, t'), and Δ adds to the impurity
    self-energy in the KB collision integrals. Impurity solver =
    nonequilibrium IPT with the Weiss field G0 (Eckstein & Werner, PRB 81,
    115131 (2010)) or self-consistent second Born:

        Σ^≶(t, t') = U(t) U(t') [G0^≶(t, t')]² G0^≷(t', t)

    Half filling by particle-hole symmetry (h(t) = 0, μ = U/2). All
    two-time objects are (nt, nt) scalars on ``device``.

    ``n0``: initial per-spin occupation of the uncorrelated product
    state; n0 = 1/2 is stationary under any U (only spectral quantities
    evolve). ``solver``: 'ipt' or '2b'.
    """

    def __init__(self, Ufun, v=0.5, nt=128, dt=0.05, n0=0.5,
                 solver="ipt", device=None):
        self.device = resolve_device(device)
        self.Ufun = Ufun if callable(Ufun) else (lambda t, U0=Ufun: U0)
        self.v = v
        self.nt = nt
        self.dt = dt
        self.n0 = n0
        self.solver = solver.lower()
        if self.solver not in ("ipt", "2b"):
            raise ValueError(f"solver {solver!r}: use 'ipt' or '2b'")
        self.G = None            # (GR, GL) two-time pair
        self.G0 = None

    def _sigma(self, hs, GR0, GL0, GR, GL, UU, theta):
        """(SR, SL, G0R, G0L) of the impurity solver at the current G."""
        DR, DL = self.v ** 2 * GR, self.v ** 2 * GL      # Bethe closure
        G0R = G0L = None
        if self.solver == "ipt":
            # Weiss field: march with the hybridization only
            G0R, G0L = _march(hs, GR0, GL0, DR, DL, self.dt)
            XR, XL = G0R, G0L
        else:
            XR, XL = GR, GL
        SR, SL = _ipt_sigma(UU, theta, XR, XL)
        return SR, SL, DR, DL, G0R, G0L

    # ------------------------------------------------------------- run
    def run(self, niter=12, mix=0.7, tol=1e-8, verbose=False):
        nt, dt, dev = self.nt, self.dt, self.device
        ts = np.arange(nt) * dt
        Us = torch.as_tensor([float(self.Ufun(t)) for t in ts],
                             dtype=torch.float64, device=dev)
        hs = torch.zeros((nt, 1, 1), dtype=C128, device=dev)
        GR0 = torch.zeros((nt, nt, 1, 1), dtype=C128, device=dev)
        GL0 = torch.zeros_like(GR0)
        GR0[0, 0, 0, 0] = -1j
        GL0[0, 0, 0, 0] = 1j * self.n0
        zero = torch.zeros_like(GR0)
        # start from the isolated impurity
        GR, GL = _march(hs, GR0, GL0, zero, zero, dt)
        self.converged = False
        diff = float("inf")
        theta = torch.tril(torch.ones((nt, nt), dtype=C128,
                                      device=dev))[:, :, None, None]
        UU = (Us[:, None] * Us[None, :])[:, :, None, None].to(C128)
        for it in range(niter):
            SR, SL, DR, DL, _, _ = self._sigma(hs, GR0, GL0, GR, GL, UU,
                                               theta)
            GR_new, GL_new = _march(hs, GR0, GL0, SR + DR, SL + DL, dt)
            diff = float(torch.max(torch.abs(GL_new - GL)))
            GR = mix * GR_new + (1 - mix) * GR
            GL = mix * GL_new + (1 - mix) * GL
            if verbose:
                print(f"noneq-DMFT iter {it}: |dG^<| = {diff:.3e}")
            self.converged = diff < tol
            if self.converged:
                break
        if not self.converged:
            warnings.warn(f"noneq-DMFT: |dG^<| = {diff:.3e} > tol = "
                          f"{tol:.1e} after {niter} iterations",
                          stacklevel=2)
        # Sigma (and the Weiss field) from the FINAL mixed G, consistent
        # with self.G (Galitskii-Migdal energies of loose runs)
        SR, SL, DR, DL, G0R, G0L = self._sigma(hs, GR0, GL0, GR, GL, UU,
                                               theta)
        self.G = (GR, GL)
        self.G0 = (G0R, G0L)
        self.SR, self.SL = SR, SL
        self.DR, self.DL = DR, DL
        self.Us = Us
        return GR, GL

    # ----------------------------------------------------- observables
    def density(self):
        """n(t) = −i G^<(t,t) per spin (NumPy); exactly 1/2 at all times
        by particle-hole symmetry."""
        GL = self.G[1]
        k = torch.arange(self.nt, device=GL.device)
        return torch.real(-1j * GL[k, k, 0, 0]).cpu().numpy()

    def retarded_t0(self):
        """G^R(t, 0) (NumPy) — at U = 0 the exact Bethe-lattice answer is
        −i J1(2 v t)/(v t)."""
        return self.G[0][:, 0, 0, 0].cpu().numpy()

    def _gm_conv(self, AR, AL):
        """Equal-time Langreth convolution [A ∗ G]^<(t,t) =
        ∫ ds (A^R(t,s) G^<(s,t) + A^<(t,s) G^A(s,t)), trapezoid in the
        history (the Galitskii-Migdal building block); NumPy (nt,)."""
        GR, GL = self.G
        w = _gm_weights(self.nt, self.dt, GL.device)
        GA = _swapT(GR).conj()
        conv = (torch.einsum("ts, tsab, stbc -> tac", w, AR, GL)
                + torch.einsum("ts, tsab, stbc -> tac", w, AL, GA))
        return conv[:, 0, 0].cpu().numpy()

    def interaction_energy(self):
        """Galitskii-Migdal E_int(t) = Σ_σ Re(−i/2 [Σ ∗ G]^<(t,t)) — two
        spins, per lattice site, Hartree part excluded."""
        return 2 * np.real(-0.5j * self._gm_conv(self.SR, self.SL))

    def kinetic_energy(self):
        """E_kin(t) = Σ_σ Re(−i [Δ ∗ G]^<(t,t)) (the hybridization
        convolution; the kinetic energy per site of the Bethe lattice)."""
        return 2 * np.real(-1j * self._gm_conv(self.DR, self.DL))

    def total_energy(self):
        return self.kinetic_energy() + self.interaction_energy()

    def double_occupancy(self):
        """d(t) = ⟨n↑ n↓⟩ = n(t)² + E_int(t)/U(t); entries with U(t) = 0
        return the uncorrelated n²."""
        E = self.interaction_energy()
        n = self.density()
        Us = self.Us.cpu().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.where(Us != 0.0, E / np.where(Us == 0, 1, Us), 0.0)
        return n ** 2 + corr


class NoneqDMFTThermal:
    """Nonequilibrium DMFT with INITIAL CORRELATIONS: interaction quench
    U(t) from the free THERMAL state of the Bethe lattice at inverse
    temperature β, on the full three-branch Kadanoff-Baym contour
    (negf/kb2t.py::_march3 — Matsubara branch + left-mixing G^⌐ carried
    through the march), on ``device`` (the card when None).

    Bethe-lattice closure on every component: Δ^X = v² G^X for X ∈
    {R, <, ⌐, M}; the initial impurity G^M is the exact semicircular-DOS
    Matsubara function; U on the imaginary branch is zero, so Σ_U has no
    M/⌐ components (quench from the FREE thermal state).
    """

    def __init__(self, Ufun, v=0.5, nt=96, dt=0.06, beta=8.0,
                 ntau=128, solver="2b", device=None):
        self.device = resolve_device(device)
        self.Ufun = Ufun if callable(Ufun) else (lambda t, U0=Ufun: U0)
        self.v = v
        self.nt = nt
        self.dt = dt
        self.beta = beta
        self.ntau = ntau
        self.dtau = beta / ntau
        self.solver = solver.lower()
        if self.solver not in ("ipt", "2b"):
            raise ValueError(f"solver {solver!r}: use 'ipt' or '2b'")
        self.G = None

    # ------------------------------------------------- Matsubara input
    def _gm_free(self):
        """Exact free Bethe impurity G^M(τ) = −∫dω ρ(ω) e^{−ωτ}(1−f(ω))
        on τ_k = k β/ntau (semicircular ρ, half filling); host NumPy
        quadrature, as in the JAX package."""
        v, beta = self.v, self.beta
        w = np.linspace(-2 * v, 2 * v, 4001)
        rho = np.sqrt(np.maximum(4 * v ** 2 - w ** 2, 0.0)) \
            / (2 * np.pi * v ** 2)
        tau = np.arange(self.ntau + 1) * self.dtau
        # e^{−ωτ}(1−f) = e^{−ωτ}/(1+e^{−βω}): overflow-safe form
        ex = np.exp(-np.outer(tau, w)
                    - np.log1p(np.exp(-beta * np.abs(w)))
                    [None, :]) * np.where(w >= 0, 1.0,
                                          np.exp(beta * w))[None, :]
        gm = -np.trapezoid(rho[None, :] * ex, w, axis=1)
        return gm.reshape(self.ntau + 1, 1, 1).astype(complex)

    def _march3(self, hs, GM, GV0, SR, SL, SV):
        return _march3(hs, GM, GV0, SR, SL, SV, self.dt, self.dtau,
                       self.beta)

    def _sigma(self, hs, GM, GV0, GR, GL, GV, UU, theta):
        DR, DL, DV = (self.v ** 2 * GR, self.v ** 2 * GL, self.v ** 2 * GV)
        if self.solver == "ipt":
            XR, XL, _ = self._march3(hs, GM, GV0, DR, DL, DV)
        else:
            XR, XL = GR, GL
        SR, SL = _ipt_sigma(UU, theta, XR, XL)
        return SR, SL, DR, DL, DV

    # ------------------------------------------------------------- run
    def run(self, niter=12, mix=0.7, tol=1e-8, verbose=False):
        nt, dt, dev = self.nt, self.dt, self.device
        ts = np.arange(nt) * dt
        Us = torch.as_tensor([float(self.Ufun(t)) for t in ts],
                             dtype=torch.float64, device=dev)
        hs = torch.zeros((nt, 1, 1), dtype=C128, device=dev)
        GM = torch.as_tensor(self._gm_free(), device=dev)
        GV0 = -1j * GM.flip(0)                 # G^⌐(0,τ) = −i G^M(β−τ)
        zero2 = torch.zeros((nt, nt, 1, 1), dtype=C128, device=dev)
        zeroV = torch.zeros((nt, self.ntau + 1, 1, 1), dtype=C128,
                            device=dev)
        theta = torch.tril(torch.ones((nt, nt), dtype=C128,
                                      device=dev))[:, :, None, None]
        UU = (Us[:, None] * Us[None, :])[:, :, None, None].to(C128)

        # start: free march with the Bethe hybridization iterated
        GR, GL, GV = self._march3(hs, GM, GV0, zero2, zero2, zeroV)
        self.converged = False
        diff = float("inf")
        for it in range(niter):
            SR, SL, DR, DL, DV = self._sigma(hs, GM, GV0, GR, GL, GV, UU,
                                             theta)
            GR_new, GL_new, GV_new = self._march3(hs, GM, GV0, SR + DR,
                                                  SL + DL, DV)
            diff = float(torch.max(torch.abs(GL_new - GL)))
            GR = mix * GR_new + (1 - mix) * GR
            GL = mix * GL_new + (1 - mix) * GL
            GV = mix * GV_new + (1 - mix) * GV
            if verbose:
                print(f"thermal noneq-DMFT iter {it}: "
                      f"|dG^<| = {diff:.3e}")
            self.converged = diff < tol
            if self.converged:
                break
        if not self.converged:
            warnings.warn(f"thermal noneq-DMFT: |dG^<| = {diff:.3e} > "
                          f"tol = {tol:.1e} after {niter} iterations",
                          stacklevel=2)
        # Sigma consistent with the FINAL mixed G (see NoneqDMFT.run)
        SR, SL, _, _, _ = self._sigma(hs, GM, GV0, GR, GL, GV, UU, theta)
        self.G = (GR, GL, GV)
        self.GM = GM
        self.SR, self.SL = SR, SL
        self.Us = Us
        return GR, GL, GV

    # ----------------------------------------------------- observables
    def density(self):
        GL = self.G[1]
        k = torch.arange(self.nt, device=GL.device)
        return torch.real(-1j * GL[k, k, 0, 0]).cpu().numpy()

    def _conv_less_diag(self, AR, AL, AV):
        """[A ∗ G]^<(t,t) with the three-branch Langreth rule:
        A^R∗G^< + A^<∗G^A − i A^⌐ ⋆ G^⌐̃; NumPy (nt,)."""
        GR, GL, GV = self.G
        w = _gm_weights(self.nt, self.dt, GL.device)
        GA = _swapT(GR).conj()
        conv = (torch.einsum("ts, tsab, stbc -> tac", w, AR, GL)
                + torch.einsum("ts, tsab, stbc -> tac", w, AL, GA))
        if AV is not None:
            wtau = torch.full((self.ntau + 1,), self.dtau, dtype=C128,
                              device=GL.device)
            wtau[0] = wtau[-1] = self.dtau / 2
            # G^⌐̃(τ, t) = [G^⌐(t, β−τ)]^† (scalar: conj of the flip)
            GVt = GV.flip(1).conj()
            conv = conv - 1j * torch.einsum("k, tkab, tkbc -> tac", wtau,
                                            AV, GVt)
        return conv[:, 0, 0].cpu().numpy()

    def interaction_energy(self):
        """2 spins; Σ_U has no mixed component (U = 0 on the imaginary
        branch)."""
        return 2 * np.real(-0.5j * self._conv_less_diag(
            self.SR, self.SL, None))

    def kinetic_energy(self):
        """E_kin(t) = 2 Re(−i [Δ ∗ G]^<(t,t)) INCLUDING the mixed ⋆ term
        — at t = 0 the finite thermal kinetic energy."""
        GR, GL, GV = self.G
        return 2 * np.real(-1j * self._conv_less_diag(
            self.v ** 2 * GR, self.v ** 2 * GL, self.v ** 2 * GV))

    def total_energy(self):
        return self.kinetic_energy() + self.interaction_energy()

    def double_occupancy(self):
        E = self.interaction_energy()
        n = self.density()
        Us = self.Us.cpu().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.where(Us != 0.0, E / np.where(Us == 0, 1, Us),
                            0.0)
        return n ** 2 + corr

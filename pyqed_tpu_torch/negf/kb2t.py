"""Two-time Kadanoff-Baym equations: causal Volterra time-stepping.

PyTorch counterpart of ``pyqed_tpu/negf/kb2t.py`` (reference:
pyqed/gw/green.py:2053 ``KBSolver`` whose ``run`` is ``pass``, :2133
``volterra_intdiff`` — a half-transcribed C++ routine). Predictor-
corrector (implicit 2nd-order) stepping of the retarded and lesser
Green functions on the two-time grid,

    [i d/dt − h(t)] G^R(t,t') = δ(t,t') + ∫_{t'}^{t} ds Σ^R(t,s) G^R(s,t')
    [i d/dt − h(t)] G^<(t,t') = ∫_0^{t}  ds Σ^R(t,s) G^<(s,t')
                               + ∫_0^{t'} ds Σ^<(t,s) G^A(s,t')

with a time-dependent (driven) h(t) and an optional self-consistent
second-Born or GW self-energy. The thermal initial condition enters
through G^<(0,0) = i f_β(h(0)) (partial equilibrium); :func:`_march3`
carries the Matsubara and left-mixing branches (initial correlations).

Each time row n updates ALL earlier columns at once: the memory
integrals are batched products over the history axis with masked
trapezoid weights, on the device. The JAX package runs the rows as one
jitted ``lax.fori_loop``; here the rows are a Python loop of device
operations (a row's work does not depend on host values, so nothing is
read back inside the march).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import resolve_device

C128 = torch.complex128


def _swapT(X):
    """X(t', t) with the matrix transposed."""
    return X.transpose(0, 1).transpose(-1, -2)


def _f64(mask):
    """A boolean mask as float64 weights (``torch.where`` on two Python
    scalars would give float32)."""
    return mask.to(torch.float64)


def _greater(GR, GL):
    """G^>(t,t') = G^R - G^A + G^< with the equal-time convention
    repaired: the stored G^R(t,t) = -i I and G^A(t,t) = +i I double count
    the theta(0) jump, so +i I is restored on the diagonal — G^>(t,t) =
    G^<(t,t) - i I = -i (1 - rho) exactly."""
    nt, n = GR.shape[0], GR.shape[-1]
    G = GR - _swapT(GR).conj() + GL
    k = torch.arange(nt, device=GR.device)
    G[k, k] = G[k, k] + 1j * torch.eye(n, dtype=G.dtype, device=G.device)
    return G


class _Weights:
    """The trapezoid weights of the march on an nt-point grid."""

    def __init__(self, nt, dt, dev):
        self.dt = dt
        idx = torch.arange(nt, device=dev)
        self.idx = idx
        j_ = idx[:, None]
        l_ = idx[None, :]
        self.j_, self.l_ = j_, l_
        # column-wise weights of the Σ^< G^A integral over s in [0, t'=j]
        wcol = _f64((l_ > 0) & (l_ < j_)) * dt
        wcol = wcol + _f64((l_ == 0) & (j_ > 0)) * dt / 2
        wcol = wcol + _f64((l_ == j_) & (j_ > 0)) * dt / 2
        self.wcol = wcol.to(C128)

    def hist(self, row, implicit=False):
        """Weights over s in [0, row]: dt/2 at both edges, dt interior;
        zero for row = 0. In the IMPLICIT stage the s = row endpoint is
        carried by the solve matrix, so it is zeroed here."""
        dt, idx = self.dt, self.idx
        w = _f64(idx < row) * dt
        w[0] = dt / 2 if row > 0 else 0.0
        if not implicit and row > 0:
            w = w + _f64(idx == row) * dt / 2
        return w.to(C128)

    def ret(self, row, implicit=False):
        """Column-dependent weights of the RETARDED collision
        ∫_{t'=j}^{t=row} ds: wret[j, l], dt/2 at s = j and s = row, dt
        interior, empty for j >= row."""
        dt, j_, l_ = self.dt, self.j_, self.l_
        w = _f64((l_ > j_) & (l_ < row)) * dt
        w = w + _f64((l_ == j_) & (j_ < row)) * dt / 2
        if not implicit:
            w = w + _f64((l_ == row) & (j_ < row)) * dt / 2
        return w.to(C128)


def _coll_R(wt, Srow, G, row, implicit=False):
    """∫_{t'}^{row} ds Σ^R(row, s) G^R(s, j) for every column j."""
    return torch.einsum("jl, lab, ljbc -> jac", wt.ret(row, implicit),
                        Srow, G)


def _row_R(wt, hs, SR, GR, nrow, eye):
    """The retarded row ``nrow`` (in place) and its solve matrix."""
    dt = wt.dt
    colmask = (wt.idx < nrow)[:, None, None]
    dGR_prev = (torch.einsum("ab, jbc -> jac", -1j * hs[nrow - 1],
                             GR[nrow - 1])
                - 1j * _coll_R(wt, SR[nrow - 1], GR, nrow - 1))
    # implicit stage: known history with interior weights; the s = nrow
    # endpoint sits in A below
    I_R = _coll_R(wt, SR[nrow], GR, nrow, implicit=True)
    rhs = GR[nrow - 1] + 0.5 * dt * (dGR_prev - 1j * I_R)
    A = eye + 0.5j * dt * hs[nrow] + 0.25j * dt * dt * SR[nrow, nrow]
    GR_new = torch.linalg.solve(A[None], rhs)
    GR[nrow] = torch.where(colmask, GR_new, 0.0)
    GR[nrow, nrow] = -1j * eye
    return A, colmask


def _row_L(wt, hs, coll, GL, A, colmask, nrow):
    """The lesser row ``nrow``, its mirrored column and the equal-time
    element (in place); ``coll(GL, row, implicit)`` is the row's
    collision integral for every column."""
    dt = wt.dt
    h_prev, h_new = hs[nrow - 1], hs[nrow]
    dGL_prev = (torch.einsum("ab, jbc -> jac", -1j * h_prev, GL[nrow - 1])
                - 1j * coll(GL, nrow - 1, False))
    I_L = coll(GL, nrow, True)
    rhsL = GL[nrow - 1] + 0.5 * dt * (dGL_prev - 1j * I_L)
    GL_new = torch.where(colmask, torch.linalg.solve(A[None], rhsL),
                         GL[nrow])
    GL[nrow] = GL_new
    # mirror the new row onto the column: G^<(j, n) = −G^<(n, j)†
    GL[:, nrow] = torch.where(colmask, -GL_new.transpose(-1, -2).conj(),
                              GL[:, nrow])
    # equal-time element from the Heisenberg equation of rho(t) (Heun:
    # Euler predictor, trapezoid corrector with the collision at the new
    # row); the collision combination is the Hermitian I1 + I1^dag
    diag_prev = GL[nrow - 1, nrow - 1]
    cprev = coll(GL, nrow - 1, False)[nrow - 1]
    ddiag = (-1j * (h_prev @ diag_prev - diag_prev @ h_prev)
             - 1j * (cprev + cprev.T.conj()))
    pred = diag_prev + dt * ddiag
    GL[nrow, nrow] = 0.5 * (pred - pred.T.conj())
    pred = GL[nrow, nrow].clone()
    cnew = coll(GL, nrow, False)[nrow]
    ddiag_new = (-1j * (h_new @ pred - pred @ h_new)
                 - 1j * (cnew + cnew.T.conj()))
    diag = diag_prev + 0.5 * dt * (ddiag + ddiag_new)
    GL[nrow, nrow] = 0.5 * (diag - diag.T.conj())


def _march(hs, GR0, GL0, SR, SL, dt):
    """One causal sweep over the time rows (on the tensors' device);
    returns new (GR, GL)."""
    nt, n = GR0.shape[0], GR0.shape[-1]
    dev = GR0.device
    wt = _Weights(nt, dt, dev)
    eye = torch.eye(n, dtype=C128, device=dev)
    GR, GL = GR0.clone(), GL0.clone()

    def coll(GLc, row, implicit):
        return (torch.einsum("l, lab, ljbc -> jac", wt.hist(row, implicit),
                             SR[row], GLc)
                + torch.einsum("jl, lab, ljbc -> jac", wt.wcol, SL[row], GA))

    for nrow in range(1, nt):
        A, colmask = _row_R(wt, hs, SR, GR, nrow, eye)
        GA = _swapT(GR).conj()
        _row_L(wt, hs, coll, GL, A, colmask, nrow)
    return GR, GL


class KBSolver2T:
    """Two-time Kadanoff-Baym propagation on ``device`` (the card when
    None).

    Parameters
    ----------
    hfun : callable t -> (n, n) single-particle Hamiltonian (may be
        time-dependent: quenches/drives); NumPy or tensors.
    nt, dt : real-time grid.
    beta, mu : initial thermal occupation f_beta(h(0) - mu).
    U : on-site interaction for the built-in self-energy (single-orbital
        convention); 0 = free propagation.
    selfenergy : "2B" (second Born, the direct U^2 term) or "GW"
        (RPA-screened: W solved from the Volterra Dyson chain W = v + v P
        W on the two-time grid; weak-U limit == 2B).
    """

    def __init__(self, hfun: Callable, nt: int, dt: float, beta=10.0,
                 mu=0.0, U=0.0, selfenergy="2B", device=None):
        self.device = resolve_device(device)
        self.hfun = hfun
        self.nt = nt
        self.dt = dt
        self.beta = beta
        self.mu = mu
        self.U = U
        self.selfenergy = selfenergy.upper()
        self.size = np.asarray(self._h(0.0)).shape[-1]
        self.GR = self.GL = None

    def _h(self, t):
        h = self.hfun(t)
        return h.detach().cpu().numpy() if isinstance(h, torch.Tensor) \
            else np.asarray(h)

    # ------------------------------------------------------------- run
    def run(self, sc_iter: int = 3):
        """March G^R and G^< over the two-time grid. With U != 0, the
        chosen Σ[G] (2B or GW) is refreshed ``sc_iter`` times (outer
        self-consistency over full re-propagations).

        Returns (GR, GL), each (nt, nt, n, n) on the device; GR is
        lower-triangular in (t, t'), GL satisfies G^<(t',t) =
        −G^<(t,t')†.
        """
        nt, n, dev = self.nt, self.size, self.device
        ts = np.arange(nt) * self.dt
        hs = torch.as_tensor(np.stack([self._h(t) for t in ts]),
                             device=dev).to(C128)
        w0, v0 = np.linalg.eigh(self._h(0.0))
        f = 1.0 / (np.exp(self.beta * (w0 - self.mu)) + 1.0)
        rho0 = (v0 * f) @ v0.conj().T

        GR0 = torch.zeros((nt, nt, n, n), dtype=C128, device=dev)
        GL0 = torch.zeros_like(GR0)
        GR0[0, 0] = -1j * torch.eye(n, dtype=C128, device=dev)
        GL0[0, 0] = 1j * torch.as_tensor(rho0, device=dev).to(C128)
        SR = torch.zeros_like(GR0)
        SL = torch.zeros_like(GR0)

        GR, GL = _march(hs, GR0, GL0, SR, SL, self.dt)
        if self.U != 0.0:
            sigma = (self.gw_self_energy if self.selfenergy == "GW"
                     else self.second_born)
            for _ in range(sc_iter):
                SR, SL = sigma(GR, GL)
                GR, GL = _march(hs, GR0, GL0, SR, SL, self.dt)
        self.GR, self.GL = GR, GL
        return GR, GL

    # ------------------------------------------------- self-energies
    def second_born(self, GR, GL):
        """Local second-Born Σ for on-site U (single-orbital convention;
        reference bubble: pyqed/gw/green.py:1432):
        Σ^<(t,t') = U² G^<(t,t') G^<(t,t') G^>(t',t)   (elementwise),
        Σ^R(t,t') = θ(t−t') [Σ^>(t,t') − Σ^<(t,t')].
        """
        Ggtr = _greater(GR, GL)
        U2 = self.U ** 2
        SL = U2 * GL * GL * _swapT(Ggtr)
        Sgtr = U2 * Ggtr * Ggtr * _swapT(GL)
        theta = torch.tril(torch.ones((self.nt, self.nt), dtype=C128,
                                      device=GR.device))[:, :, None, None]
        return theta * (Sgtr - SL), SL

    def gw_self_energy(self, GR, GL):
        """See :func:`_gw_sigma`."""
        return _gw_sigma(GR, GL, self.U, self.dt)

    # ------------------------------------------------- observables
    def occupations(self):
        """n_a(t) = −i [G^<(t,t)]_aa, NumPy (nt, n)."""
        k = torch.arange(self.nt, device=self.GL.device)
        return torch.real(-1j * torch.diagonal(
            self.GL[k, k], dim1=-2, dim2=-1)).cpu().numpy()


KeldyshSolver = KBSolver2T       # reference drop-in name (pyqed/gw/keldysh.py)


def _gw_sigma(GR, GL, U, dt):
    """GW self-energy on the two-time grid (local/on-site convention
    matching :meth:`KBSolver2T.second_born`).

    Polarization bubble (reference: pyqed/gw/green.py:1432 ``bubble``):
        P^<(t,t') = -i G^<(t,t') G^>(t',t)    (elementwise per (a,b))
        P^>(t,t') = -i G^>(t,t') G^<(t',t)
    Screened interaction beyond the bare v (dynamic part Wt = W - v)
    from the Langreth rules of W = v + v P W, solved as Volterra
    equations of the second kind, row-marched in t:
        Wt^R = v P^R v + v [P^R * Wt^R]
        Wt^< = v P^< v + v [P^R * Wt^< + P^< * Wt^A]
    and Σ^<(t,t') = i G^<(t,t') Wt^<(t,t'),  Σ^R = θ (Σ^> - Σ^<).
    To lowest order Wt = v P v, so Σ reduces EXACTLY to the direct
    second-Born term U² G^< G^< G^>.
    """
    nt = GR.shape[0]
    dev = GR.device
    idx = torch.arange(nt, device=dev)
    Ggtr = _greater(GR, GL)
    PL = -1j * GL * _swapT(Ggtr)
    Pgtr = -1j * Ggtr * _swapT(GL)
    theta = torch.tril(torch.ones((nt, nt), dtype=C128,
                                  device=dev))[:, :, None, None]
    PR = theta * (Pgtr - PL)

    # masked trapezoid weights over s in [0, row]
    wrow = _f64(idx[None, :] <= idx[:, None]) * dt
    wrow[:, 0] = dt / 2
    wrow = torch.where(idx[None, :] == idx[:, None], dt / 2, wrow).to(C128)

    # ---- Wt^R: row-march the Volterra equation (implicit endpoint)
    WtR = torch.zeros_like(GR)
    for t in range(nt):
        conv = U * torch.einsum("s, sab, sjab -> jab", wrow[t], PR[t], WtR)
        denom = 1.0 - U * (dt / 2) * PR[t, t][None]
        new = (U * U * PR[t] + conv) / denom
        WtR[t] = torch.where((idx <= t)[:, None, None], new, 0.0)

    # Wt^A_{ab}(s, t') = conj(Wt^R_{ab}(t', s)) elementwise (local W)
    WtA = WtR.transpose(0, 1).conj()

    def make_less(Pless):
        WtL = torch.zeros_like(GR)
        for t in range(nt):
            c1 = U * torch.einsum("s, sab, sjab -> jab", wrow[t], PR[t], WtL)
            c2 = U * torch.einsum("js, sab, sjab -> jab", wrow, Pless[t],
                                  WtA)
            denom = 1.0 - U * (dt / 2) * PR[t, t][None]
            WtL[t] = (U * U * Pless[t] + c1 + c2) / denom
        return WtL

    def sym(X):
        # project onto the exact Langreth symmetry X^<(t',t) =
        # -X^<(t,t')^dagger (the row-march is asymmetric at O(dt^2))
        return 0.5 * (X - _swapT(X).conj())

    WtL = sym(make_less(PL))
    Wtgtr = sym(make_less(Pgtr))
    SL = 1j * GL * WtL
    Sgtr = 1j * Ggtr * Wtgtr
    return theta * (Sgtr - SL), SL


# ----------------------------------------------------------------------
# three-branch contour: Matsubara + mixed (tv) components
# ----------------------------------------------------------------------

def _march3(hs, GM, GV0, SR, SL, SV, dt, dtau, beta):
    """Causal KB march WITH initial correlations: propagates (G^R, G^<,
    G^⌐) given self-energy components on the three-branch contour (Aoki
    et al., RMP 86, 779 (2014) conventions).

    Components (fermions; (n, n) per point):
      G^M(τ)      (ntau+1, n, n)  imaginary branch, τ ∈ [0, β],
                                   antiperiodic: G^M(τ−β) = −G^M(τ)
      G^⌐(t, τ)   (nt, ntau+1)    left-mixing, G^⌐(0, τ) = −i G^M(β−τ)
      G^R, G^<    (nt, nt)        as in :func:`_march`
    Langreth rules for C = A ∗ B on this contour add
      C^⌐(t,τ) = ∫₀ᵗ A^R G^⌐ − i ∫₀^β dτ̄ A^⌐(t,τ̄) G^M(τ̄−τ)
      C^<(t,t') += −i ∫₀^β dτ̄ A^⌐(t,τ̄) B^⌐̃(τ̄,t'),
                   B^⌐̃(τ,t') = [B^⌐(t', β−τ)]^†
    The real-branch stepping is the same second-order Heun/implicit
    scheme as :func:`_march`. Returns (GR, GL, GV).
    """
    nt, n = SR.shape[0], SR.shape[-1]
    dev = SR.device
    ntau = GM.shape[0] - 1
    eye = torch.eye(n, dtype=C128, device=dev)
    wt = _Weights(nt, dt, dev)

    # --- Matsubara kernel: GM_rel[k, j] = G^M(τ_k − τ_j), antiperiodic
    tk = torch.arange(ntau + 1, device=dev)
    GM_ext = torch.cat([-GM[1:], GM], dim=0)           # τ ∈ (−β, β]
    GM_rel = GM_ext[tk[:, None] - tk[None, :] + ntau]  # (ntau+1, ntau+1, ..)
    wtau = torch.full((ntau + 1,), dtau, dtype=C128, device=dev)
    wtau[0] = wtau[ntau] = dtau / 2

    def star_M(SVrow):
        """∫ dτ̄ Σ^⌐(t,τ̄) G^M(τ̄−τ) -> (ntau+1, n, n); coefficient +1 in
        this module's real-G^M convention."""
        return torch.einsum("k, kab, kjbc -> jac", wtau, SVrow, GM_rel)

    def coll_V(row, GV, implicit=False):
        return (torch.einsum("l, lab, ljbc -> jac", wt.hist(row, implicit),
                             SR[row], GV) + star_M(SV[row]))

    def gv_tilde(GV):
        """B^⌐̃(τ, t') = [B^⌐(t', β−τ)]^† -> (ntau+1, nt, n, n)."""
        return GV.flip(1).transpose(0, 1).transpose(-1, -2).conj()

    GR = torch.zeros((nt, nt, n, n), dtype=C128, device=dev)
    GR[0, 0] = -1j * eye
    GV = torch.zeros((nt, ntau + 1, n, n), dtype=C128, device=dev)
    GV[0] = GV0
    GL = torch.zeros((nt, nt, n, n), dtype=C128, device=dev)
    # G^<(0,0) = i n with density n = −G^M(β⁻)
    GL[0, 0] = 1j * (-GM[-1])

    def coll(GLc, row, implicit):
        return (torch.einsum("l, lab, ljbc -> jac", wt.hist(row, implicit),
                             SR[row], GLc)
                + torch.einsum("jl, lab, ljbc -> jac", wt.wcol, SL[row], GA)
                - 1j * torch.einsum("k, kab, kjbc -> jac", wtau, SV[row],
                                    GVt))

    for nrow in range(1, nt):
        A, colmask = _row_R(wt, hs, SR, GR, nrow, eye)
        # mixed G^⌐ (same implicit scheme; the Matsubara star term has no
        # unknown endpoint: only the Σ^R ∗ G^⌐ history integral has one)
        dGV_prev = (torch.einsum("ab, jbc -> jac", -1j * hs[nrow - 1],
                                 GV[nrow - 1])
                    - 1j * coll_V(nrow - 1, GV))
        I_V = coll_V(nrow, GV, implicit=True)
        rhsV = GV[nrow - 1] + 0.5 * dt * (dGV_prev - 1j * I_V)
        GV[nrow] = torch.linalg.solve(A[None], rhsV)
        GA = _swapT(GR).conj()
        GVt = gv_tilde(GV)
        _row_L(wt, hs, coll, GL, A, colmask, nrow)
    return GR, GL, GV

"""Dissipaton equation of motion (DEOM) — generalized, scaled HEOM
(PyTorch).

Counterpart of ``pyqed_tpu/open/deom.py`` (reference: pyqed/heom/deom.py —
``Bath:895``, ``DEOMSolver:953``, RHS ``generate_dot_element:641`` with the
scaled-ADO convention (sqrt(n)/sqrt(etaa) couplings), 2D frequency-domain
spectra ``correlation_4op_3t:1127``).

Equation (scaled dissipaton densities):

  d rho_n/dt = -(n . expn) rho_n - i[H, rho_n]
      - i sum_k sqrt(n_k)/sqrt(etaa_k) (etal_k Q_m rho_{n-k}
                                        - etar_k rho_{n-k} Q_m)
      - i sum_k sqrt(n_k+1) sqrt(etaa_k) [Q_m, rho_{n+k}]

The hierarchy is the flattened (nado, n, n) tensor of
:mod:`pyqed_tpu_torch.open.heom` with one gather over the [plus; minus]
neighbours; the right-hand side takes any leading batch dimensions, so
one call advances a whole block of hierarchies (the frequency grid of a
response map). The resolvent map has two routes: a host eig of the dense
hierarchy Liouvillian (``correlation_4op_3t``, small hierarchies), and
batched restarted GMRES on the device against the right-hand side and
its transpose, with every operator applied block by block, never as an
(nado n^2)^2 matrix (``correlation_4op_3t_gmres``).

Solvers take ``device``: the card (``cuda``) when None, which raises
without one; ``device="cpu"`` runs on the CPU.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..core.dynamics import rk4_step, rk4_step_t
from ..core.result import Result
from .bath import DrudeBath
from .heom import enumerate_hierarchy, neighbor_maps


class DEOMBath:
    """Exponential bath decomposition containers (reference:
    pyqed/heom/deom.py:895 ``Bath``).

    etal/etar: coefficients of C(t) and of the conjugate correlation
    function; etaa: scaling amplitudes; expn: decay rates; mode: map from
    dissipaton index to coupling-operator index.
    """

    def __init__(self, etal, etar, etaa, expn, mode=None):
        self.etal = np.asarray(etal, dtype=complex)
        self.etar = np.asarray(etar, dtype=complex)
        self.etaa = np.asarray(etaa, dtype=complex)
        self.expn = np.asarray(expn, dtype=complex)
        if mode is None:
            mode = np.zeros(len(self.expn), dtype=np.int64)
        self.mode = np.asarray(mode, dtype=np.int64)

    @classmethod
    def drude(cls, temperature, cutoff, reorg, npsd=2, decomposition="pade",
              nmod=1):
        """Drude bath(s) with numeric Padé/Matsubara decomposition
        (replacing the reference's sympy residue calculus,
        pyqed/heom/deom.py:226); ``nmod`` independent copies, one per
        coupling operator."""
        b = DrudeBath(temperature, cutoff, reorg)
        if decomposition == "pade":
            c, nu = b.pade(npsd)
        else:
            c, nu = b.matsubara(npsd)
        etal = np.asarray(c, dtype=complex)
        # conjugate correlation: C*(t) = sum conj(c_k) e^{-nu_k t}
        # (real rates) — etar_k = conj(etal_k) with the same pole
        etar = np.conj(etal)
        etaa = np.sqrt(np.abs(etal) * np.abs(etar))
        expn = np.asarray(nu, dtype=complex)
        if nmod == 1:
            return cls(etal, etar, etaa, expn)
        etal = np.tile(etal, nmod)
        etar = np.tile(etar, nmod)
        etaa = np.tile(etaa, nmod)
        expn = np.tile(expn, nmod)
        mode = np.repeat(np.arange(nmod), npsd + 1)
        return cls(etal, etar, etaa, expn, mode)


Bath = DEOMBath


def _apply_action(op, X, lcr, transpose=False):
    """A system operator lifted onto every ADO of X (..., nado, n, n),
    block by block: ``op @ rho`` ('l'), ``rho @ op`` ('r'), their
    difference ('c'); with ``transpose`` the action of the transposed
    lift (the operator transposed). Equals ``_action(op, nado, lcr)``
    (or its transpose) on the row-major flattened X."""
    if transpose:
        op = op.transpose(-2, -1)
    if lcr == "l":
        return op @ X
    if lcr == "r":
        return X @ op
    if lcr == "c":
        return op @ X - X @ op
    raise ValueError(lcr)


def _gmres(A, b, tol, maxiter, restart=20):
    """Restarted GMRES for a block of independent systems A(x)_i = b_i,
    the rows of b (B, N); A maps (B, N) to (B, N). Follows
    ``jax.scipy.sparse.linalg.gmres(solve_method='batched')``: x0 = 0,
    ``restart`` Arnoldi steps (classical Gram-Schmidt, twice) and one
    small least-squares solve per restart, ``maxiter`` restarts at most,
    a system done once its true residual ||b - A x|| <= tol ||b||. A
    system that is done is no longer updated.

    Returns (x, restarts (B,), relative residuals (B,)); raises
    RuntimeError if a system has not converged after ``maxiter``
    restarts."""
    B, N = b.shape
    m = min(restart, N)
    dev, dt = b.device, b.dtype
    eps = torch.finfo(dt).eps
    bnorm = torch.linalg.vector_norm(b, dim=1)
    atol = tol * bnorm
    x = torch.zeros_like(b)
    r = b.clone()
    rnorm = bnorm.clone()
    restarts = torch.zeros(B, dtype=torch.long, device=dev)
    eye_rows = torch.eye(m, m + 1, dtype=dt, device=dev)
    for _ in range(maxiter):
        active = rnorm > atol
        if not bool(active.any()):
            break
        V = torch.zeros((B, m + 1, N), dtype=dt, device=dev)
        V[:, 0] = torch.where(rnorm[:, None] > eps, r / rnorm[:, None], 0)
        Ht = eye_rows.expand(B, m, m + 1).clone()     # H transposed
        broken = torch.zeros(B, dtype=torch.bool, device=dev)
        for k in range(m):
            w = A(V[:, k])
            wnorm0 = torch.linalg.vector_norm(w, dim=1)
            h = torch.zeros((B, m + 1), dtype=dt, device=dev)
            for _ in range(2):                      # classical GS, twice
                c = torch.einsum("bjn, bn -> bj", V[:, :k + 1].conj(), w)
                w = w - torch.einsum("bjn, bj -> bn", V[:, :k + 1], c)
                h[:, :k + 1] += c
            wnorm = torch.linalg.vector_norm(w, dim=1)
            ok = wnorm > eps * wnorm0
            V[:, k + 1] = torch.where(ok[:, None], w / wnorm[:, None], 0)
            h[:, k + 1] = torch.where(ok, wnorm, 0).to(dt)
            Ht[:, k] = torch.where(broken[:, None], Ht[:, k], h)
            broken = broken | ~ok
        beta = torch.zeros((B, m + 1, 1), dtype=dt)
        beta[:, 0, 0] = rnorm.cpu().to(dt)
        y = torch.linalg.lstsq(Ht.transpose(1, 2).cpu(),
                               beta).solution.to(dev)
        dx = torch.einsum("bjn, bj -> bn", V[:, :m], y[..., 0])
        x = torch.where(active[:, None], x + dx, x)
        r = b - A(x)
        rnorm = torch.linalg.vector_norm(r, dim=1)
        restarts = restarts + active.long()
    rel = rnorm / torch.where(bnorm > 0, bnorm, 1.0)
    if bool((rnorm > atol).any()):
        worst = float(rel.max())
        raise RuntimeError(
            f"GMRES did not converge in {maxiter} restarts of {m}: relative "
            f"residual {worst:.3e} > tol {tol:g}")
    return x, restarts, rel


class DEOMSolver:
    """(reference: pyqed/heom/deom.py:953).

    Operators are kept on the host as complex128 NumPy arrays and moved
    to ``device`` (the card when None, which raises without one) when a
    right-hand side is built. Pulse functions are Python callables of a
    float ``t``."""

    def __init__(self, system=None, system_dipole=None, bath: DEOMBath = None,
                 coupling=None, coupling_dipole=None,
                 pulse_system_func: Optional[Callable] = None,
                 pulse_coupling_func: Optional[Callable] = None, lmax=None,
                 device=None):
        self.device = resolve_device(device)
        self.system = _host(system) if system is not None else None
        self.system_dipole = (_host(system_dipole)
                              if system_dipole is not None else None)
        self.bath = bath
        coupling = _host(coupling) if coupling is not None else None
        if coupling is not None and coupling.ndim == 2:
            coupling = coupling[None]
        self.coupling = coupling
        self.coupling_dipole = (_host(coupling_dipole)
                                if coupling_dipole is not None else None)
        self.pulse_system_func = pulse_system_func
        self.pulse_coupling_func = pulse_coupling_func
        self.lmax = lmax
        self.propagator = None
        self._eig = None
        self.gmres_stats = None

    # ------------------------------------------------------------- plumbing
    def set_hierarchy(self, lmax):
        self.lmax = lmax

    def set_system(self, system):
        self.system = _host(system)

    def set_coupling(self, coupling):
        c = _host(coupling)
        self.coupling = c[None] if c.ndim == 2 else c

    def set_system_dipole(self, system_dipole):
        """(reference: pyqed/heom/deom.py set_system_dipole)."""
        self.system_dipole = _host(system_dipole)

    def set_coupling_dipole(self, coupling_dipole):
        self.coupling_dipole = _host(coupling_dipole)

    def set_pulse_system_func(self, fn):
        """Time-dependent drive on the system: H(t) = H + f(t) * mu_sys
        (reference: pyqed/heom/deom.py)."""
        self.pulse_system_func = fn

    def set_pulse_coupling_func(self, fn):
        """Time-dependent drive on the system-bath coupling:
        Q(t) = Q + f(t) * mu_cpl (reference: pyqed/heom/deom.py)."""
        self.pulse_coupling_func = fn

    def _structure(self):
        nind = len(self.bath.expn)
        keys, index = enumerate_hierarchy(nind, self.lmax)
        plus_idx, minus_idx = neighbor_maps(keys, index)
        return keys, plus_idx, minus_idx

    def _coeffs(self, keys):
        """Static RHS coefficient arrays for the scaled convention."""
        b = self.bath
        k = keys.astype(float)
        sq_n = np.sqrt(k)
        sq_np1 = np.sqrt(k + 1.0)
        etaa = np.where(np.abs(b.etaa) > 0, b.etaa, 1.0)
        cm_l = sq_n / np.sqrt(etaa)[None, :] * b.etal[None, :]
        cm_r = sq_n / np.sqrt(etaa)[None, :] * b.etar[None, :]
        cp = sq_np1 * np.sqrt(etaa)[None, :]
        damp = keys @ b.expn
        return damp, cm_l, cm_r, cp

    def _gather_plan(self, transpose):
        """Neighbour indices (nado, 2 nind) into the zero-padded ADO stack
        and the left/right weights of each neighbour.

        Forward, ADO N reads its plus neighbours (weight cp) and its minus
        neighbours (weights cm_l, cm_r). The transpose (d/dt = Delta^T,
        for the bilinear pairing sum_i u_i v_i) sends each edge the other
        way: ADO M receives from N = M - e_k the plus edge of N (weight
        cp[N, k]) and from N = M + e_k the minus edge of N (weights
        cm[N, k]), so it is again a gather, over [minus; plus]."""
        keys, plus_idx, minus_idx = self._structure()
        damp, cm_l, cm_r, cp = self._coeffs(keys)
        if not transpose:
            idx = np.concatenate([plus_idx, minus_idx], axis=1)
            wl = np.concatenate([cp, cm_l], axis=1)
            wr = np.concatenate([cp, cm_r], axis=1)
            return keys, damp, idx, wl, wr

        def at(w, src):
            # w[src[M, k], k], zero where src is the padding row
            cols = np.arange(w.shape[1])[None, :]
            wpad = np.concatenate([w, np.zeros((1, w.shape[1]), w.dtype)])
            return wpad[src, cols]

        idx = np.concatenate([minus_idx, plus_idx], axis=1)
        wl = np.concatenate([at(cp, minus_idx), at(cm_l, plus_idx)], axis=1)
        wr = np.concatenate([at(cp, minus_idx), at(cm_r, plus_idx)], axis=1)
        return keys, damp, idx, wl, wr

    def _rhs(self, dtype, transpose=False):
        """The right-hand side d/dt = Delta (or, with ``transpose``, the
        plain transpose Delta^T, no conjugation), nado and n."""
        keys, damp, idx, wl, wr = self._gather_plan(transpose)
        dev = self.device

        def mats(a):
            # operators (or stacks of them), each transposed for Delta^T
            a = np.swapaxes(a, -1, -2) if transpose else a
            return torch.as_tensor(a, dtype=dtype, device=dev)

        H = mats(self.system)
        mode = self.bath.mode
        Qk = mats(self.coupling[mode])                 # (nind, n, n)
        n = H.shape[0]
        nado = keys.shape[0]
        damp = torch.as_tensor(damp, dtype=dtype, device=dev)[:, None, None]
        idx = torch.as_tensor(idx, dtype=torch.long, device=dev)
        wl = torch.as_tensor(wl, dtype=dtype, device=dev)[:, :, None, None]
        wr = torch.as_tensor(wr, dtype=dtype, device=dev)[:, :, None, None]

        Hd = (mats(self.system_dipole) if self.system_dipole is not None
              else None)
        Qd = (mats(self.coupling_dipole[mode])
              if self.coupling_dipole is not None else None)
        psys = self.pulse_system_func if Hd is not None else None
        pcpl = self.pulse_coupling_func if Qd is not None else None
        Q2 = torch.cat([Qk, Qk])

        def rhs(ados, t=0.0):
            Ht = H if psys is None else H + psys(t) * Hd
            Qt2 = Q2
            if pcpl is not None:
                Qt = Qk + pcpl(t) * Qd
                Qt2 = torch.cat([Qt, Qt])
            pad = ados.new_zeros(ados.shape[:-3] + (1, n, n))
            padded = torch.cat([ados, pad], dim=-3)
            out = -1j * (Ht @ ados - ados @ Ht)
            out = out - damp * ados
            g = padded[..., idx, :, :]             # (..., nado, 2 nind, n, n)
            out = out - 1j * (torch.einsum("kab, ...Nkbc -> ...Nac", Qt2,
                                           wl * g)
                              - torch.einsum("...Nkab, kbc -> ...Nac",
                                             wr * g, Qt2))
            return out

        return rhs, nado, n

    def rhs_fn(self, dtype=torch.complex128):
        """The hierarchy right-hand side ``rhs(ados, t=0.0)`` on
        (..., nado, n, n) (any leading batch dimensions), nado and n."""
        return self._rhs(dtype)

    # ------------------------------------------------------------------ run
    def run(self, rho0, dt, nt, p1=None, nout=1) -> Result:
        """(reference: pyqed/heom/deom.py:1072). RK4 for ``nt`` steps of
        ``dt`` from ``rho0`` in the root ADO, at complex128; records
        Tr[p1 rho] (Tr rho without p1) and rho after each window of
        ``nout`` steps. Returns a Result with the rho_0(t) trajectory."""
        rhs, nado, n = self.rhs_fn(torch.complex128)
        dev = self.device
        rho0 = torch.as_tensor(_host(rho0), dtype=torch.complex128,
                               device=dev)
        ados = torch.zeros((nado, n, n), dtype=rho0.dtype, device=dev)
        ados[0] = rho0
        p1t = (torch.as_tensor(_host(p1), dtype=rho0.dtype, device=dev)
               if p1 is not None else None)

        def observe(rho):
            return torch.trace(p1t @ rho) if p1t is not None else \
                torch.trace(rho)

        ns = nt // nout
        obs = torch.empty((ns + 1, 1), dtype=rho0.dtype, device=dev)
        states = torch.empty((ns + 1, n, n), dtype=rho0.dtype, device=dev)
        obs[0, 0] = observe(rho0)
        states[0] = rho0
        step = rk4_step_t(rhs)
        t = 0.0
        for w in range(1, ns + 1):
            for _ in range(nout):
                ados = step(ados, t, dt)
                t = t + dt
            obs[w, 0] = observe(ados[0])
            states[w] = ados[0]
        res = Result(
            times=torch.arange(ns + 1, dtype=torch.float64, device=dev)
            * dt * nout, dt=dt, nt=nt, nout=nout)
        res.observables = obs
        res.states = states
        res.rho0 = rho0
        res.rho = ados[0]
        res.ado = ados
        return res

    # ------------------------------------------- dense hierarchy Liouvillian
    def gen_propagator(self):
        """Dense hierarchy Liouvillian Delta with d vec(ados)/dt = Delta vec
        (reference: pyqed/heom/deom.py:1116 ``gen_generate_propgator``),
        built on the host: a (nado n^2)^2 complex128 CPU tensor, for small
        hierarchies only."""
        keys, plus_idx, minus_idx = self._structure()
        damp, cm_l, cm_r, cp = self._coeffs(keys)
        H = self.system
        Q = self.coupling[self.bath.mode]   # (nind, n, n)
        n = H.shape[0]
        nado, nind = keys.shape
        n2 = n * n
        N = nado * n2
        I = np.eye(n)
        Lsys = -1j * (np.kron(H, I) - np.kron(I, H.T))
        LQ = [np.kron(Q[k], I) for k in range(nind)]
        RQ = [np.kron(I, Q[k].T) for k in range(nind)]

        M = np.zeros((N, N), dtype=complex)
        for a in range(nado):
            sl = slice(a * n2, (a + 1) * n2)
            M[sl, sl] = Lsys - damp[a] * np.eye(n2)
            for k in range(nind):
                up = plus_idx[a, k]
                if up < nado:
                    slu = slice(up * n2, (up + 1) * n2)
                    M[sl, slu] += -1j * cp[a, k] * (LQ[k] - RQ[k])
                dn_ = minus_idx[a, k]
                if dn_ < nado and keys[a, k] > 0:
                    sld = slice(dn_ * n2, (dn_ + 1) * n2)
                    M[sl, sld] += -1j * (cm_l[a, k] * LQ[k]
                                         - cm_r[a, k] * RQ[k])
        self.propagator = torch.from_numpy(M)
        self._nado, self._n = nado, n
        return self.propagator

    def _ensure_eig(self):
        """Eigenvalues, right eigenvectors and their pseudo-inverse of the
        dense Liouvillian: a non-Hermitian eig on the host (SciPy), as in
        the JAX package, moved to the device."""
        import scipy.linalg
        if self.propagator is None:
            self.gen_propagator()
        if self._eig is None:
            w, V = scipy.linalg.eig(self.propagator.numpy())
            Vinv = scipy.linalg.pinv(V)
            self._eig = tuple(torch.as_tensor(a, device=self.device)
                              for a in (w, V, Vinv))
        return self._eig

    @staticmethod
    def _action(op, nado, lcr="l"):
        """Block-diagonal lift of a system operator onto the hierarchy
        (reference: pyqed/heom/deom.py ``generate_actions``): the dense
        (nado n^2)^2 matrix as a CPU tensor, for small hierarchies
        (:func:`_apply_action` applies it block by block)."""
        op = torch.as_tensor(_host(op))
        n = op.shape[0]
        I = torch.eye(n, dtype=op.dtype)
        if lcr == "l":
            blk = torch.kron(op, I)
        elif lcr == "r":
            blk = torch.kron(I, op.T.contiguous())
        elif lcr == "c":
            blk = torch.kron(op, I) - torch.kron(I, op.T.contiguous())
        else:
            raise ValueError(lcr)
        return torch.kron(torch.eye(nado, dtype=op.dtype), blk)

    def correlation_4op_3t(self, a, b, c, d, rho0, T, w_x, w_y, lcr="llll"):
        """Frequency-domain third-order response map
        (reference: pyqed/heom/deom.py:1127):

        S(wx, wy) = Tr[ D G(wx) C e^{Delta T} B G(wy) A rho0 ]_{system block}

        with G(w) = (-Delta - i w)^{-1} evaluated by one host eig of the
        dense Liouvillian and products over the (wx, wy) grid on the
        device (replacing the reference's double Python loop at
        :1183-1190)."""
        w, V, Vinv = self._ensure_eig()
        nado, n = self._nado, self._n
        n2 = n * n
        dev, cdt = self.device, V.dtype

        def act(op, k):
            return self._action(op, nado, lcr[k]).to(dev, cdt)

        A_a, A_b, A_c, A_d = (act(op, k) for k, op in enumerate((a, b, c, d)))
        rho = torch.zeros(nado * n2, dtype=cdt, device=dev)
        rho[:n2] = torch.as_tensor(_host(rho0).reshape(-1), dtype=cdt,
                                   device=dev)
        wx = torch.as_tensor(_host(w_x), device=dev)
        wy = torch.as_tensor(_host(w_y), device=dev)

        q = Vinv @ (A_a @ rho)                       # in the eigenbasis
        M = (Vinv @ A_c @ V) @ (torch.exp(w * T)[:, None] * (Vinv @ A_b @ V))
        RY = 1.0 / (-w[:, None] - 1j * wy[None, :])  # (N, ny)
        RX = 1.0 / (-w[:, None] - 1j * wx[None, :])  # (N, nx)
        U = M @ (RY * q[:, None])                    # (N, ny)
        tvec = torch.zeros(nado * n2, dtype=cdt, device=dev)
        tvec[:n2] = torch.eye(n, dtype=cdt, device=dev).reshape(-1)
        u_left = tvec @ (A_d @ V)                    # (N,)
        return (u_left[:, None] * RX).T @ U

    def correlation_4op_3t_gmres(self, a, b, c, d, rho0, T, w_x, w_y,
                                 lcr="llll", tol=1e-8, maxiter=400,
                                 nt_T=None):
        """Matrix-free variant of the 2DES response map: the resolvents as
        batched GMRES solves on the device, all frequencies of a grid at
        once, against the hierarchy right-hand side (G(wy)) and its
        transpose (the left solves of G(wx): the trace pairing is
        bilinear, so they need Delta^T, not the adjoint). No dense
        (nado n^2)^2 Liouvillian or action and no host eig: every system
        operator is applied ADO by ADO (:func:`_apply_action`).

        The middle e^{Delta T} factor is real-time propagation (RK4 over
        nt_T steps) of the whole w_y block at once. Each solve stops at
        ||b - A x|| <= tol ||b|| and raises if it does not get there in
        ``maxiter`` restarts of 20; the restarts and the relative
        residuals, recomputed through the right-hand side after each
        solve, are kept in ``self.gmres_stats``."""
        dt = torch.complex128
        dev = self.device
        rhs, nado, n = self.rhs_fn(dt)
        rhs_T, _, _ = self._rhs(dt, transpose=True)
        N = nado * n * n
        ops = [torch.as_tensor(_host(op), dtype=dt, device=dev)
               for op in (a, b, c, d)]
        wx = torch.as_tensor(_host(w_x), dtype=dt, device=dev)
        wy = torch.as_tensor(_host(w_y), dtype=dt, device=dev)

        rho = torch.zeros((nado, n, n), dtype=dt, device=dev)
        rho[0] = torch.as_tensor(_host(rho0), dtype=dt, device=dev)
        q = _apply_action(ops[0], rho, lcr[0]).reshape(N)

        def resolvent_op(L, w):
            # v -> (-L - i w) v for a block of vectors, one w per row
            def A(v):
                return (-L(v.reshape(-1, nado, n, n)).reshape(-1, N)
                        - 1j * w[:, None] * v)
            return A

        X, it_y, rel_y = _gmres(resolvent_op(rhs, wy),
                                q.expand(len(wy), N).contiguous(), tol,
                                maxiter)
        X = _apply_action(ops[1], X.reshape(-1, nado, n, n), lcr[1])

        # e^{Delta T}: march the whole block in real time
        if nt_T is None:
            nt_T = max(10, int(20 * abs(T)) or 10)
        dtT = T / nt_T
        step = rk4_step(rhs)       # the drives, if any, held at t = 0
        for _ in range(nt_T):
            X = step(X, 0.0, dtT)
        Z = _apply_action(ops[2], X, lcr[2]).reshape(-1, N)   # (ny, N)

        # u^T = tvec^T A_d  <=>  u = A_d^T tvec, applied block by block
        tvec = torch.zeros((nado, n, n), dtype=dt, device=dev)
        tvec[0] = torch.eye(n, dtype=dt, device=dev)
        u = _apply_action(ops[3], tvec, lcr[3], transpose=True).reshape(N)

        # g^T = u^T (-Delta - i wx)^{-1}  <=>  (-Delta^T - i wx) g = u
        G, it_x, rel_x = _gmres(resolvent_op(rhs_T, wx),
                                u.expand(len(wx), N).contiguous(), tol,
                                maxiter)
        self.gmres_stats = dict(restarts_y=it_y, residual_y=rel_y,
                                restarts_x=it_x, residual_x=rel_x)
        # S[x, y] = sum_k G[x, k] Z[y, k]  (bilinear trace pairing)
        return G @ Z.T


def _host(a):
    """A complex128 NumPy copy of an array, tensor or number."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=complex)

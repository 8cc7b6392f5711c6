"""Lindblad quantum master equation solvers in PyTorch.

PyTorch counterpart of ``pyqed_tpu/open/lindblad.py`` (reference:
pyqed/oqs.py — ``LindbladSolver:1114``, ``_lindblad:1596``,
``_lindblad_driven:1699``, ``steady_state:1146``; pyqed/superoperator.py —
``Lindblad_solver:455`` eigendecomposition path).

- :class:`LindbladSolver` steps the matrix-free Liouvillian with RK4. For a
  time-independent H the right-hand side is ``ops.kernels.
  liouvillian_matvec``, whose commutator −i(H_eff ρ − ρ H_eff†) runs on the
  hand-written CUDA kernel on the card (``kernel=None``/``'cuda'``, alias
  ``'pallas'``: four launches per step); ``kernel='matmul'`` keeps the JAX
  solver's own ``liouvillian_action`` form. The two are the same
  Liouvillian and differ only by rounding.
- :class:`LiouvilleSolver` diagonalises the dense N² x N² Liouvillian once
  on the host (SciPy), then evaluates every time or frequency quantity as
  a contraction on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import complex_dtype_for, resolve_device
from ..core.dynamics import run_solver, rk4_step, rk4_step_t, expect_dm
from ..core.result import Result
from ..ops.kernels import liouvillian_matvec
from ..ops.linalg import as_tensor, dag
from ..ops.superoperator import liouvillian, liouvillian_action, dm2vec, left

KERNELS = ("cuda", "matmul")


def _kernel_name(kernel):
    """Validate a kernel name; ``pallas`` is an alias of ``cuda``."""
    if kernel is None or kernel == "pallas":
        return "cuda"
    if kernel not in KERNELS:
        raise ValueError(f"unknown Lindblad kernel {kernel!r}; expected one "
                         f"of {KERNELS} or 'pallas'")
    return kernel


class LindbladSolver:
    """Time-domain Lindblad QME solver (reference: pyqed/oqs.py:1114).

    ``H`` is a matrix, or the QuTiP-style list [H0, [H1, f1], ...] for
    H(t) = H0 − Σ f_k(t) H_k. ``kernel`` chooses the implementation of the
    time-independent right-hand side: None or ``'cuda'`` (alias
    ``'pallas'``) for ``liouvillian_matvec`` with the commutator kernel,
    ``'matmul'`` for ``liouvillian_action``. ``device``: the card
    (``cuda``) when None, which raises without one; ``"cpu"`` on request.
    """

    def __init__(self, H=None, c_ops=None, e_ops=None, kernel=None,
                 device=None):
        self.H = H
        self.c_ops = c_ops
        self.e_ops = e_ops
        self.kernel = _kernel_name(kernel)
        self.device = resolve_device(device)

    def setH(self, H):
        self.H = H

    def set_c_ops(self, c_ops):
        self.c_ops = c_ops

    def set_e_ops(self, e_ops):
        self.e_ops = e_ops

    def configure(self, c_ops, e_ops):
        self.c_ops = c_ops
        self.e_ops = e_ops

    def _ops(self, dtype):
        return [as_tensor(c, dtype, self.device) for c in (self.c_ops or [])]

    def liouvillian(self):
        """The dense N² x N² Liouvillian on the solver's device, complex
        of the widest dtype among H and the c_ops."""
        return liouvillian(as_tensor(self.H, device=self.device),
                           self._ops(None))

    def _rho0(self, rho0):
        """rho0 on the solver's device as a dense complex tensor (the
        kernel takes no strided, conjugate or negative views)."""
        rho0 = as_tensor(rho0, device=self.device)
        rho0 = rho0.to(complex_dtype_for(rho0))
        return rho0.resolve_conj().resolve_neg().contiguous()

    # ------------------------------------------------------------------ run
    def run(self, rho0, dt, Nt=None, t0=0.0, e_ops=None, nout=1,
            store_states=False, method="rk4", nt=None) -> Result:
        """Propagate rho(t) with RK4, sampling ``e_ops`` every ``nout``
        steps (``Nt`` a multiple of ``nout``).

        method='propagator' (time-independent H only): build the dense
        Liouvillian once, form the RK4 step polynomial
        M = Σ_{k<=4} (L dt)^k / k! (the same stepping as method='rk4'),
        raise it to the power nout, and advance one matvec per
        observation window."""
        if Nt is None:
            Nt = nt
        if Nt is None:
            raise TypeError("run() needs Nt (or nt)")
        if e_ops is None:
            e_ops = self.e_ops
        timedep = isinstance(self.H, (list, tuple))
        if method == "propagator" and not timedep:
            return self._run_propagator(rho0, dt, Nt, t0=t0, e_ops=e_ops,
                                        nout=nout,
                                        store_states=store_states)
        rho0 = self._rho0(rho0)
        cdtype = rho0.dtype
        dev = self.device
        c_ops = self._ops(cdtype)

        if timedep:
            H0 = as_tensor(self.H[0], cdtype, dev)
            drives = [(as_tensor(term[0], cdtype, dev), term[1])
                      for term in self.H[1:]]
            cdags = [dag(c) for c in c_ops]
            ldls = [cd @ c for c, cd in zip(c_ops, cdags)]

            def rhs(rho, t):
                Ht = H0
                for (H1, f) in drives:
                    Ht = Ht - f(t) * H1
                out = -1j * (Ht @ rho - rho @ Ht)
                for c, cd, ldl in zip(c_ops, cdags, ldls):
                    out = out + c @ rho @ cd - 0.5 * (ldl @ rho + rho @ ldl)
                return out

            step = rk4_step_t(rhs)
        else:
            H = as_tensor(self.H, cdtype, dev)
            if self.kernel == "cuda":
                L = liouvillian_matvec(H, c_ops, use_kernel=True)
            else:
                L = liouvillian_action(H, c_ops)
            step = rk4_step(L)

        def stepper(y, t):
            return step(y, t, dt)

        return run_solver(stepper, rho0, dt, Nt, e_ops=e_ops, nout=nout,
                          t0=t0, store_states=store_states, is_dm=True)

    evolve = run

    def _run_propagator(self, rho0, dt, Nt, t0=0.0, e_ops=None, nout=1,
                        store_states=False) -> Result:
        """As the JAX package's: no initial row in ``states``, and
        ``observables`` is (Nt // nout, 0) without e_ops."""
        rho0 = self._rho0(rho0)
        cdtype = rho0.dtype
        dev = self.device
        n = rho0.shape[0]
        eops = [as_tensor(e, cdtype, dev) for e in (e_ops or [])]
        ns = Nt // nout
        X = self.liouvillian().to(cdtype) * dt
        M = torch.eye(n * n, dtype=cdtype, device=dev)
        term = torch.eye(n * n, dtype=cdtype, device=dev)
        for k in range(1, 5):
            term = (term @ X) / k
            M = M + term
        Mk = torch.linalg.matrix_power(M, nout)

        E = torch.stack(eops) if eops else None
        obs = torch.empty((ns + 1 if eops else ns, len(eops)), dtype=cdtype,
                          device=dev)
        states = (torch.empty((ns, n, n), dtype=cdtype, device=dev)
                  if store_states else None)
        if eops:
            obs[0] = expect_dm(E, rho0)
        v = rho0.reshape(-1)
        for w in range(1, ns + 1):
            v = Mk @ v
            if eops:
                obs[w] = expect_dm(E, v.reshape(n, n))
            if states is not None:
                states[w - 1] = v.reshape(n, n)
        r = Result(dt=dt, nt=Nt, nout=nout,
                   times=t0 + dt * nout * torch.arange(
                       ns + 1, dtype=torch.float64, device=dev))
        r.rho = v.reshape(n, n)
        r.observables = obs
        if store_states:
            r.states = states
        return r

    # --------------------------------------------------------- steady state
    def steady_state(self):
        """Null vector of the dense Liouvillian (host SVD), Hermitised and
        normalized to unit trace, on the solver's device."""
        L = self.liouvillian().cpu().numpy()
        n = int(round(np.sqrt(L.shape[0])))
        _, s, Vh = np.linalg.svd(L)
        rho = Vh[-1].conj().reshape(n, n)
        rho = (rho + rho.conj().T) / 2
        return torch.as_tensor(rho / np.trace(rho), device=self.device)

    # --------------------------------------------------- correlation suite
    def _seed(self, rho0, ops):
        rho0 = self._rho0(rho0)
        return rho0, [as_tensor(o, rho0.dtype, self.device) for o in ops]

    def correlation_3op_1t(self, rho0, oplist, dt=0.005, Nt=1):
        """<A B(t) C> = Tr[B U(t)(C rho0 A)]
        (reference: pyqed/oqs.py:1225)."""
        rho0, (a_op, b_op, c_op) = self._seed(rho0, oplist)
        res = self.run(c_op @ rho0 @ a_op, dt=dt, Nt=Nt, e_ops=[b_op])
        return res.observables[:, 0]

    def correlation_2op_1t(self, rho0, a_op, b_op, dt, Nt):
        """<A(t) B> (reference: pyqed/oqs.py:1195)."""
        eye = np.eye(np.shape(rho0)[0])
        return self.correlation_3op_1t(rho0, [eye, a_op, b_op], dt=dt, Nt=Nt)

    def correlation_4op_1t(self, rho0, oplist, dt=0.005, Nt=1):
        a, b, c, d = self._seed(rho0, oplist)[1]
        return self.correlation_3op_1t(rho0, [a, b @ c, d], dt=dt, Nt=Nt)

    def correlation_3op_2t(self, rho0, ops, dt, Nt, Ntau):
        """<A(t) B(t+tau) C(t)> (reference: pyqed/oqs.py:1264): one run
        stores rho(t), then each seed C rho(t) A is propagated along tau
        in turn (the JAX package maps over the seeds sequentially too)."""
        rho0, (a_op, b_op, c_op) = self._seed(rho0, ops)
        rho_t = self.run(rho0, dt=dt, Nt=Nt, store_states=True).states[:Nt]
        return torch.stack([
            self.run(c_op @ rho @ a_op, dt=dt, Nt=Ntau,
                     e_ops=[b_op]).observables[:Ntau, 0]
            for rho in rho_t])

    def correlation_4op_2t(self, rho0, ops, dt, nt, ntau):
        a, b, c, d = self._seed(rho0, ops)[1]
        return self.correlation_3op_2t(rho0, [a, b @ c, d], dt, nt, ntau)


class LiouvilleSolver:
    """Liouville-space solver by diagonalization of L
    (reference: pyqed/superoperator.py:455 ``Lindblad_solver``).

    The non-Hermitian eig runs once on the host (SciPy LAPACK); every
    time- or frequency-domain quantity after it is a batched contraction
    over eigenmodes on ``device`` (the card when None, which raises
    without one; ``"cpu"`` on request).
    """

    def __init__(self, H, c_ops=None, device=None):
        self.device = resolve_device(device)
        self.H = H
        self.c_ops = c_ops
        self.n = np.shape(H)[-1]
        self.dim = self.n ** 2
        self.L = None
        self.eigvals = None
        self.right_eigvecs = None
        self.left_eigvecs = None
        self.norm = None
        self.idv = dm2vec(torch.eye(self.n, dtype=torch.complex128,
                                    device=self.device))

    def liouvillian(self):
        self.L = liouvillian(as_tensor(self.H), [
            as_tensor(c) for c in (self.c_ops or [])]).to(self.device)
        return self.L

    def eigenstates(self):
        import scipy.linalg
        if self.L is None:
            self.liouvillian()
        w, vl, vr = scipy.linalg.eig(self.L.cpu().numpy(), left=True,
                                     right=True)
        dev = self.device
        self.eigvals = torch.as_tensor(w, device=dev)
        self.left_eigvecs = torch.as_tensor(vl, device=dev)
        self.right_eigvecs = torch.as_tensor(vr, device=dev)
        # complex biorthogonal norm <vl_n|vr_n> (the reference truncates to
        # .real at pyqed/superoperator.py:508; kept complex, as the JAX
        # package does)
        self.norm = torch.einsum("in, in -> n", self.left_eigvecs.conj(),
                                 self.right_eigvecs)
        return w, vr, vl

    def _ensure_eig(self):
        if self.eigvals is None:
            self.eigenstates()

    def _op(self, o):
        return as_tensor(o, self.eigvals.dtype, self.device)

    def _idv(self):
        return self.idv.to(self.eigvals.dtype)

    def _coeff(self, lift, seed):
        """<<I| lift U1_n>> <U2_n|seed>> / norm_n over the modes n."""
        rv = dm2vec(seed)
        return (torch.einsum("i, in -> n", self._idv().conj(),
                             lift @ self.right_eigvecs)
                * torch.einsum("in, i -> n", self.left_eigvecs.conj(), rv)
                / self.norm)

    def _times(self, t):
        return as_tensor(t, self.eigvals.dtype, self.device)

    def evolve(self, rho0, tlist, e_ops) -> Result:
        """rho(t) = sum_n U1_n e^{lambda_n t} <U2_n|rho0>/norm_n
        (reference: pyqed/superoperator.py:524)."""
        self._ensure_eig()
        tl = self._times(tlist)
        rv = dm2vec(self._op(rho0))
        coeff = torch.einsum("in, i -> n", self.left_eigvecs.conj(),
                             rv) / self.norm
        modes = torch.exp(torch.outer(tl, self.eigvals))          # (T, n2)
        rho_t = torch.einsum("tn, n, in -> ti", modes, coeff,
                             self.right_eigvecs)
        # Tr[op rho] = <vec(op^dag), vec(rho)> for all ops/times at once
        bras = torch.stack([dm2vec(dag(self._op(op))).conj()
                            for op in e_ops])
        obs = torch.einsum("ki, ti -> tk", bras, rho_t)
        return Result(times=as_tensor(tlist, torch.float64, self.device),
                      observables=obs)

    def correlation_2op_1t(self, rho0, ops, tlist):
        """<A(t) B> (reference: pyqed/superoperator.py:565)."""
        self._ensure_eig()
        a, b = [self._op(o) for o in ops]
        coeff = self._coeff(left(a), b @ self._op(rho0))
        return torch.exp(torch.outer(self._times(tlist), self.eigvals)) @ coeff

    def _resolvent_sum(self, coeff, w):
        W = -1.0 / (self.eigvals[None, :] + 1j * self._times(w)[:, None])
        return W @ coeff

    def correlation_2op_1w(self, rho0, ops, w):
        """S(w) = int_0^inf <A(t)B> e^{iwt} dt
        (reference: pyqed/superoperator.py:603)."""
        self._ensure_eig()
        a, b = [self._op(o) for o in ops]
        return self._resolvent_sum(self._coeff(left(a), b @ self._op(rho0)),
                                   w)

    def correlation_3op_1t(self, rho0, ops, t):
        """<...> with seed C rho0 A (reference: pyqed/superoperator.py:638)."""
        self._ensure_eig()
        a, b, c = [self._op(o) for o in ops]
        coeff = self._coeff(left(b), c @ self._op(rho0) @ a)
        return torch.exp(torch.outer(self._times(t), self.eigvals)) @ coeff

    def correlation_3op_1w(self, rho0, ops, w):
        self._ensure_eig()
        a, b, c = [self._op(o) for o in ops]
        return self._resolvent_sum(
            self._coeff(left(b), c @ self._op(rho0) @ a), w)

    def correlation_3op_2t(self, rho0, ops, tlist, taulist):
        """<A(t) B(t+tau) C(t)> via the double eigenmode contraction
        (reference: pyqed/superoperator.py:702-751)."""
        from ..ops.superoperator import right
        self._ensure_eig()
        a, b, c = [self._op(o) for o in ops]
        rv = dm2vec(self._op(rho0))
        U1, U2, norm = self.right_eigvecs, self.left_eigvecs, self.norm
        lamb = self.eigvals
        lb = torch.einsum("i, im -> m", self._idv().conj(), left(b) @ U1)
        mid = torch.einsum("im, ij, jn -> mn", U2.conj(),
                           right(a) @ left(c), U1)
        w0 = torch.einsum("in, i -> n", U2.conj(), rv) / norm
        coeff = (lb / norm)[:, None] * mid * w0[None, :]
        tmp1 = torch.exp(torch.outer(lamb, self._times(taulist)))  # (m, Ntau)
        tmp2 = torch.exp(torch.outer(lamb, self._times(tlist)))    # (n, Nt)
        return torch.einsum("mj, mn, nt -> jt", tmp1, coeff, tmp2).T

    def correlation_4op_2t(self, rho0, ops, tlist, taulist):
        self._ensure_eig()
        a, b, c, d = [self._op(o) for o in ops]
        return self.correlation_3op_2t(rho0, [a, b @ c, d], tlist, taulist)


# Reference-compatible alias (pyqed/superoperator.py:455)
Lindblad_solver = LiouvilleSolver


def driven_dissipative_dynamics(ham, dip, rho0, pulse, c_ops=(),
                                dt=0.001, Nt=1, obs_ops=None, nout=1,
                                device=None):
    """Laser-driven Lindblad dynamics, H(t) = H0 - E(t) mu (reference:
    pyqed/phys.py:1464 ``driven_dissipative_dynamics`` — an empty
    ``return`` stub there; here the time-dependent LindbladSolver).
    ``pulse`` is any object with ``efield(t)``."""
    sol = LindbladSolver([ham, [dip, pulse.efield]], c_ops=list(c_ops),
                         device=device)
    return sol.run(rho0, dt=dt, Nt=Nt, e_ops=obs_ops, nout=nout)


def absorption_eseries(omegas, L, edip, rho0, ntrans=None, device=None):
    """Absorption from the eigen-series of the Liouvillian (reference:
    pyqed/signal/liouville.py:27 — sparse ARPACK eigs there; the full
    eig on the host here, then the frequency sweep is one contraction on
    ``device``):

        S(w) = int_0^inf dt e^{i w t} Tr[mu e^{Lt}(mu rho0)]
             = - sum_n <mu, U_n> (U^{-1} mu rho0)_n / (lam_n + i w)

    with U the right eigenvectors of L (rho(t) = e^{Lt} rho0, so a
    transition at +w0 appears as Im lam = -w0 and the pole sits at
    w = w0). ``ntrans`` keeps the modes with the largest |amplitude|
    (None = all)."""
    dev = resolve_device(device)

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    L = host(L)
    lam, U = np.linalg.eig(L)
    # left eigenvectors = rows of U^{-1} (exactly biorthogonal to the
    # right ones)
    W = np.linalg.inv(U)
    mu = host(edip).flatten()
    src = (host(edip) @ host(rho0)).flatten()
    amp = (mu.conj() @ U) * (W @ src)
    if ntrans is not None:
        keep = np.argsort(-np.abs(amp))[:ntrans]
        amp, lam = amp[keep], lam[keep]
    om = torch.as_tensor(host(omegas), device=dev)
    amp = torch.as_tensor(amp, device=dev)
    lam = torch.as_tensor(lam, device=dev)
    return -torch.sum(amp[None, :] / (lam[None, :] + 1j * om[:, None]),
                      dim=1)

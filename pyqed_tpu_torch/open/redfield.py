"""Redfield quantum master equation in PyTorch.

PyTorch counterpart of ``pyqed_tpu/open/redfield.py`` (reference:
pyqed/oqs.py — ``RedfieldSolver:30``, ``redfield_tensor:519``,
``_redfield:364``, ``getG:465``, ``correlation_4op_3t:268``).

The Redfield tensor is built in the eigenbasis of H, with each bath
spectrum evaluated at all transition frequencies in one call, then
R = -i op2sop(diag(E)) - Σ_k op2sop(A_k)(left(L_k) - right(L_k†)), as in
pyqed/oqs.py:556-570. Propagation is RK4 of vec(ρ) on the device, or the
eigen-series path (host eig, device contraction).

The eigenvectors of H (and of R) are fixed only up to phases, so R and
``evecs`` may differ from the JAX package's by a change of basis; the
site-basis results (ρ, observables, the steady state) do not.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import complex_dtype_for, resolve_device
from ..core.dynamics import run_solver, rk4_step
from ..ops.linalg import as_tensor, dag, isherm, transform
from ..ops.superoperator import (operator_to_superoperator, left, right,
                                 dm2vec, vec2dm)


def redfield_tensor(H, a_ops, spectra, secular=False, sec_cutoff=1e-9,
                    device=None):
    """(R, evecs) such that d rho/dt = R rho in the eigenbasis of H
    (reference: pyqed/oqs.py:519), on ``device`` (the card when None,
    which raises without one). The eigendecomposition of H runs on the
    host: the spectra are host callables of the transition frequencies.

    ``spectra`` convention: each callable is the HALF-Fourier transform
    Gamma(w) = int_0^inf C(t) e^{iwt} dt of the bath correlation (so the
    secular population rate is 2 Re Gamma |A_ab|^2 = S(w) |A_ab|^2, and a
    complex return value carries the Lamb shift). A real-valued callable
    is Re Gamma = S(w)/2. See ``DrudeBath.redfield_spectrum``."""
    dev = resolve_device(device)
    H = as_tensor(H, device="cpu")
    cdtype = complex_dtype_for(H, *a_ops)
    for a in a_ops:
        if not isherm(as_tensor(a, device="cpu")):
            raise TypeError("Operators in a_ops must be Hermitian.")
    evals, evecs = torch.linalg.eigh(H)
    evals = evals.real
    W = (evals[:, None] - evals[None, :]).numpy()
    evecs = evecs.to(dev, cdtype)

    R = torch.zeros((H.shape[0] ** 2,) * 2, dtype=cdtype, device=dev)
    for a, spectrum in zip(a_ops, spectra):
        A = transform(as_tensor(a, cdtype, dev), evecs)
        C = as_tensor(spectrum(np.asarray(-W)), cdtype, dev)
        Lk = C * A
        R = R + operator_to_superoperator(A) @ (left(Lk) - right(dag(Lk)))

    Rtot = -1j * operator_to_superoperator(
        torch.diag(evals).to(dev, cdtype)) - R

    if secular:
        # keep only secular terms: |W_ab - W_cd| < sec_cutoff, an absolute
        # frequency threshold
        Wv = torch.as_tensor(W.reshape(-1), device=dev)
        mask = torch.abs(Wv[:, None] - Wv[None, :]) < sec_cutoff
        Rtot = torch.where(mask, Rtot, torch.zeros_like(Rtot))
    return Rtot, evecs


class RedfieldSolver:
    """(reference: pyqed/oqs.py:30). ``device``: the card (``cuda``) when
    None, which raises without one; ``"cpu"`` on request."""

    def __init__(self, H, c_ops=None, spectra=None, e_ops=None,
                 a_ops=None, sec_cutoff=None, device=None):
        self.device = resolve_device(device)
        self.H = as_tensor(H, device=self.device)
        self.c_ops = c_ops
        self.spectra = spectra
        if a_ops is not None:
            # (op, bath-or-spectrum) pairs: bath objects contribute their
            # half-Fourier Gamma(w) (DrudeBath.redfield_spectrum); bare
            # callables are used as the spectrum directly
            self.c_ops = [op for op, _ in a_ops]
            self.spectra = [b.redfield_spectrum()
                            if hasattr(b, "redfield_spectrum") else b
                            for _, b in a_ops]
        self.sec_cutoff = sec_cutoff   # not-None => secular by default
        self.R = None
        self.evecs = None
        self.dim = self.H.shape[0]
        self.U = None
        self.G = None
        self.e_ops = e_ops

    def idm(self):
        dtype = self.R.dtype if self.R is not None else torch.complex128
        return dm2vec(torch.eye(self.dim, dtype=dtype, device=self.device))

    def configure(self, H, c_ops, e_ops):
        self.H = as_tensor(H, device=self.device)
        self.c_ops, self.e_ops = c_ops, e_ops

    def redfield_tensor(self, secular=None, sec_cutoff=None):
        if self.spectra is None:
            raise TypeError("Specify the bath spectral function.")
        if sec_cutoff is None:
            sec_cutoff = self.sec_cutoff
        if secular is None:
            secular = sec_cutoff is not None
        R, evecs = redfield_tensor(
            self.H, self.c_ops, self.spectra, secular,
            sec_cutoff=1e-9 if sec_cutoff is None else sec_cutoff,
            device=self.device)
        self.R, self.evecs = R, evecs
        return R, evecs

    def _op(self, a):
        return as_tensor(a, self.R.dtype, self.device)

    def steady_state(self, secular=False):
        """Stationary state of the Redfield generator: the null vector of
        R (host SVD), Hermitised and trace-normalized, returned in the SITE
        basis (reference: pyqed/oqs.py RedfieldSolver.steady_state — a
        ``pass`` stub there)."""
        if self.R is None:
            self.redfield_tensor(secular=secular)
        R = self.R.cpu().numpy()
        n = int(round(np.sqrt(R.shape[0])))
        _, s, Vh = np.linalg.svd(R)
        rho_eig = Vh[-1].conj().reshape(n, n)
        rho_eig = (rho_eig + rho_eig.conj().T) / 2
        rho_eig = rho_eig / np.trace(rho_eig)
        U = self.evecs.cpu().numpy()
        return torch.as_tensor(U @ rho_eig @ U.conj().T, device=self.device)

    # ---------------------------------------------------------------- evolve
    def evolve(self, rho0, dt, Nt=None, e_ops=None, t0=0.0, nout=1,
               store_states=False, nt=None):
        """RK4 propagation of vec(rho) in the eigenbasis (reference:
        pyqed/oqs.py:364 ``_redfield``). Observables are transformed into
        the eigenbasis, so the expectation values refer to the original
        (site) operators; ``rho`` and ``states`` come back in the site
        basis, ``psi0`` is the initial eigenbasis vector."""
        if Nt is None:
            Nt = nt
        if self.R is None:
            self.redfield_tensor()
        R, evecs = self.R, self.evecs
        if e_ops is None:
            e_ops = self.e_ops or []
        rho0_eb = transform(self._op(rho0), evecs)
        eops_eb = [transform(self._op(e), evecs) for e in e_ops]

        v0 = dm2vec(rho0_eb)
        step = rk4_step(lambda v: R @ v)

        n = self.dim
        eops_vec = [dm2vec(dag(e)).conj() for e in eops_eb]

        def expect_fn(bras, v):
            return torch.einsum("ki, i -> k", bras, v)

        res = run_solver(lambda v, t: step(v, t, dt), v0, dt, Nt,
                         e_ops=eops_vec, nout=nout, t0=t0,
                         store_states=store_states, expect_fn=expect_fn,
                         is_dm=False)
        if store_states and res.states is not None:
            # back to the site basis, matrix form
            S = res.states.reshape(-1, n, n)
            res.states = evecs @ S @ dag(evecs)
        res.rho = evecs @ vec2dm(res.psi, n) @ dag(evecs)
        res.psi = None
        res.rho0 = as_tensor(rho0, device=self.device)
        return res

    run = evolve

    # ------------------------------------------------------------ propagator
    def propagator(self, t, method="eseries"):
        """U(t) stack over times (reference: pyqed/oqs.py:160), via host
        eig + device contraction. Returns U with shape (n2, n2, nt)."""
        import scipy.linalg
        if self.R is None:
            self.redfield_tensor()
        w, V = scipy.linalg.eig(self.R.cpu().numpy())
        Vinv = scipy.linalg.inv(V)
        dev = self.device
        w, V, Vinv = (torch.as_tensor(x, device=dev) for x in (w, V, Vinv))
        E = torch.exp(w[:, None] * as_tensor(np.atleast_1d(t), w.dtype,
                                       dev)[None, :])
        self.U = torch.einsum("aj, jk, jb -> abk", V, E, Vinv)
        self.G = -1j * self.U
        return self.U

    def gf(self, t, secular=False):
        """Green's function G(t) = -i U(t) (reference: pyqed/oqs.py:136)."""
        self.propagator(np.atleast_1d(t))
        return self.G

    def expect(self, rho0, e_ops):
        """(reference: pyqed/oqs.py:215)."""
        evecs = self.evecs
        rho0_eb = dm2vec(transform(self._op(rho0), evecs))
        eops_eb = [transform(self._op(e), evecs) for e in e_ops]
        rho_t = torch.einsum("abk, b -> ak", self.U, rho0_eb)
        return torch.stack(
            [torch.einsum("i, ik -> k", dm2vec(dag(e)).conj(), rho_t)
             for e in eops_eb], dim=-1)

    # ---------------------------------------------------- correlation funcs
    def _vec(self, rho0):
        r = self._op(rho0)
        return dm2vec(r) if r.dim() == 2 else r

    def correlation_2op_1t(self, rho0, a, b, tau):
        """<<I|a G(tau) b|rho0>> (reference: pyqed/oqs.py:246).

        a, b must already be superoperators (e.g. left(x)) or matrices in
        the eigenbasis Liouville space."""
        if self.G is None:
            self.propagator(np.atleast_1d(tau))
        seeded = torch.einsum("abk, b -> ak", self.G,
                              self._op(b) @ self._vec(rho0))
        return torch.einsum("a, ab, bk -> k", self.idm(), self._op(a), seeded)

    def correlation_4op_3t(self, rho0, oplist, signature, tau):
        """<<I| A G B G C G D |rho0>> (reference: pyqed/oqs.py:268).

        All operators must be in the eigenbasis. ``signature`` chooses the
        left/right/commutator lift per operator ('l', 'r', '-', '+').
        Returns a (nt, nt, nt) cube over (tau3, tau2, tau1).
        """
        if len(oplist) != 4:
            raise ValueError("Number of operators is not 4.")
        if self.G is None:
            self.propagator(np.atleast_1d(tau))
        A, B, C, D = [operator_to_superoperator(self._op(op), s)
                      for op, s in zip(oplist, signature)]
        G = self.G
        rho = D @ self._vec(rho0)
        tmp = torch.tensordot(G, rho, dims=([1], [0]))        # (a, k1)
        tmp = C @ tmp
        tmp = torch.tensordot(G, tmp, dims=([1], [0]))        # (a, k2, k1)
        tmp = torch.tensordot(B, tmp, dims=([1], [0]))
        tmp = torch.tensordot(G, tmp, dims=([1], [0]))        # (a, k3, k2, k1)
        return torch.einsum("a, ab, bijk -> ijk", self.idm(), A, tmp)

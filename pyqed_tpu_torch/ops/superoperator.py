"""Liouville-space (superoperator) algebra.

PyTorch counterpart of ``pyqed_tpu/ops/superoperator.py`` (reference:
pyqed/superoperator.py — ``liouvillian:29``, ``dm2vec:130``,
``operator_to_superoperator:200``, ``lindblad_dissipator:249``,
``left:256``, ``right:263``, ``kraus:272``, ``obs:313``, ``trace:316``,
``resolvent:320``).

Vectorization convention: **row-major** flatten, vec(rho)[i*N+j] =
rho[i,j], so left(a) = kron(a, I) and right(a) = kron(I, a^T), as in the
reference.

- *Dense builders* (``left``/``right``/``op2sop``/``liouvillian``) give
  the N^2 x N^2 matrix, for small N and the eigendecomposition paths.
- *Matrix-free actions* (``liouvillian_action``) return a closure
  ``L(rho) -> drho`` of N x N matrix products. The form with H_eff and
  the hand-written commutator kernel is ``ops.kernels.liouvillian_matvec``.
"""
from __future__ import annotations

import torch

from .linalg import as_tensor, dag


def _complex_common(*ops):
    """The ops as tensors of one complex dtype (the widest among them)."""
    ops = [as_tensor(o) for o in ops]
    dt = torch.complex64
    for o in ops:
        dt = torch.promote_types(dt, o.dtype)
    return [o.to(dt) for o in ops]


# ---------------------------------------------------------------- vectorize

def dm2vec(rho):
    """Flatten a density matrix to a Liouville vector (row-major;
    reference: pyqed/superoperator.py:130)."""
    return as_tensor(rho).reshape(-1)


operator_to_vector = dm2vec


def vec2dm(v, n=None):
    """Inverse of :func:`dm2vec`."""
    v = as_tensor(v)
    if n is None:
        n = int(round(v.shape[0] ** 0.5))
    return v.reshape(n, n)


vec2mat = vec2dm


def mat2vec_index(N, i, j):
    """(reference: pyqed/superoperator.py:190) — the reference uses
    column-major index math here, inconsistent with its own flatten; the
    port keeps row-major throughout, as the JAX package does."""
    return i * N + j


def vec2mat_index(N, I):
    return divmod(I, N)


# ---------------------------------------------------------------- dense form

def _eye_like(a):
    n = a.shape[-1]
    return torch.eye(n, dtype=a.dtype, device=a.device)


def left(a):
    """Left-multiplication superoperator: vec(a rho) = left(a) vec(rho)."""
    a = as_tensor(a)
    return torch.kron(a.contiguous(), _eye_like(a))


def right(a):
    """Right-multiplication superoperator: vec(rho a) = right(a) vec(rho)."""
    a = as_tensor(a)
    return torch.kron(_eye_like(a), a.transpose(-2, -1).contiguous())


def operator_to_superoperator(a, kind="commutator"):
    """Promote an operator to a superoperator
    (reference: pyqed/superoperator.py:200)."""
    if kind in ("commutator", "c", "-"):
        return left(a) - right(a)
    if kind in ("left", "l"):
        return left(a)
    if kind in ("right", "r"):
        return right(a)
    if kind in ("anticommutator", "a", "+"):
        return left(a) + right(a)
    raise ValueError(f"superoperator kind {kind!r} does not exist.")


def op2sop(a, kind="commutator"):
    return operator_to_superoperator(a, kind)


to_super = op2sop


def lindblad_dissipator(l):
    """Dense dissipator  l⊗l* − ½(l†l ⊗ I + I ⊗ (l†l)^T)
    (reference: pyqed/superoperator.py:249)."""
    l = as_tensor(l)
    ld_l = dag(l) @ l
    return (torch.kron(l, l.conj().resolve_conj())
            - 0.5 * operator_to_superoperator(ld_l, "anticommutator"))


def kraus(a):
    """Kraus superoperator for a rho a^† (reference: pyqed/superoperator.py:272)."""
    return right(dag(a)) @ left(a)


def liouvillian(H, c_ops=None):
    """Dense Liouvillian  L = −i[H, ·] + Σ D[c]
    (reference: pyqed/superoperator.py:29), complex of the widest dtype
    among H and the c_ops."""
    H, *c_ops = _complex_common(H, *(c_ops or []))
    L = -1j * operator_to_superoperator(H)
    for c in c_ops:
        L = L + lindblad_dissipator(c)
    return L


# ------------------------------------------------------------- matrix-free

def lindbladian_action(l, rho, ldl=None):
    """D[l](rho) = l rho l† − ½{l†l, rho} acting on the matrix directly
    (reference: pyqed/phys.py:985)."""
    if ldl is None:
        ldl = dag(l) @ l
    return l @ rho @ dag(l) - 0.5 * (ldl @ rho + rho @ ldl)


def liouvillian_action(H, c_ops=None):
    """Matrix-free Liouvillian: returns ``L(rho) -> drho/dt`` as a closure
    of N x N matrix products, −i[H, ρ] + Σ_c (c ρ c† − ½{c†c, ρ}).
    Equivalent to applying :func:`liouvillian` to vec(rho), at O(N^3)
    per application instead of O(N^4). H, the c_ops and rho must share
    one dtype and device."""
    c_ops = [as_tensor(c) for c in (c_ops or [])]
    cdags = [dag(c) for c in c_ops]
    ldls = [cd @ c for c, cd in zip(c_ops, cdags)]

    def L(rho):
        out = -1j * (H @ rho - rho @ H)
        for c, cd, ldl in zip(c_ops, cdags, ldls):
            out = out + c @ rho @ cd - 0.5 * (ldl @ rho + rho @ ldl)
        return out

    return L


# --------------------------------------------------------------- utilities

def obs_vec(rho_vec, a):
    """Tr[a rho] with rho as a Liouville vector
    (reference: pyqed/superoperator.py:313)."""
    rho_vec = as_tensor(rho_vec)
    bra = dm2vec(dag(a)).to(rho_vec.dtype)
    return torch.vdot(bra, rho_vec)


def trace_vec(rho_vec):
    rho_vec = as_tensor(rho_vec)
    n = int(round(rho_vec.shape[0] ** 0.5))
    eye = torch.eye(n, dtype=rho_vec.dtype, device=rho_vec.device)
    return torch.vdot(dm2vec(eye), rho_vec)


def resolvent(omega, L):
    """(omega I − L)^{-1} (reference: pyqed/superoperator.py:320)."""
    L = as_tensor(L)
    return torch.linalg.inv(omega * _eye_like(L) - L)

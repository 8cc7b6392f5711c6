"""Dense operator algebra on torch tensors.

PyTorch counterpart of ``pyqed_tpu/ops/linalg.py`` (reference:
pyqed/phys.py — ``dag:1178``, ``commutator:1156``, ``anticomm:1166``,
``tensor:630``, ``ptrace:672``, ``transform:1121``, ``obs:1266``,
``obs_dm:1257``, ``expect:51``, ``isherm:2216``, ``isunitary:2219``,
``ket2dm:994``, ``norm:1011``, ``tensor_power:1977``, ``project:1959``).

Functions take tensors (or anything ``torch.as_tensor`` accepts) and
return tensors on the device of their inputs. Binary products need both
operands in one dtype: torch does not promote inside ``@``.
"""
from __future__ import annotations

import numpy as np
import torch


def as_tensor(a, dtype=None, device=None):
    """``a`` as a tensor (a CPU tensor of its data if it is not one),
    converted to ``dtype`` and moved to ``device`` where they are given."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    if dtype is None and device is None:
        return a
    return a.to(device=device, dtype=dtype)


def dag(a):
    """Hermitian conjugate (works for kets and operators)."""
    a = as_tensor(a)
    if a.dim() == 1:
        return a.conj().resolve_conj()
    return a.mH.resolve_conj().contiguous()


dagger = dag


def commutator(A, B):
    return A @ B - B @ A


comm = commutator


def anticommutator(A, B):
    return A @ B + B @ A


anticomm = anticommutator


def tensor(*args):
    """Kronecker product of a sequence of operators (QuTiP-style).

    Accepts either ``tensor(a, b, c)`` or ``tensor([a, b, c])``.
    """
    if not args:
        raise TypeError("Requires at least one input argument")
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        qlist = args[0]
    else:
        qlist = args
    out = as_tensor(qlist[0])
    for q in qlist[1:]:
        out = torch.kron(out, as_tensor(q).contiguous())
    return out


def tensor_power(a, n: int):
    """a ⊗ a ⊗ ... ⊗ a, n times."""
    a = as_tensor(a)
    out = a
    for _ in range(n - 1):
        out = torch.kron(out, a)
    return out


def ptrace(rho, dims, which="B"):
    """Partial trace over subsystem ``which`` of a bipartite density matrix.

    Matches the reference convention (pyqed/phys.py:672): ``which='B'``
    traces out B and returns rho_A; ``which='A'`` returns rho_B.
    """
    rho = as_tensor(rho)
    dimA, dimB = dims
    if rho.shape[0] != dimA * dimB:
        raise ValueError("Size of density matrix does not match dimensions.")
    r = rho.reshape(dimA, dimB, dimA, dimB)
    if which == "B":
        return torch.einsum("injn -> ij", r)
    elif which == "A":
        return torch.einsum("inim -> nm", r)
    raise ValueError("which can only be A or B.")


def transform(A, v):
    """Unitary transform of operator A into the basis given by columns of v:
    v^† A v  (reference: pyqed/phys.py:1121)."""
    return dag(v) @ as_tensor(A) @ as_tensor(v)


basis_transform = transform


def obs(psi, a):
    """<psi| a |psi> (reference: pyqed/phys.py:1266)."""
    psi = as_tensor(psi)
    return torch.vdot(psi, as_tensor(a) @ psi)


def obs_dm(rho, a):
    """Tr[a rho] (reference: pyqed/phys.py:1257)."""
    return torch.trace(as_tensor(a) @ as_tensor(rho))


def expect(state, op):
    """Expectation value for either a ket (1d) or a density matrix (2d)."""
    state = as_tensor(state)
    if state.dim() == 1:
        return obs(state, op)
    return obs_dm(state, op)


def overlap(bra, ket):
    return torch.vdot(as_tensor(bra), as_tensor(ket))


def ket2dm(psi):
    """|psi><psi| (reference: pyqed/phys.py:994)."""
    psi = as_tensor(psi)
    return torch.outer(psi, psi.conj())


def norm(psi, dx=1.0):
    """L2 norm integral of a wavefunction (reference: pyqed/phys.py:1011)."""
    psi = as_tensor(psi)
    return (torch.vdot(psi, psi) * dx).real


def rk4(y, fun, dt, *args):
    """Classic 4th-order Runge-Kutta step (reference: pyqed/phys.py:1051)."""
    dt2 = dt / 2.0
    k1 = fun(y, *args)
    k2 = fun(y + k1 * dt2, *args)
    k3 = fun(y + k2 * dt2, *args)
    k4 = fun(y + k3 * dt, *args)
    return y + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def isherm(a, tol=1e-10):
    a = as_tensor(a)
    return bool(torch.allclose(a, dag(a), atol=tol))


def isunitary(m, tol=1e-10):
    m = as_tensor(m)
    eye = torch.eye(m.shape[0], dtype=m.dtype, device=m.device)
    return bool(torch.allclose(m @ dag(m), eye, atol=tol))


def isdiag(M, tol=0.0):
    M = as_tensor(M)
    off = M - torch.diag(torch.diagonal(M))
    return bool(torch.all(torch.abs(off) <= tol))


def project(P, a):
    """Project operator a onto subspace projector P: P a P
    (reference: pyqed/phys.py:1959)."""
    P = as_tensor(P)
    return P @ as_tensor(a) @ P


def _argsort(e):
    """Ascending order of a real or complex vector (complex: by real
    part, then imaginary part, as NumPy and JAX sort)."""
    if e.is_complex():
        idx = np.argsort(e.detach().cpu().numpy(), kind="stable")
        return torch.as_tensor(idx, device=e.device)
    return torch.argsort(e, stable=True)


def sort_eig(eigvals, eigvecs):
    """Sort an eigen-decomposition by ascending eigenvalue
    (reference: pyqed/phys.py:554)."""
    eigvals, eigvecs = as_tensor(eigvals), as_tensor(eigvecs)
    idx = _argsort(eigvals)
    return eigvals[idx], eigvecs[:, idx]


def prefix_propagators(Us):
    """All-prefix products of a stack of step propagators:
    out[i] = Us[i] @ Us[i-1] @ ... @ Us[0]. The JAX package computes them
    in log depth with ``associative_scan``; here a plain loop of matrix
    products, one per step."""
    Us = as_tensor(Us)
    out = torch.empty_like(Us)
    acc = Us[0]
    out[0] = acc
    for i in range(1, Us.shape[0]):
        acc = Us[i] @ acc
        out[i] = acc
    return out


def magnus2_propagators(H_mid, dt):
    """Batched midpoint-Magnus step propagators exp(-i H_mid[k] dt)
    via one batched Hermitian eigendecomposition (H_mid: (nt, n, n))."""
    w, V = torch.linalg.eigh(as_tensor(H_mid))
    phase = torch.exp(-1j * w * dt)
    V = V.to(phase.dtype)
    return torch.einsum("tab, tb, tcb -> tac", V, phase, V.conj())


def eigh(a, k=None):
    """Eigendecomposition with optional truncation to the lowest k
    (reference: pyqed/phys.py eigh)."""
    w, v = torch.linalg.eigh(as_tensor(a))
    if k is not None and k < w.shape[-1]:
        return w[..., :k], v[..., :, :k]
    return w, v


def eig_asymm(h):
    """Diagonalize a general (non-symmetric) matrix, sorted ascending by
    real part; real eigenvalues returned real (reference: pyqed/phys.py
    eig_asymm)."""
    e, c = torch.linalg.eig(as_tensor(h))
    if bool(torch.allclose(e.imag, torch.zeros_like(e.imag))):
        e = e.real
    idx = torch.argsort(e.real, stable=True)
    return e[idx], c[:, idx]


# reference-name alias: pyqed/phys.py `sort(eigvals, eigvecs)`
sort = sort_eig


def lindbladian(l, rho):
    """Single-jump Lindblad dissipator applied to rho:
    l rho l† − (1/2){l†l, rho} (reference: pyqed/phys.py lindbladian)."""
    l = as_tensor(l)
    rho = as_tensor(rho)
    return l @ rho @ dag(l) - 0.5 * anticommutator(dag(l) @ l, rho)


def ldo(b, A):
    """Linear differential operator application A b
    (reference: pyqed/phys.py ldo)."""
    return as_tensor(A) @ as_tensor(b)

"""Operator constructors (dense torch tensors).

PyTorch counterpart of ``pyqed_tpu/ops/operators.py`` (reference:
pyqed/phys.py — ``pauli:1193``, ``destroy:1030``, ``basis:1299``,
``boson:1228``, ``ham_ho:1209``, ``quadrature:1237``, ``jump:513``,
``lowering:778``, ``raising:786``, ``coh_op:580``, ``thermal_dm:961``,
``spin_ops:339``, ``multispin:1681``, ``multiboson:1805``;
pyqed/common.py — ``dagger``, ``delta``; pyqed/ho.py).

Every constructor returns a CPU tensor, complex128 unless ``dtype`` says
otherwise (:func:`~pyqed_tpu_torch.config.default_complex`): operators
are built on the host, and the solvers move them to their device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import default_complex, default_real
from .linalg import as_tensor, dag, tensor


def pauli(dtype=None):
    """(s0, sx, sy, sz) spin-half matrices (reference: pyqed/phys.py:1193)."""
    dtype = dtype or default_complex()
    s0 = torch.eye(2, dtype=dtype)
    sx = torch.tensor([[0.0, 1.0], [1.0, 0.0]], dtype=dtype)
    sy = torch.tensor([[0.0, -1j], [1j, 0.0]], dtype=dtype)
    sz = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=dtype)
    return s0, sx, sy, sz


def sigmax(dtype=None):
    return pauli(dtype)[1]


def sigmay(dtype=None):
    return pauli(dtype)[2]


def sigmaz(dtype=None):
    return pauli(dtype)[3]


def sigmam(dtype=None):
    """Lowering operator |0><1| with basis ordering (ground, excited) =
    (index 0, index 1); matches reference ``lowering`` (pyqed/phys.py:778)."""
    dtype = dtype or default_complex()
    return torch.tensor([[0.0, 1.0], [0.0, 0.0]], dtype=dtype)


def sigmap(dtype=None):
    return dag(sigmam(dtype))


def destroy(N, dtype=None):
    """Bosonic annihilation operator (reference: pyqed/phys.py:1030)."""
    dtype = dtype or default_complex()
    return torch.diag(torch.sqrt(torch.arange(1, N, dtype=default_real())),
                      1).to(dtype)


def create(N, dtype=None):
    return dag(destroy(N, dtype))


def basis(N, j, dtype=None):
    """j-th basis ket of an N-dim Hilbert space (reference: pyqed/phys.py:1299)."""
    dtype = dtype or default_complex()
    if j >= N:
        raise ValueError("Increase the size of the Hilbert space.")
    out = torch.zeros(N, dtype=dtype)
    out[j] = 1.0
    return out


def coh_op(j, i, d, dtype=None):
    """Coherence operator |j><i| in a d-dim space (reference: pyqed/phys.py:580)."""
    dtype = dtype or default_complex()
    out = torch.zeros((d, d), dtype=dtype)
    out[j, i] = 1.0
    return out


def jump(f, i, dim=2, isherm=True, dtype=None):
    """Jump operator |f><i| (+ h.c. if isherm) (reference: pyqed/phys.py:513)."""
    op = coh_op(f, i, dim, dtype)
    if isherm:
        op = op + dag(op)
    return op


def ham_ho(freq, n, ZPE=False, dtype=None):
    """Harmonic-oscillator Hamiltonian freq*(n [+ 1/2])
    (reference: pyqed/phys.py:1209)."""
    dtype = dtype or default_complex()
    diag = torch.arange(n, dtype=default_real())
    if ZPE:
        diag = diag + 0.5
    return torch.diag(freq * diag).to(dtype)


def boson(omega, n, ZPE=False, dtype=None):
    """Alias of :func:`ham_ho` (reference: pyqed/phys.py:1228)."""
    return ham_ho(omega, n, ZPE=ZPE, dtype=dtype)


def quadrature(n, dtype=None):
    """X = (a + a^†)/sqrt(2) (reference: pyqed/phys.py:1237)."""
    a = destroy(n, dtype)
    return (a + dag(a)) / math.sqrt(2.0)


def position(n, dtype=None):
    return quadrature(n, dtype)


def momentum(n, dtype=None):
    """P = i (a^† - a)/sqrt(2)."""
    a = destroy(n, dtype)
    return 1j * (dag(a) - a) / math.sqrt(2.0)


def num(N, dtype=None):
    dtype = dtype or default_complex()
    return torch.diag(torch.arange(N, dtype=default_real())).to(dtype)


def thermal_dm(n, u, dtype=None):
    """Thermal density matrix of a boson mode; ``u`` = omega/kT
    (reference: pyqed/phys.py:961)."""
    dtype = dtype or default_complex()
    diags = torch.exp(-torch.arange(n, dtype=default_real()) * u)
    diags = diags / torch.sum(diags)
    return torch.diag(diags).to(dtype)


def spin_ops(m):
    """Spin operators (Sx, Sy, Sz) for spin quantum number s=(m-1)/2 in an
    m-dim representation (reference: pyqed/phys.py:339)."""
    s = (m - 1) / 2.0
    mvals = s - torch.arange(m, dtype=default_real())
    sz = torch.diag(mvals).to(default_complex())
    # <s,m'|S+|s,m> = sqrt(s(s+1) - m(m+1)) delta_{m',m+1}
    mm = mvals[1:]
    sp = torch.diag(torch.sqrt(s * (s + 1) - mm * (mm + 1)),
                    1).to(default_complex())
    sm = dag(sp)
    sx = 0.5 * (sp + sm)
    sy = -0.5j * (sp - sm)
    return sx, sy, sz


def multispin(onsite, hopping, nsites):
    """Hamiltonian of a chain of spin-1/2 sites with XX hopping
    (reference: pyqed/phys.py:1681):

    H = sum_i onsite * s^+_i s^-_i + hopping * sum_<ij> (s^+_i s^-_j + h.c.)

    Also returns the list of site lowering operators.
    """
    s0, sx, sy, sz = pauli()
    sm = sigmam()
    idm = s0

    def embed(op, i):
        ops = [idm] * nsites
        ops[i] = op
        return tensor(ops)

    lowerings = [embed(sm, i) for i in range(nsites)]
    H = 0.0
    for i in range(nsites):
        H = H + onsite * dag(lowerings[i]) @ lowerings[i]
    for i in range(nsites - 1):
        H = H + hopping * (dag(lowerings[i]) @ lowerings[i + 1]
                           + dag(lowerings[i + 1]) @ lowerings[i])
    return H, lowerings


def _boson_chain(h1s, nmodes, J, n):
    """H = Σ_i embed(h1s[i], i) + J Σ_i (a_i† a_{i+1} + h.c.) and the
    lowering operators a_i of a chain of n-level modes."""
    a = destroy(n)
    idm = torch.eye(n, dtype=a.dtype)

    def embed(op, i):
        ops = [idm] * nmodes
        ops[i] = op
        return tensor(ops)

    lowerings = [embed(a, i) for i in range(nmodes)]
    H = 0.0
    for i in range(nmodes):
        H = H + embed(h1s[i], i)
    for i in range(nmodes - 1):
        H = H + J * (dag(lowerings[i]) @ lowerings[i + 1]
                     + dag(lowerings[i + 1]) @ lowerings[i])
    return H, lowerings


def multiboson(omega, nmodes, J=0.0, truncate=2):
    """Chain of identical boson modes with hopping J
    (reference: pyqed/phys.py:1805). Returns (H, lowering ops)."""
    return _boson_chain([ham_ho(omega, truncate)] * nmodes, nmodes, J,
                        truncate)


def multimode(omegas, nmodes, J=0.0, truncate=2):
    """Chain of distinct boson modes (reference: pyqed/phys.py:1878)."""
    return _boson_chain([ham_ho(omegas[i], truncate) for i in range(nmodes)],
                        nmodes, J, truncate)


def delta(i, j):
    """Kronecker delta (reference: pyqed/common.py:4)."""
    return 1.0 if i == j else 0.0


def displace(N, alpha):
    """Displacement operator D(alpha) = expm(alpha a^dag - alpha* a)
    (reference: pyqed/oqs.py:853 builds coherent states this way)."""
    a = destroy(N)
    alpha = complex(alpha)
    arg = alpha * a.mH - alpha.conjugate() * a
    w, U = torch.linalg.eigh(1j * arg)       # anti-Hermitian -> i*H
    return (U * torch.exp(-1j * w)) @ U.mH


def coherent(N, alpha):
    """Coherent state |alpha> = D(alpha)|0> in an N-level Fock space
    (reference: pyqed/oqs.py:853)."""
    psi = torch.zeros(N, dtype=torch.complex128)
    psi[0] = 1.0
    return displace(N, alpha) @ psi


def coherent_dm(N, alpha):
    """|alpha><alpha| (reference: pyqed/oqs.py:926)."""
    psi = coherent(N, alpha)
    return torch.outer(psi, psi.conj())


# ---------------------------------------------------------- phys.py compat

def lowering(dims=2):
    """Spin-1/2 lowering operator |0><1| (reference: pyqed/phys.py:778;
    dense here instead of scipy.sparse)."""
    if dims != 2:
        raise ValueError("dims can only be 2.")
    return sigmam()


def raising(dims=2):
    """Spin-1/2 raising operator |1><0| (reference: pyqed/phys.py:786)."""
    if dims != 2:
        raise ValueError("dims can only be 2.")
    return sigmap()


def multi_spin(onsite, nsites):
    """Hamiltonian + collective lowering operator of non-interacting
    spins (reference: pyqed/phys.py:1759 — NOTE a different API from
    ``multispin``, which also takes a hopping and returns the per-site
    list).  Returns (H, sum_i sm_i)."""
    onsite = np.atleast_1d(np.asarray(onsite, dtype=float))
    if onsite.shape[0] == 1:
        onsite = np.repeat(onsite, nsites)
    H, lowerings = multispin(0.0, 0.0, nsites)
    H = sum(float(onsite[i]) * dag(l) @ l
            for i, l in enumerate(lowerings))
    return H, sum(lowerings)


def norm2(f, dx=1.0, dy=1.0):
    """L2 norm of a 2D field, int |f|^2 dx dy (reference:
    pyqed/phys.py:824)."""
    return torch.sum(torch.abs(as_tensor(f)) ** 2) * dx * dy


def is_positive_def(A):
    """Hermitian positive-definiteness via eigenvalues (reference:
    pyqed/phys.py:304)."""
    return bool(torch.all(torch.linalg.eigvalsh(as_tensor(A)) > 0))


def direct_product(*ops):
    """Kronecker product of a sequence of operators (reference
    phys.py's kron chains)."""
    return tensor(*ops)


def jacobi_anger(n, z=1.0):
    """Jacobi-Anger coefficient i^n J_n(z) of e^{iz cos(theta)} =
    sum_n i^n J_n(z) e^{i n theta} (reference: pyqed/phys.py:281)."""
    from scipy.special import jv
    return (1j) ** n * jv(n, z)


def propagator(H, t):
    """U(t) = e^{-i H t} by eigendecomposition (reference:
    pyqed/phys.py ``propagator``/``propagator_H_const``); ``t`` a scalar
    gives (n, n), a vector (nt, n, n)."""
    w, U = torch.linalg.eigh(as_tensor(H))
    t = torch.as_tensor(t, dtype=w.dtype, device=w.device)
    if t.dim() == 0:
        phase = torch.exp(-1j * w * t)
        U = U.to(phase.dtype)
        return (U * phase) @ U.mH
    phase = torch.exp(-1j * w[None, :] * t[:, None])      # (nt, n)
    U = U.to(phase.dtype)
    return torch.einsum("an, tn, bn -> tab", U, phase, U.conj())


propagator_H_const = propagator    # reference drop-in name

"""Matrix-exponential propagation engines.

PyTorch counterpart of ``pyqed_tpu/ops/expm.py`` (reference:
pyqed/phys.py — ``expm:2049``, ``propagator:2105``,
``propagator_H_const:2163``):

- ``expm_eig``/``expm_herm``: e^{-iHt} for Hermitian H via eigh.
- ``propagators``: stacked U(k dt) for a time grid, via eigh (Hermitian)
  or RK4 (general).
- ``expm_multiply_taylor``: e^{A dt} b by truncated Taylor substeps,
  where A is only available as a matvec closure.
- ``krylov_expm_multiply``: Arnoldi small-subspace action.
- ``chebyshev_expm_multiply``: Chebyshev series for Hermitian H.
- ``expm``: e^{A t} for a general A, eigendecomposition on the host.
- ``expm_pade``: e^{A} for a general A by Padé scaling and squaring on
  A's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .linalg import as_tensor, dag, rk4


def _complex_of(dtype):
    return torch.promote_types(dtype, torch.complex64)


def expm_eig(H, t):
    """U(t) = e^{-i H t} for Hermitian H via eigendecomposition."""
    return expm_herm(H, t, prefactor=-1j)


def expm_herm(H, t, prefactor=-1j):
    """e^{prefactor * H * t} for Hermitian H."""
    w, v = torch.linalg.eigh(as_tensor(H))
    phase = torch.exp(prefactor * w * t)
    dt = torch.promote_types(v.dtype, phase.dtype)
    v, phase = v.to(dt), phase.to(dt)
    return (v * phase) @ dag(v)


def propagators(H, dt, nt, method="diag"):
    """Stack of propagators [U(0), U(dt), ..., U(nt dt)], shape (nt+1, n, n).

    method='diag' (Hermitian H): exact via eigh (reference:
    pyqed/phys.py:2163 'diag' branch). method='rk4': EOM integration
    matching the reference's default 'EOM' path (pyqed/phys.py:2105).
    """
    H = as_tensor(H)
    n = H.shape[-1]
    if method == "diag":
        w, v = torch.linalg.eigh(H)
        ks = torch.arange(nt + 1, dtype=w.dtype, device=w.device)
        phases = torch.exp(-1j * w[None, :] * ks[:, None] * dt)  # (nt+1, n)
        v = v.to(phases.dtype)
        return torch.einsum("an, kn, bn -> kab", v, phases, v.conj())
    elif method == "rk4":
        H = H.to(_complex_of(H.dtype))
        out = torch.empty((nt + 1, n, n), dtype=H.dtype, device=H.device)
        U = torch.eye(n, dtype=H.dtype, device=H.device)
        out[0] = U
        for k in range(nt):
            U = rk4(U, lambda u: -1j * (H @ u), dt)
            out[k + 1] = U
        return out
    raise ValueError(f"unknown method {method!r}")


def expm_multiply_taylor(matvec, b, dt=1.0, order=None, nsub=None):
    """y ≈ e^{dt * A} b with A given as ``matvec``.

    Uses ``nsub`` substeps of a truncated Taylor series of order ``order``
    (defaults chosen for ||A dt|| ≲ 1 per substep at double precision);
    cost = order*nsub matvecs.
    """
    if order is None:
        order = 12
    if nsub is None:
        nsub = 1
    h = dt / nsub
    y = b
    for _ in range(nsub):
        term = y
        out = y
        for k in range(1, order + 1):
            term = matvec(term) * (h / k)
            out = out + term
        y = out
    return y


def krylov_expm_multiply(matvec, b, dt=1.0, m=16):
    """y ≈ e^{dt A} b via an m-dim Arnoldi subspace.

    Works for non-Hermitian A (Liouvillians). The small (m, m) Hessenberg
    exponential is evaluated by a squared Taylor series (2^8 scaling, 12
    terms), as in the JAX package.
    """
    b = as_tensor(b)
    shape = b.shape
    bvec = b.reshape(-1)
    n = bvec.shape[0]
    beta = torch.linalg.vector_norm(bvec)
    dtype = _complex_of(bvec.dtype)
    dev = bvec.device

    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    V[0] = bvec / beta
    for j in range(m):
        w = matvec(V[j].reshape(shape)).reshape(-1).to(dtype)
        # modified Gram-Schmidt against the basis so far
        for i in range(j + 1):
            hij = torch.vdot(V[i], w)
            H[i, j] = hij
            w = w - hij * V[i]
        hnext = torch.linalg.vector_norm(w)
        H[j + 1, j] = hnext
        V[j + 1] = w / torch.where(hnext > 0, hnext, torch.ones_like(hnext))

    Hm = H[:m, :m] * dt
    s = 8  # 2^8 scaling
    A = Hm / (2.0 ** s)
    E = torch.eye(m, dtype=dtype, device=dev)
    term = torch.eye(m, dtype=dtype, device=dev)
    for k in range(1, 13):
        term = term @ A / k
        E = E + term
    for _ in range(s):
        E = E @ E

    y = beta * (V[:m].T @ E[:, 0])
    return y.reshape(shape)


def chebyshev_coefficients(z, order):
    """J_0(z) … J_order(z), the Bessel functions of the first kind that
    weigh the Chebyshev terms of e^{-i z x}, from ``scipy.special.jv``
    on the host (torch has no Bessel function of arbitrary order)."""
    from scipy.special import jv
    return jv(np.arange(order + 1), float(z))


def chebyshev_expm_multiply(H, b, dt, emin, emax, order=32):
    """y ≈ e^{-i H dt} b via Chebyshev expansion for Hermitian H with
    spectrum in [emin, emax]. Cost = ``order`` matvecs, no eigh.
    """
    H = as_tensor(H)
    b = as_tensor(b)
    # rescale H to [-1, 1]
    a = (emax - emin) / 2.0
    c = (emax + emin) / 2.0
    z = a * dt

    def hs(v):
        return ((H @ v) - c * v) / a

    # Chebyshev recursion: e^{-i z x} = sum_k (2-δ_k0) (-i)^k J_k(z) T_k(x)
    Jk = [float(x) for x in chebyshev_coefficients(z, order)]

    phi0 = b
    phi1 = hs(b)
    acc = Jk[0] * phi0 + 2.0 * (-1j) * Jk[1] * phi1
    phi_km1, phi_k = phi0, phi1
    for k in range(1, order):
        phi_kp1 = 2.0 * hs(phi_k) - phi_km1
        acc = acc + 2.0 * (-1j) ** (k + 1) * Jk[k + 1] * phi_kp1
        phi_km1, phi_k = phi_k, phi_kp1
    return acc * complex(np.exp(-1j * c * dt))


def expm(A, t, method="eig"):
    """U(t) = e^{A t} for one or many times (reference: pyqed/phys.py
    expm — an RK4 'EOM' loop there; exact by eigendecomposition here).

    A : (n, n); t : scalar or (nt,). Returns (n, n) or (nt, n, n). The
    eigendecomposition of the general A runs on the host (NumPy), the
    reconstruction on A's device.
    """
    A = as_tensor(A)
    w, V = np.linalg.eig(A.detach().cpu().numpy())
    Vinv = np.linalg.inv(V)
    dtype = _complex_of(A.dtype)
    w, V, Vinv = (torch.as_tensor(x).to(A.device, dtype) for x in (w, V, Vinv))
    t = torch.as_tensor(np.asarray(t), device=A.device).to(dtype)
    if t.dim() == 0:
        return (V * torch.exp(w * t)[None, :]) @ Vinv
    return torch.einsum("ab, tb, bc -> tac", V,
                        torch.exp(t[:, None] * w[None, :]), Vinv)


# Padé numerator coefficients b_0..b_m of jax.scipy.linalg.expm (Higham
# 2005) and the L1-norm bounds choosing m = 3, 5, 7, 9 for complex128.
_PADE_B = {
    3: (120., 60., 12., 1.),
    5: (30240., 15120., 3360., 420., 30., 1.),
    7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
    9: (17643225600., 8821612800., 2075673600., 302702400., 30270240.,
        2162160., 110880., 3960., 90., 1.),
    13: (64764752532480000., 32382376266240000., 7771770303897600.,
         1187353796428800., 129060195264000., 10559470521600.,
         670442572800., 33522128640., 1323241920., 40840800., 960960.,
         16380., 182., 1.),
}
_PADE_THETA = ((1.495585217958292e-2, 3), (2.539398330063230e-1, 5),
               (9.504178996162932e-1, 7), (2.097847961257068, 9))
_PADE_MAXNORM = 5.371920351148152


def expm_pade(A):
    """e^{A} of a general complex128 (n, n) A on A's device by Padé
    scaling and squaring: the algorithm, orders and thresholds of
    jax.scipy.linalg.expm, so both packages agree to rounding. One host
    read (A's L1 norm) picks the order and the number of squarings."""
    A = as_tensor(A).to(torch.complex128)
    norm = float(torch.linalg.matrix_norm(A, ord=1))
    s = max(0, int(np.floor(np.log2(norm / _PADE_MAXNORM)))) if norm else 0
    A = A / 2.0 ** s
    m = next((k for theta, k in _PADE_THETA if norm < theta), 13)
    b = _PADE_B[m]
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    A2 = A @ A
    if m == 13:
        A4 = A2 @ A2
        A6 = A4 @ A2
        U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
                 + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
        V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
             + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    else:
        powers = [eye, A2]
        while len(powers) <= m // 2:
            powers.append(powers[-1] @ A2)
        U = A @ sum(b[2 * k + 1] * P for k, P in enumerate(powers))
        V = sum(b[2 * k] * P for k, P in enumerate(powers))
    R = torch.linalg.solve(V - U, V + U)
    for _ in range(s):
        R = R @ R
    return R

"""Photonic structure tools: transfer matrices, quasinormal modes, and
1D dyadic Green's functions of layered media.

PyTorch counterpart of ``pyqed_tpu/beam/photonic.py``.

- Transfer matrices are batched over frequency: a stack of frequencies
  carries its four matrix elements as (B,) tensors through one
  elementwise 2x2 product per layer, where JAX ``vmap``s a 2x2 matrix
  product.
- ``quasinormal_modes`` is JAX's host Newton loop with its forward
  difference of step h = 1e-6, run for all guesses at once: each
  iteration evaluates M11 at w and w + h of every unconverged guess in
  one batched call, and a guess stops when its Newton step falls below
  1e-12, as JAX's loop breaks.
- The Dyson equations are (batched) ``torch.linalg.solve``.

Entry points run on ``device`` (the card when None); a tensor argument
keeps its device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .fieldutils import _as_tensor, _device_of

_C = torch.complex128


# --------------------------------------------------------- transfer matrix

def propagation(omega, n, l, c=1.0, device=None):
    """Phase propagation matrix through thickness l of index n, (2, 2)
    or (B, 2, 2) for a stack of frequencies. For complex omega (QNM
    search) the backward wave uses 1/phase, which equals conj(phase) on
    the real axis."""
    omega = _as_tensor(omega, _device_of(omega, device=device), _C)
    phase = torch.exp(1j * omega * l * n / c)
    z = torch.zeros_like(phase)
    return torch.stack([torch.stack([phase, z], -1),
                        torch.stack([z, 1.0 / phase], -1)], -2)


def interface(n1, n2, device=None):
    """Fresnel interface matrix (normal incidence)."""
    eta = n1 / n2
    return 0.5 * torch.as_tensor(np.asarray([[1.0 + eta, 1.0 - eta],
                                             [1.0 - eta, 1.0 + eta]]),
                                 device=_device_of(device=device))


def _interface_host(n1, n2):
    eta = n1 / n2
    a, b = 0.5 * (1.0 + eta), 0.5 * (1.0 - eta)
    return ((a, b), (b, a))


def _stack_elements(omega, ns, ls, n_in, n_out, c):
    """(M00, M01, M10, M11) of the stack's transfer matrix at every
    frequency of the complex tensor ``omega``: per layer, (P(omega) @
    I(prev, n)) @ M written out elementwise, then I(prev, n_out) @ M."""
    one = torch.ones_like(omega)
    zero = torch.zeros_like(omega)
    m00, m01, m10, m11 = one, zero, zero, one
    prev = n_in
    for n, l in zip(ns, ls):
        p = torch.exp(1j * omega * l * n / c)
        q = 1.0 / p
        (i00, i01), (i10, i11) = _interface_host(prev, n)
        a00, a01, a10, a11 = p * i00, p * i01, q * i10, q * i11
        m00, m01, m10, m11 = (a00 * m00 + a01 * m10, a00 * m01 + a01 * m11,
                              a10 * m00 + a11 * m10, a10 * m01 + a11 * m11)
        prev = n
    (i00, i01), (i10, i11) = _interface_host(prev, n_out)
    return (i00 * m00 + i01 * m10, i00 * m01 + i01 * m11,
            i10 * m00 + i11 * m10, i10 * m01 + i11 * m11)


def transfer_matrix(omega, ns: Sequence, ls: Sequence, n_in=1.0,
                    n_out=1.0, c=1.0, device=None):
    """Total transfer matrix of a stack n_in | n1(l1) | ... | n_out:
    (2, 2) for one frequency, (B, 2, 2) for a stack of them."""
    w = _as_tensor(omega, _device_of(omega, device=device), _C)
    m = _stack_elements(w, ns, ls, n_in, n_out, c)
    return torch.stack([torch.stack(m[:2], -1), torch.stack(m[2:], -1)],
                       -2)


def rt_coefficients(omega, ns, ls, n_in=1.0, n_out=1.0, c=1.0,
                    device=None):
    """(r, t) amplitude coefficients from the transfer matrix (fields
    (E+, E-): out = M in, no backward wave on the output side)."""
    w = _as_tensor(omega, _device_of(omega, device=device), _C)
    m00, m01, m10, m11 = _stack_elements(w, ns, ls, n_in, n_out, c)
    t = m00 - m01 * m10 / m11
    r = -m10 / m11
    return r, t


def transmittance_spectrum(omegas, ns, ls, n_in=1.0, n_out=1.0, c=1.0,
                           device=None):
    """|t|² over a frequency grid, every frequency at once."""
    r, t = rt_coefficients(omegas, ns, ls, n_in, n_out, c, device=device)
    return torch.abs(t) ** 2


def quasinormal_modes(ns, ls, omega_guesses, n_in=1.0, n_out=1.0, c=1.0,
                      maxiter=60, device=None):
    """Complex QNM frequencies: zeros of 1/t(omega) ~ M11 (poles of
    transmission) by Newton iteration from real-frequency guesses, with
    the forward difference (M11(w + h) − M11(w))/h, h = 1e-6. Returns a
    NumPy array of complex omegas (Im < 0 for decaying modes)."""
    dev = _device_of(device=device)
    w = np.atleast_1d(np.asarray(omega_guesses)).astype(complex)
    active = np.ones(len(w), dtype=bool)
    h = 1e-6
    for _ in range(maxiter):
        if not active.any():
            break
        wa = w[active]
        pts = torch.as_tensor(np.concatenate([wa, wa + h]), device=dev)
        f = _stack_elements(pts, ns, ls, n_in, n_out, c)[3].cpu().numpy()
        fw, fh = f[:len(wa)], f[len(wa):]
        step = fw / ((fh - fw) / h)
        w[active] = wa - step
        idx = np.nonzero(active)[0]
        active[idx[np.abs(step) < 1e-12]] = False
    return w


# ---------------------------------------------------- 1D Green's functions

def helmholtz_g0(z1, z2, k):
    """Free 1D Helmholtz Green's function g0 = e^{ik|z-z'|}/(2ik)."""
    return torch.exp(1j * k * torch.abs(z1 - z2)) / (2j * k)


class Multilayer:
    """1D layered-medium Green's function via the Dyson equation

    G = G0 + G0 k^2 chi G  ->  (I - G0 k^2 chi dz) G = G0

    on ``device`` (the card when None)."""

    def __init__(self, z, eps, eps0=1.0, device=None):
        self.device = _device_of(eps, device=device)
        self.z = np.asarray(z)
        self.nz = len(self.z)
        self.dz = self.z[1] - self.z[0]
        self.eps = _as_tensor(eps, self.device)
        self.eps0 = eps0
        self.chi = self.eps - eps0

    def green0(self, k):
        k0 = k * np.sqrt(self.eps0)
        zt = torch.as_tensor(self.z, device=self.device)
        Z1, Z2 = torch.meshgrid(zt, zt, indexing="ij")
        return helmholtz_g0(Z1, Z2, k0)

    def G(self, k):
        """Full Green's function by a dense Dyson solve."""
        g0 = self.green0(k)
        A = (torch.eye(self.nz, dtype=_C, device=self.device)
             - g0 * (k ** 2 * self.chi)[None, :] * self.dz)
        return torch.linalg.solve(A, g0)

    def ldos(self, k):
        """Relative local density of states Im G(z, z) / Im G0(z, z)."""
        G = self.G(k)
        g0 = self.green0(k)
        return torch.imag(torch.diagonal(G)) / torch.imag(torch.diagonal(g0))


# ------------------------------------------------ free-space dyadic GF

def _points(R, device):
    return _as_tensor(R, _device_of(R, device=device), torch.float64)


def dyadic_G0(R1, R2, lam, eps=1.0, device=None):
    """Free-space dyadic Green tensor G(R1, R2) (3, 3), broadcastable
    over leading batch axes of R1/R2:

    G = e^{ikr}/(4 pi r) [ (1 + (ikr-1)/(kr)^2) I
                           + (3 - 3ikr - (kr)^2)/(kr)^2  r̂ r̂ ].
    """
    dev = _device_of(R1, R2, device=device)
    R1 = _points(R1, dev)
    R2 = _points(R2, dev)
    k = 2 * np.pi / lam * np.sqrt(eps)
    d = R1 - R2
    r = torch.sqrt(torch.sum(d ** 2, dim=-1))[..., None, None]
    rhat = d / torch.sqrt(torch.sum(d ** 2, dim=-1))[..., None]
    rr = rhat[..., :, None] * rhat[..., None, :]
    I = torch.eye(3, dtype=torch.float64, device=dev)
    kr = k * r
    pref = torch.exp(1j * kr) / (4 * np.pi * r)
    A = 1 + (1j * kr - 1) / kr ** 2
    B = (3 - 3j * kr - kr ** 2) / kr ** 2
    return pref * (A * I + B * rr)


def _flip_z(device):
    return torch.as_tensor([1.0, 1.0, -1.0], dtype=torch.float64,
                           device=device)


def dyadic_Gs_interface(R1, R2, lam, eps1=1.0, eps2=1.0, device=None):
    """Quasi-static image-dipole surface Green function for an interface
    at z=0 (observation/source in medium 1, z>0):
    G_s(R1, R2) = q G0(R1, R2*) (-M), with R2* the image of the source,
    q = (eps2-eps1)/(eps2+eps1) and M = diag(1, 1, -1)."""
    dev = _device_of(R1, R2, device=device)
    R2 = _points(R2, dev)
    img = R2 * _flip_z(dev)
    q = (eps2 - eps1) / (eps2 + eps1)
    M = torch.diag(_flip_z(dev))
    return q * dyadic_G0(R1, img, lam, eps1, device=dev) @ (-M).to(_C)


def purcell_factor(G_scatt, lam, eps=1.0, orientation=2):
    """Relative decay rate Gamma/Gamma0 = 1 + Im[G_s,nn] / Im[G0,nn(0)]
    with Im G0_nn(r->r) = k/(6 pi)."""
    k = 2 * np.pi / lam * np.sqrt(eps)
    g0 = k / (6 * np.pi)
    return 1.0 + float(torch.imag(
        _as_tensor(G_scatt)[orientation, orientation])) / g0


def dyadic_Gs_slab(R1, R2, lam, eps1=1.0, eps2=1.0, eps3=1.0, spacing=1.0,
                   retarded=False, device=None):
    """Surface dyadic Green function for a 1-2-3 slab (source and
    observer inside medium 2, interfaces at z = 0 and z = spacing) by
    the method of image dipoles, one reflection per interface, with an
    optional retarded variant using the full free-space dyadic.

    Static image tensor per interface: S = c_delta * [-(3 rr - I)/r^3] M
    with M = diag(1, 1, -1) acting on the source index, r the vector
    from the image source to the observer, and
    c_delta = (eps_out - eps2)/(eps_out + eps2).
    """
    dev = _device_of(R1, R2, device=device)
    R1 = _points(R1, dev)
    R2 = _points(R2, dev)
    cd12 = (eps1 - eps2) / (eps1 + eps2)
    cd23 = (eps3 - eps2) / (eps3 + eps2)
    M = torch.diag(_flip_z(dev))
    flipz = _flip_z(dev)
    img12 = R2 * flipz
    img23 = R2 * flipz + torch.as_tensor([0.0, 0.0, 2.0 * spacing],
                                         dtype=torch.float64, device=dev)

    if retarded:
        return (cd12 * dyadic_G0(R1, img12, lam, eps2, device=dev)
                + cd23 * dyadic_G0(R1, img23, lam, eps2, device=dev)) \
            @ M.to(_C)

    def static(Rimg, cd):
        d = R1 - Rimg
        r2 = torch.sum(d ** 2, dim=-1)[..., None, None]
        dd = d[..., :, None] * d[..., None, :]
        I = torch.eye(3, dtype=torch.float64, device=dev)
        S = -(3.0 * dd - I * r2) / r2 ** 2.5
        return cd * S @ M

    return static(img12, cd12) + static(img23, cd23)


def dyadic_G_slab(R1, R2, lam, eps1=1.0, eps2=1.0, eps3=1.0, spacing=1.0,
                  retarded=False, device=None):
    """Total near-field dyadic GF inside the slab: homogeneous bulk +
    the two image reflections."""
    return (dyadic_G0(R1, R2, lam, eps2, device=device)
            + dyadic_Gs_slab(R1, R2, lam, eps1, eps2, eps3, spacing,
                             retarded=retarded, device=device))


class ChiralMultilayer:
    """1D Green's functions of a bi-isotropic (Pasteur) chiral layered
    medium, on ``device``.

    Constitutive relations D = eps0 eps E + i kappa/c H,
    B = mu0 mu H - i kappa/c E make the two circular polarizations
    exact eigenmodes with refractive indices n± = sqrt(eps mu) ± kappa;
    in 1D they decouple, so the Green function is diagonal in the
    circular basis with per-handedness Helmholtz kernels, and a
    chirality/permittivity profile enters through a per-handedness Dyson
    solve (one batched solve over the two handednesses).
    """

    def __init__(self, z, eps, kappa, mu=1.0, eps0=1.0, kappa0=0.0,
                 device=None):
        self.device = _device_of(eps, kappa, device=device)
        self.z = np.asarray(z)
        self.nz = len(self.z)
        self.dz = self.z[1] - self.z[0]
        eps = torch.broadcast_to(_as_tensor(eps, self.device, _C),
                                 (self.nz,))
        kap = torch.broadcast_to(_as_tensor(kappa, self.device, _C),
                                 (self.nz,))
        self.n = torch.stack([torch.sqrt(eps * mu) + kap,
                              torch.sqrt(eps * mu) - kap])  # (2, nz): +,-
        self.n0 = (np.sqrt(eps0 * mu) + kappa0,
                   np.sqrt(eps0 * mu) - kappa0)

    def green0(self, k):
        """(2, nz, nz): circular-basis background kernels g±."""
        zt = torch.as_tensor(self.z, device=self.device)
        Z1, Z2 = torch.meshgrid(zt, zt, indexing="ij")
        return torch.stack([helmholtz_g0(Z1, Z2, k * self.n0[0]),
                            helmholtz_g0(Z1, Z2, k * self.n0[1])])

    def green(self, k):
        """Full (2, nz, nz) Green function: per-handedness Dyson solve
        with susceptibility chi± = n±(z)^2 - n0±^2."""
        g0 = self.green0(k)
        n0sq = torch.as_tensor(np.asarray([self.n0[0] ** 2,
                                           self.n0[1] ** 2]),
                               device=self.device)
        chi = self.n * self.n - n0sq[:, None]
        A = (torch.eye(self.nz, dtype=_C, device=self.device)
             - g0 * (k ** 2 * chi)[:, None, :] * self.dz)
        return torch.linalg.solve(A, g0)

    G = green

    def optical_rotation(self, k, L=None):
        """Polarization-plane rotation across the slab,
        theta = k * integral (n+ - n-)/2 dz."""
        dn = torch.real(self.n[0] - self.n[1])
        return float(0.5 * k * torch.sum(dn) * self.dz)

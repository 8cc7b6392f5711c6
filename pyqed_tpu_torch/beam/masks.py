"""Diffractive mask and source zoo for the scalar XY beam fields.

PyTorch counterpart of ``pyqed_tpu/beam/masks.py``: every mask or source
is a pure function of the meshgrids ``(X, Y)`` returning a complex
transmission or field tensor on the device of ``X`` (NumPy grids go to
the card), composable by multiplication. Attach one to a
``ScalarFieldXY`` with ``field.u = field.u * mask(...)`` or
:func:`apply_mask`.

The rough masks (``roughness_surface``, ``circle_rough``, ``ring_rough``,
``fresnel_lens_rough``) draw their normals from a seeded
``torch.Generator`` on the grid's device, where JAX takes a
``jax.random`` key: ``key`` is an integer seed or a generator. Each also
takes its draws as an argument (``noise=``, ``normals=``), so a caller
can feed the JAX package's own draws and get its masks.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import jv

from .fieldutils import _as_tensor, _device_of, _host

_C = torch.complex128
_F = torch.float64


def _grids(field):
    x = torch.as_tensor(field.x, device=field.device)
    y = torch.as_tensor(field.y, device=field.device)
    return torch.meshgrid(x, y, indexing="ij")


def _xy(X, Y):
    X = _as_tensor(X)
    return X, _as_tensor(Y, X.device)


def apply_mask(field, mask_fn, *args, **kwargs):
    """field.u *= mask_fn(X, Y, ...); returns the field for chaining."""
    X, Y = _grids(field)
    field.u = field.u * mask_fn(X, Y, *args, **kwargs)
    return field


def _rot(X, Y, angle, r0=(0.0, 0.0)):
    c, s = float(np.cos(angle)), float(np.sin(angle))
    Xr = (X - r0[0]) * c + (Y - r0[1]) * s
    Yr = -(X - r0[0]) * s + (Y - r0[1]) * c
    return Xr, Yr


def _generator(key, device):
    """A torch.Generator on ``device``: ``key`` itself, or one seeded
    with the integer ``key``."""
    if isinstance(key, torch.Generator):
        return key
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return g


def _normals(shape, key, device, given=None):
    """Standard normals of ``shape``: ``given`` (the caller's draws), or
    drawn from ``key``."""
    if given is not None:
        return _as_tensor(given, device, _F)
    return torch.randn(shape, generator=_generator(key, device),
                       dtype=_F, device=device)


# -------------------------------------------------------------------
# amplitude masks
# -------------------------------------------------------------------

def slit(X, Y, x0, size, angle=0.0):
    X, Y = _xy(X, Y)
    Xr, _ = _rot(X, Y, angle, (x0, 0.0))
    return (torch.abs(Xr) < size / 2).to(_C)


def double_slit(X, Y, x0, size, separation, angle=0.0):
    return (slit(X, Y, x0 - separation / 2, size, angle)
            + slit(X, Y, x0 + separation / 2, size, angle))


def square(X, Y, r0, size, angle=0.0):
    X, Y = _xy(X, Y)
    sx, sy = (size, size) if np.isscalar(size) else size
    Xr, Yr = _rot(X, Y, angle, r0)
    return ((torch.abs(Xr) < sx / 2) & (torch.abs(Yr) < sy / 2)).to(_C)


def circle(X, Y, r0, radius):
    X, Y = _xy(X, Y)
    rx, ry = (radius, radius) if np.isscalar(radius) else radius
    return ((((X - r0[0]) / rx) ** 2 + ((Y - r0[1]) / ry) ** 2) <= 1.0
            ).to(_C)


def ring(X, Y, r0, radius1, radius2):
    return circle(X, Y, r0, radius2) - circle(X, Y, r0, radius1)


def cross(X, Y, r0, size, angle=0.0):
    X, Y = _xy(X, Y)
    sx, sy = (size, size) if np.isscalar(size) else size
    Xr, Yr = _rot(X, Y, angle, r0)
    arm1 = (torch.abs(Xr) < sx / 2) & (torch.abs(Yr) < sy / 8)
    arm2 = (torch.abs(Yr) < sx / 2) & (torch.abs(Xr) < sy / 8)
    return (arm1 | arm2).to(_C)


def super_gauss(X, Y, r0, radius, power=2):
    X, Y = _xy(X, Y)
    R2 = (X - r0[0]) ** 2 + (Y - r0[1]) ** 2
    return torch.exp(-(R2 / radius ** 2) ** power).to(_C)


def gray_scale(X, Y, num_levels, x_min=None, x_max=None):
    X, Y = _xy(X, Y)
    lo = X.min() if x_min is None else x_min
    hi = X.max() if x_max is None else x_max
    t = torch.clamp((X - lo) / (hi - lo), 0, 1 - 1e-12)
    return (torch.floor(t * num_levels) / (num_levels - 1)).to(_C)


# -------------------------------------------------------------------
# phase masks (lenses, axicons, gratings)
# -------------------------------------------------------------------

def lens(X, Y, wavelength, focal, r0=(0.0, 0.0), radius=None):
    """Thin-lens quadratic phase, optionally aperture-bounded."""
    X, Y = _xy(X, Y)
    fx, fy = (focal, focal) if np.isscalar(focal) else focal
    k = 2 * np.pi / wavelength
    ph = torch.exp(-1j * k * ((X - r0[0]) ** 2 / (2 * fx)
                              + (Y - r0[1]) ** 2 / (2 * fy)))
    if radius is not None:
        ph = ph * circle(X, Y, r0, radius)
    return ph


def fresnel_lens(X, Y, wavelength, focal, r0=(0.0, 0.0), radius=None,
                 kind="phase", phase=np.pi):
    """Binary Fresnel zone plate: zones from the exact spherical delay."""
    X, Y = _xy(X, Y)
    k = 2 * np.pi / wavelength
    R2 = (X - r0[0]) ** 2 + (Y - r0[1]) ** 2
    delay = k * (torch.sqrt(R2 + focal ** 2) - focal)
    zone = torch.remainder(delay, 2 * np.pi) < np.pi
    if kind == "amplitude":
        t = zone.to(_C)
    else:
        t = torch.exp(1j * phase * zone.to(_F))
    if radius is not None:
        t = t * circle(X, Y, r0, radius)
    return t


def axicon(X, Y, wavelength, angle, refraction_index=1.5,
           r0=(0.0, 0.0), radius=None):
    """Conical phase t = exp(-i k (n-1) r tan(angle))."""
    X, Y = _xy(X, Y)
    k = 2 * np.pi / wavelength
    r = torch.hypot(X - r0[0], Y - r0[1])
    t = torch.exp(-1j * k * (refraction_index - 1) * r * float(np.tan(angle)))
    if radius is not None:
        t = t * circle(X, Y, r0, radius)
    return t


def sine_grating(X, Y, period, x0=0.0, amp_min=0.0, amp_max=1.0,
                 angle=0.0):
    X, Y = _xy(X, Y)
    Xr, _ = _rot(X, Y, angle, (x0, 0.0))
    amp = amp_min + (amp_max - amp_min) * (
        1 + torch.sin(2 * np.pi * Xr / period)) / 2
    return amp.to(_C)


def binary_grating(X, Y, period, x0=0.0, fill_factor=0.5, angle=0.0,
                   kind="amplitude", phase=np.pi):
    X, Y = _xy(X, Y)
    Xr, _ = _rot(X, Y, angle, (x0, 0.0))
    on = torch.remainder(Xr / period, 1.0) < fill_factor
    if kind == "amplitude":
        return on.to(_C)
    return torch.exp(1j * phase * on.to(_F))


def blazed_grating(X, Y, period, wavelength, angle=0.0):
    """Sawtooth phase ramp diffracting into the +1 order."""
    X, Y = _xy(X, Y)
    Xr, _ = _rot(X, Y, angle)
    return torch.exp(2j * np.pi * torch.remainder(Xr / period, 1.0))


def radial_grating(X, Y, period, r0=(0.0, 0.0), binary=True):
    X, Y = _xy(X, Y)
    r = torch.hypot(X - r0[0], Y - r0[1])
    t = 0.5 * (1 + torch.sin(2 * np.pi * r / period))
    if binary:
        t = (t > 0.5)
    return t.to(_C)


def angular_grating(X, Y, num_spokes, r0=(0.0, 0.0), binary=True):
    X, Y = _xy(X, Y)
    th = torch.atan2(Y - r0[1], X - r0[0])
    t = 0.5 * (1 + torch.sin(num_spokes * th))
    if binary:
        t = (t > 0.5)
    return t.to(_C)


def forked_grating(X, Y, period, l, r0=(0.0, 0.0), kind="amplitude",
                   angle=0.0):
    """Fork hologram: carrier grating with an l-charge dislocation —
    diffracts a plane wave into +/- l vortices."""
    X, Y = _xy(X, Y)
    Xr, Yr = _rot(X, Y, angle, r0)
    th = torch.atan2(Yr, Xr)
    arg = 2 * np.pi * Xr / period - l * th
    if kind == "amplitude":
        return (torch.cos(arg) > 0).to(_C)
    return torch.exp(1j * torch.remainder(arg, 2 * np.pi))


def spiral_phase_plate(X, Y, l, r0=(0.0, 0.0)):
    X, Y = _xy(X, Y)
    th = torch.atan2(Y - r0[1], X - r0[0])
    return torch.exp(1j * l * th)


def laguerre_gauss_spiral(X, Y, wavelength, w0, l, z, r0=(0.0, 0.0),
                          kind="amplitude"):
    """Binarized LG-beam interference spiral."""
    X, Y = _xy(X, Y)
    u = laguerre_beam(X, Y, wavelength, w0, 0, l, z, r0=r0)
    t = torch.angle(u) + 2 * np.pi * torch.hypot(X - r0[0], Y - r0[1]) ** 2 \
        / (wavelength * max(z, 1e-12) * 2)
    on = torch.cos(t) > 0
    if kind == "amplitude":
        return on.to(_C)
    return torch.exp(1j * np.pi * on.to(_F))


# -------------------------------------------------------------------
# sources
# -------------------------------------------------------------------

def plane_wave(X, Y, wavelength, theta=0.0, phi=0.0, A=1.0, z0=0.0):
    X, Y = _xy(X, Y)
    k = 2 * np.pi / wavelength
    kx = float(k * np.sin(theta) * np.cos(phi))
    ky = float(k * np.sin(theta) * np.sin(phi))
    kz = float(k * np.cos(theta))
    return A * torch.exp(1j * (kx * X + ky * Y + kz * z0))


def gauss_beam(X, Y, wavelength, w0, r0=(0.0, 0.0), z0=0.0, A=1.0,
               theta=0.0, phi=0.0):
    """Gaussian beam evaluated a distance z0 from its waist."""
    X, Y = _xy(X, Y)
    wx, wy = (w0, w0) if np.isscalar(w0) else w0
    k = 2 * np.pi / wavelength
    zRx, zRy = np.pi * wx ** 2 / wavelength, np.pi * wy ** 2 / wavelength
    wxz = float(wx * np.sqrt(1 + (z0 / zRx) ** 2))
    wyz = float(wy * np.sqrt(1 + (z0 / zRy) ** 2))
    Rinv_x = z0 / (z0 ** 2 + zRx ** 2) if z0 != 0 else 0.0
    Rinv_y = z0 / (z0 ** 2 + zRy ** 2) if z0 != 0 else 0.0
    gouy = float(0.5 * (np.arctan2(z0, zRx) + np.arctan2(z0, zRy)))
    dx, dy = X - r0[0], Y - r0[1]
    u = (A * float(np.sqrt(wx * wy / (wxz * wyz)))
         * torch.exp(-dx ** 2 / wxz ** 2 - dy ** 2 / wyz ** 2)
         * torch.exp(1j * (k * z0 - gouy
                           + k * (dx ** 2 * Rinv_x + dy ** 2 * Rinv_y) / 2)))
    if theta != 0.0:
        u = u * plane_wave(X, Y, wavelength, theta, phi)
    return u


def spherical_wave(X, Y, wavelength, r0=(0.0, 0.0), z0=-1.0, A=1.0,
                   radius=None, normalize=False):
    """Paraxial spherical wave from a point at (r0, z0)."""
    X, Y = _xy(X, Y)
    k = 2 * np.pi / wavelength
    R2 = (X - r0[0]) ** 2 + (Y - r0[1]) ** 2
    u = A / z0 * torch.exp(-1j * float(np.sign(z0)) * k * R2 / (2 * z0))
    if radius is not None:
        u = u * circle(X, Y, r0, radius)
    if normalize:
        u = u / torch.max(torch.abs(u))
    return u


def vortex_beam(X, Y, wavelength, w0, m, r0=(0.0, 0.0), A=1.0):
    X, Y = _xy(X, Y)
    dx, dy = X - r0[0], Y - r0[1]
    r = torch.hypot(dx, dy)
    th = torch.atan2(dy, dx)
    return (A * (r / w0) ** abs(m) * torch.exp(-r ** 2 / w0 ** 2)
            * torch.exp(1j * m * th))


def _hermite(n, x):
    """The physicists' Hermite polynomial H_n at ``x`` (host NumPy, as
    JAX evaluates it), on the device of ``x``."""
    return torch.as_tensor(np.polynomial.hermite.hermval(
        _host(x), [0.0] * n + [1.0]), device=x.device)


def hermite_gauss_beam(X, Y, wavelength, w0, n, m, r0=(0.0, 0.0), A=1.0):
    """HG_nm mode at its waist."""
    X, Y = _xy(X, Y)
    dx, dy = (X - r0[0]) / w0, (Y - r0[1]) / w0
    return (A * _hermite(n, math.sqrt(2) * dx)
            * _hermite(m, math.sqrt(2) * dy)
            * torch.exp(-dx ** 2 - dy ** 2)).to(_C)


def _laguerre(n, alpha, x):
    """The generalized Laguerre polynomial L_n^alpha at ``x`` (host
    NumPy), on the device of ``x``."""
    from scipy.special import genlaguerre
    c = genlaguerre(n, alpha)
    return torch.as_tensor(np.polyval(c.coefficients, _host(x)),
                           device=x.device)


def laguerre_beam(X, Y, wavelength, w0, n, l, z=0.0, r0=(0.0, 0.0),
                  A=1.0):
    """LG_{n,l} mode (waist form; z only adds carrier phase here)."""
    X, Y = _xy(X, Y)
    dx, dy = X - r0[0], Y - r0[1]
    r2 = (dx ** 2 + dy ** 2) / w0 ** 2
    th = torch.atan2(dy, dx)
    return (A * (2 * r2) ** (abs(l) / 2) * _laguerre(n, abs(l), 2 * r2)
            * torch.exp(-r2) * torch.exp(1j * l * th)
            * np.exp(1j * 2 * np.pi / wavelength * z))


def bessel_beam(X, Y, wavelength, alpha, n=0, r0=(0.0, 0.0), A=1.0):
    """J_n Bessel beam with cone half-angle alpha."""
    X, Y = _xy(X, Y)
    k = 2 * np.pi / wavelength
    kr = k * np.sin(alpha)
    dx, dy = X - r0[0], Y - r0[1]
    r = np.hypot(_host(dx), _host(dy))
    th = torch.atan2(dy, dx)
    return A * torch.as_tensor(jv(n, kr * r), device=X.device) \
        * torch.exp(1j * n * th)


def _zernike_R(n, m, rho):
    m = abs(m)
    out = np.zeros_like(rho)
    for k in range((n - m) // 2 + 1):
        c = ((-1) ** k * math.factorial(n - k)
             / (math.factorial(k) * math.factorial((n + m) // 2 - k)
                * math.factorial((n - m) // 2 - k)))
        out = out + c * rho ** (n - 2 * k)
    return out


def zernike_beam(X, Y, radius, coeffs, r0=(0.0, 0.0), A=1.0):
    """Phase aberration exp(i sum_j c_j Z_{n_j}^{m_j}) (the wavefront on
    the host, as in JAX). coeffs : list of (n, m, c_nm)."""
    X, Y = _xy(X, Y)
    dx = _host(X - r0[0]) / radius
    dy = _host(Y - r0[1]) / radius
    rho = np.hypot(dx, dy)
    th = np.arctan2(dy, dx)
    W = np.zeros_like(rho)
    for (n, m, c) in coeffs:
        R = _zernike_R(n, m, rho)
        ang = np.cos(m * th) if m >= 0 else np.sin(-m * th)
        W = W + c * R * ang
    dev = X.device
    return A * torch.exp(2j * np.pi * torch.as_tensor(W, device=dev)) \
        * torch.as_tensor(rho <= 1.0, device=dev)


# -------------------------------------------------------------------
# extended mask zoo: pure functions of the meshgrids, returning complex
# transmissions
# -------------------------------------------------------------------

def triangle(X, Y, r0=None, slope=2.0, height=50.0, angle=0.0):
    """Isoceles triangle below y = -slope |x - x0| + y0, depth ``height``."""
    X, Y = _xy(X, Y)
    if r0 is None:
        r0 = (0.0, height / 2)
    x0, y0 = (r0, r0) if np.isscalar(r0) else r0
    Xr, Yr = _rot(X, Y, angle)
    top = -slope * torch.abs(Xr - x0) + y0
    return ((Yr < top) & (Yr > y0 - height)).to(_C)


def super_ellipse(X, Y, r0, radius, n=(2, 2), angle=0.0):
    """|x/rx|^nx + |y/ry|^ny < 1 (n=2 circle, n=1 diamond, n>>1 square)."""
    X, Y = _xy(X, Y)
    nx, ny = (n, n) if np.isscalar(n) else n
    rx, ry = (radius, radius) if np.isscalar(radius) else radius
    Xr, Yr = _rot(X, Y, angle, r0)
    inside = torch.abs(Xr / rx) ** nx + torch.abs(Yr / ry) ** ny < 1
    return inside.to(_C)


def square_circle(X, Y, r0, R1, R2, s, angle=0.0):
    """Guasti circle/square interpolant: s=0 ellipse, s=1 square
    (J. Mod. Opt. 40, 1073 (1993))."""
    X, Y = _xy(X, Y)
    Xr, Yr = _rot(X, Y, angle, r0)
    F = torch.sqrt(Xr ** 2 / R1 ** 2 + Yr ** 2 / R2 ** 2
                   - s ** 2 * Xr ** 2 * Yr ** 2 / (R1 ** 2 * R2 ** 2))
    box = (torch.abs(Xr) < R1) & (torch.abs(Yr) < R2)
    return ((F < 1) & box).to(_C)


def angular_aperture(X, Y, a_coef, b_coef=None, angle=0.0):
    """Radial aperture r < |sum_i a_i cos(n_i phi) + b_i sin(m_i phi)|."""
    X, Y = _xy(X, Y)
    Xr, Yr = _rot(X, Y, angle)
    r = torch.hypot(Xr, Yr)
    phi = torch.atan2(Yr, Xr)
    a_coef = np.asarray(a_coef, dtype=float)
    sol = sum(float(a_coef[1][i]) * torch.cos(float(a_coef[0][i]) * phi)
              for i in range(a_coef.shape[1]))
    if b_coef is not None:
        b_coef = np.asarray(b_coef, dtype=float)
        sol = sol + sum(float(b_coef[1][i])
                        * torch.sin(float(b_coef[0][i]) * phi)
                        for i in range(b_coef.shape[1]))
    return (r < torch.abs(sol)).to(_C)


def rings(X, Y, r0, inner_radius, outer_radius):
    """Union of concentric annuli inner_i < r < outer_i."""
    X, Y = _xy(X, Y)
    r = torch.hypot(X - r0[0], Y - r0[1])
    u = torch.zeros(r.shape, dtype=torch.bool, device=r.device)
    for ri, ro in zip(np.atleast_1d(inner_radius),
                      np.atleast_1d(outer_radius)):
        u = u | ((r >= float(ri)) & (r < float(ro)))
    return u.to(_C)


def _fourier_edge(Yr, y0, period, a_coef, b_coef):
    a_coef = np.asarray(a_coef, dtype=float)
    edge = sum(float(a_coef[1][i]) * torch.cos(
        2 * np.pi * float(a_coef[0][i]) * (Yr - y0) / period)
        for i in range(a_coef.shape[1]))
    if b_coef is not None:
        b_coef = np.asarray(b_coef, dtype=float)
        edge = edge + sum(float(b_coef[1][i]) * torch.sin(
            2 * np.pi * float(b_coef[0][i]) * (Yr - y0) / period)
            for i in range(b_coef.shape[1]))
    return edge


def edge_series(X, Y, r0, period, a_coef, b_coef=None, angle=0.0,
                invert=True):
    """Half-plane aperture bounded by the Fourier-series edge
    x < x0 + sum_i a_i cos(2 pi n_i y / T) + b_i sin(...)."""
    X, Y = _xy(X, Y)
    x0, y0 = r0
    Xr, Yr = _rot(X, Y, angle)
    on = Xr < x0 + _fourier_edge(Yr, y0, period, a_coef, b_coef)
    if invert:
        on = ~on
    return on.to(_C)


def slit_series(X, Y, x0, width, period1, period2, Dy, a_coef1, a_coef2,
                b_coef1=None, b_coef2=None, angle=0.0):
    """Slit whose two borders are independent Fourier-series edges a
    distance ``width`` + Dy apart."""
    dy1, dy2 = (Dy, Dy) if np.isscalar(Dy) else Dy
    left = edge_series(X, Y, (x0 - width / 2, dy1), period1, a_coef1,
                       b_coef1, angle, invert=False)
    right = edge_series(X, Y, (x0 + width / 2, dy2), period2, a_coef2,
                        b_coef2, angle, invert=True)
    return ((torch.abs(left) < 0.5) & (torch.abs(right) < 0.5)).to(_C)


def sinusoidal_slit(X, Y, size, x0, amplitude, phase, period, angle=0.0):
    """Slit with sinusoidally wavy borders."""
    X, Y = _xy(X, Y)
    a1, a2 = (amplitude, amplitude) if np.isscalar(amplitude) else amplitude
    p1, p2 = (period, period) if np.isscalar(period) else period
    Xr, Yr = _rot(X, Y, angle, (x0, 0.0))
    hi = +size / 2 + a1 * torch.sin(2 * np.pi * Yr / p1)
    lo = -size / 2 + a2 * torch.sin(2 * np.pi * Yr / p2 + phase)
    return ((Xr < hi) & (Xr > lo)).to(_C)


def crossed_slits(X, Y, r0, slope, angle=0.0):
    """Bow-tie aperture |y| > slope |x| (two crossed wedge slits)."""
    X, Y = _xy(X, Y)
    sx, sy = (slope, slope) if np.isscalar(slope) else slope
    x0, y0 = (r0, r0) if np.isscalar(r0) else r0
    Xr, Yr = _rot(X, Y, angle, (x0, y0))
    Y1 = sx * torch.abs(Xr)
    Y2 = sy * torch.abs(Xr)
    if sx > 0 and sy < 0:
        on = (Yr > Y1) | (Yr < Y2)
    elif sx < 0 and sy > 0:
        on = (Yr < Y1) | (Yr > Y2)
    elif sx < 0 and sy < 0:
        on = (Yr < Y1) | (Yr > -Y2)
    else:
        on = (Yr > Y1) | (Yr < -Y2)
    return on.to(_C)


def one_level(X, Y, level=0.0):
    X, Y = _xy(X, Y)
    return torch.full(X.shape, level, dtype=_C, device=X.device)


def two_levels(X, Y, level1=0.0, level2=1.0, x_edge=0.0, angle=0.0):
    """level1 for x < x_edge, level2 beyond (rotated by ``angle``)."""
    X, Y = _xy(X, Y)
    Xr, _ = _rot(X, Y, angle, (x_edge, 0.0))
    lv = torch.as_tensor(np.asarray([level1, level2]), device=X.device)
    return lv[(Xr > 0).to(torch.int64)].to(_C)


def grating_2D(X, Y, period, fill_factor=0.5, r0=(0.0, 0.0), amin=0.0,
               amax=1.0, phase=0.0, angle=0.0):
    """Product of two perpendicular binary gratings (2D array of
    openings); amplitude amin/amax plus optional phase modulation."""
    px, py = (period, period) if np.isscalar(period) else period
    tx = binary_grating(X, Y, px, r0[0], fill_factor, angle)
    ty = binary_grating(X, Y, py, r0[1], fill_factor, angle + np.pi / 2)
    on = torch.real(tx * ty)
    return (amin + (amax - amin) * on) * torch.exp(1j * phase * on)


def grating_2D_chess(X, Y, period, fill_factor=0.5, r0=(0.0, 0.0),
                     amin=0.0, amax=1.0, phase=0.0, angle=0.0):
    """Checkerboard: XOR of the two perpendicular binary gratings."""
    px, py = (period, period) if np.isscalar(period) else period
    tx = torch.real(binary_grating(X, Y, px, r0[0], fill_factor,
                                   angle)) > 0.5
    ty = torch.real(binary_grating(X, Y, py, r0[1], fill_factor,
                                   angle + np.pi / 2)) > 0.5
    on = torch.logical_xor(tx, ty).to(_F)
    return (amin + (amax - amin) * on) * torch.exp(1j * phase * on)


def lens_spherical(X, Y, wavelength, r0, radius, focal,
                   refraction_index=1.5, mask=True):
    """Exact (non-paraxial) spherical plano-convex lens phase:
    h = sqrt(R^2 - r^2) - R with R = (n - 1) f."""
    X, Y = _xy(X, Y)
    k = 2 * np.pi / wavelength
    R = (refraction_index - 1) * focal
    r2 = (X - r0[0]) ** 2 + (Y - r0[1]) ** 2
    h = torch.where(R ** 2 > r2,
                    torch.sqrt(torch.clamp(R ** 2 - r2, min=0.0)) - R,
                    torch.zeros((), dtype=_F, device=X.device))
    t = circle(X, Y, r0, radius) if mask else torch.ones_like(X)
    return t * torch.exp(1j * k * (refraction_index - 1) * h)


def aspheric(X, Y, wavelength, r0, c, k_conic, a, n0, n1, radius,
             mask=True):
    """Even-asphere sag phase plate:
    z(r) = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) + sum_i a_i r^(2i+4)."""
    X, Y = _xy(X, Y)
    s2 = (X - r0[0]) ** 2 + (Y - r0[1]) ** 2
    disc = torch.clamp(1 - (1 + k_conic) * c ** 2 * s2, min=0.0)
    sag = c * s2 / (1 + torch.sqrt(disc))
    if a is not None:
        for i, ai in enumerate(np.atleast_1d(a)):
            sag = sag + float(ai) * s2 ** (2 + i)
    t = circle(X, Y, r0, radius) if mask else torch.ones_like(X)
    return t * torch.exp(2j * np.pi * (n1 - n0) * sag / wavelength)


def elliptical_phase(X, Y, wavelength, f1, f2, angle=0.0):
    """Astigmatic (elliptical) lens phase with focals f1 (x) and f2 (y)."""
    X, Y = _xy(X, Y)
    k = 2 * np.pi / wavelength
    Xr, Yr = _rot(X, Y, angle)
    return torch.exp(1j * k * (Xr ** 2 / (2 * f1) + Yr ** 2 / (2 * f2)))


def axicon_binary(X, Y, r0, radius, period):
    """Binary axicon: equally spaced rings cos(2 pi r / T) > 0."""
    X, Y = _xy(X, Y)
    r = torch.hypot(X - r0[0], Y - r0[1])
    on = (torch.cos(2 * np.pi * r / period) > 0) & (r < radius)
    return on.to(_C)


def biprism_fresnel(X, Y, wavelength, r0, width, height, n=1.5):
    """Fresnel biprism: tent-shaped glass profile of half-width
    ``width`` and apex height 2*``height``."""
    X, Y = _xy(X, Y)
    k = 2 * np.pi / wavelength
    h = torch.clamp(2 * height - 2 * height / width
                    * torch.abs(X - r0[0]), min=0.0)
    t = (torch.abs(X - r0[0]) < width).to(_C)
    return t * torch.exp(1j * k * (n - 1) * h)


def hyperbolic_grating(X, Y, r0, period, radius, binary=True, angle=0.0):
    """Grating with hyperbolic iso-phase lines sqrt(|x^2 - y^2|)."""
    X, Y = _xy(X, Y)
    Xr, Yr = _rot(X, Y, angle, r0)
    r = torch.hypot(X - r0[0], Y - r0[1])
    xh = torch.sqrt(torch.abs(Xr ** 2 - Yr ** 2))
    t = (1 + torch.sin(2 * np.pi * xh / period)) / 2
    if binary:
        t = (t > 0.5).to(_F)
    return (t * (r < radius)).to(_C)


def archimedes_spiral(X, Y, r0, period, phase, p, radius, binary=True):
    """Archimedean spiral zone structure of power ``p``."""
    X, Y = _xy(X, Y)
    r = torch.hypot(X - r0[0], Y - r0[1])
    theta = torch.atan2(Y - r0[1], X - r0[0])
    t = 0.5 * (1 + torch.sin(2 * np.pi * torch.sign(X)
                             * ((r / period) ** p
                                + (theta - phase) / (2 * np.pi))))
    if binary:
        t = (t > 0.5).to(_F)
    return (t * (r < radius)).to(_C)


def sine_edge_grating(X, Y, r0, period, lp, ap, phase, radius,
                      binary=True):
    """Linear grating whose groove edges wiggle sinusoidally along y
    (edge period lp, edge amplitude ap)."""
    X, Y = _xy(X, Y)
    r = torch.hypot(X - r0[0], Y - r0[1])
    shift = phase + ap * torch.sin(2 * np.pi * Y / lp)
    t = (1 + torch.sin(2 * np.pi * (X - shift) / period)) / 2
    if binary:
        t = (t > 0.5).to(_F)
    return (t * (r < radius)).to(_C)


def hermite_gauss_binary(X, Y, r0, w0, n, m):
    """Binary (0/pi) phase mask with the sign structure of HG_nm."""
    X, Y = _xy(X, Y)
    wx, wy = (w0, w0) if np.isscalar(w0) else w0
    E = (_hermite(n, math.sqrt(2) * (X - r0[0]) / wx)
         * _hermite(m, math.sqrt(2) * (Y - r0[1]) / wy))
    return torch.exp(1j * np.pi * (E > 0).to(_F))


def laguerre_gauss_binary(X, Y, r0, w0, n, l):
    """Binary phase mask with the sign structure of LG_nl plus the
    l-charge azimuthal phase."""
    X, Y = _xy(X, Y)
    rho2 = (X - r0[0]) ** 2 + (Y - r0[1]) ** 2
    th = torch.atan2(Y - r0[1], X - r0[0])
    E = _laguerre(n, abs(l), 2 * rho2 / w0 ** 2)
    return torch.exp(1j * (np.pi * (E > 0).to(_F) + l * th))


# -------------------------------------------------------------------
# stochastic (rough) masks: a seed or torch.Generator, or the draws
# -------------------------------------------------------------------

def roughness_surface(x, y, t, s, key=0, noise=None, device=None):
    """Gaussian-correlated random height map h(x, y) (Ogilvy p.224):
    white noise filtered by exp(-x^2/tx^2 - y^2/ty^2), rescaled to std
    ``s``. ``noise``: the (nx, ny) standard normals (default: drawn from
    ``key``). Returns a real (nx, ny) tensor."""
    tx, ty = (t, t) if np.isscalar(t) else t
    dev = _device_of(noise, device=device)
    x = _host(x)
    y = _host(y)
    noise = _normals((len(x), len(y)), key, dev, noise)
    xc = x - x[(len(x)) // 2]
    yc = y - y[(len(y)) // 2]
    kern = (np.exp(-xc ** 2 / tx ** 2)[:, None]
            * np.exp(-yc ** 2 / ty ** 2)[None, :])
    kern_f = torch.fft.fft2(torch.fft.ifftshift(torch.as_tensor(
        kern, device=dev)))
    h = torch.real(torch.fft.ifft2(torch.fft.fft2(noise) * kern_f))
    h = h - torch.mean(h)
    return h * (s / torch.std(h, correction=0))


def circle_rough(X, Y, r0, radius, sigma, key=0, normals=None):
    """Circle whose edge radius fluctuates by N(0, sigma) per pixel.
    ``normals``: the standard normals of X's shape (default: drawn from
    ``key``)."""
    X, Y = _xy(X, Y)
    dr = sigma * _normals(X.shape, key, X.device, normals)
    inside = (X - r0[0]) ** 2 + (Y - r0[1]) ** 2 < (radius + dr) ** 2
    return inside.to(_C)


def ring_rough(X, Y, r0, radius1, radius2, sigma, key=0, normals=None):
    """Annulus with rough inner and outer edges. ``normals``: (inner,
    outer) standard normals; drawn in that order from ``key`` when
    None."""
    X, Y = _xy(X, Y)
    g = None if normals is not None else _generator(key, X.device)
    n1, n2 = normals if normals is not None else (None, None)
    inner = circle_rough(X, Y, r0, radius1, sigma, g, n1)
    outer = circle_rough(X, Y, r0, radius2, sigma, g, n2)
    return torch.clamp(torch.real(outer) - torch.real(inner), 0, 1).to(_C)


def fresnel_lens_rough(X, Y, wavelength, r0, radius, focal, sigma, key=0,
                       normals=None):
    """Fresnel zone plate assembled from rough-edged odd zones.
    ``normals``: the central circle's draws, then an (inner, outer) pair
    per ring (default: drawn in that order from ``key``)."""
    X, Y = _xy(X, Y)
    num_rings = int(round((radius ** 2) / (wavelength * focal)))
    g = None if normals is not None else _generator(key, X.device)
    draws = list(normals) if normals is not None else None
    u = torch.real(circle_rough(X, Y, r0, np.sqrt(wavelength * focal),
                                sigma, g, draws[0] if draws else None))
    for j, m in enumerate(range(3, num_rings + 2, 2)):
        ri = np.sqrt((m - 1) * wavelength * focal)
        ro = np.sqrt(m * wavelength * focal)
        u = u + torch.real(ring_rough(X, Y, r0, ri, ro, sigma, g,
                                      draws[j + 1] if draws else None))
    return torch.clamp(u, 0, 1).to(_C)


# -------------------------------------------------------------------
# placement / composition utilities
# -------------------------------------------------------------------

def _nearest_idx(grid, vals):
    grid = _host(grid)
    vals = np.atleast_1d(np.asarray(vals, dtype=float))
    return np.clip(np.round((vals - grid[0]) / (grid[1] - grid[0])
                            ).astype(int), 0, len(grid) - 1)


def dots(x, y, r0, device=None):
    """Delta masks: 1 at the grid pixels nearest each (x0_i, y0_i)."""
    ix = _nearest_idx(x, r0[0])
    iy = _nearest_idx(y, r0[1])
    u = np.zeros((len(x), len(y)), dtype=complex)
    u[ix, iy] = 1.0
    return torch.as_tensor(u, device=_device_of(x, device=device))


def dots_regular(x, y, xlim, ylim, num_data, device=None):
    """Regular nx x ny lattice of delta pixels."""
    nx, ny = num_data
    xs = np.linspace(xlim[0], xlim[1], nx)
    ys = np.linspace(ylim[0], ylim[1], ny)
    iX, iY = np.meshgrid(_nearest_idx(x, xs), _nearest_idx(y, ys),
                         indexing="ij")
    u = np.zeros((len(x), len(y)), dtype=complex)
    u[iX, iY] = 1.0
    return torch.as_tensor(u, device=_device_of(x, device=device))


def prism(X, Y, wavelength, r0, angle_wedge, angle=0.0):
    """Wedge phase ramp deflecting by angle_wedge."""
    X, Y = _xy(X, Y)
    k = 2 * np.pi / wavelength
    Xr, _ = _rot(X, Y, angle, r0)
    return torch.exp(1j * k * Xr * float(np.sin(angle_wedge)))


def ronchi_grating(X, Y, period, x0=0.0, fill_factor=0.5, angle=0.0):
    """Binary amplitude grating thresholded from a sinusoid, so the fill
    factor is exact: on where sin phase > cos(pi*fill)."""
    y0 = float(np.cos(np.pi * fill_factor))
    s = sine_grating(X, Y, period, x0=x0, amp_min=-1.0, amp_max=1.0,
                     angle=angle)
    return (torch.real(s) > y0).to(_C)


def hammer(X, Y, r0, size, hammer_width, angle=0.0):
    """Rectangle with hammer-head squares on its four corners
    (lithography proximity-correction motif)."""
    sx, sy = (size, size) if np.isscalar(size) else size
    x0, y0 = r0
    u = square(X, Y, r0, size, angle)
    c, s = np.cos(angle), np.sin(angle)
    for ex, ey in ((-sx / 2, -sy / 2), (-sx / 2, sy / 2),
                   (sx / 2, -sy / 2), (sx / 2, sy / 2)):
        cx = x0 + ex * c - ey * s
        cy = y0 + ex * s + ey * c
        u = u + square(X, Y, (cx, cy), (hammer_width, hammer_width), angle)
    return (torch.real(u) > 0).to(_C)


def photon_sieve(x, y, t_u, pos):
    """Photon sieve: stamp the pinhole shape ``t_u`` at every (x, y)
    position in ``pos`` by FFT convolution with a delta comb, clipping
    the summed overlaps to 1. Returns (mask, num_points_inside)."""
    x = _host(x)
    y = _host(y)
    t_u = _as_tensor(t_u)
    comb = np.zeros((len(x), len(y)))
    npts = 0
    for (px, py) in np.atleast_2d(np.asarray(pos, dtype=float)):
        if x[0] < px < x[-1] and y[0] < py < y[-1]:
            comb[_nearest_idx(x, px), _nearest_idx(y, py)] = 1.0
            npts += 1
    u = torch.real(_fft_convolve2d(torch.as_tensor(comb, device=t_u.device),
                                   t_u))
    return torch.clamp(u, 0.0, 1.0).to(_C), npts


def _fft_convolve2d(a, b):
    """Cyclic 'same'-centered FFT convolution (both arrays same shape)."""
    b = _as_tensor(b)
    fa = torch.fft.fft2(_as_tensor(a, b.device))
    fb = torch.fft.fft2(torch.fft.ifftshift(b))
    return torch.fft.ifft2(fa * fb)


def masks_to_positions(x, y, t_u, pos, binarize=False, normalize=False):
    """Stamp the mask ``t_u`` at every position in ``pos`` via FFT
    convolution with a delta comb."""
    f1 = _as_tensor(t_u)
    comb = dots(x, y, pos, device=f1.device)
    if normalize:
        f1 = f1 / torch.sum(f1)
    out = torch.real(_fft_convolve2d(comb, f1))
    if binarize is not False:
        out = (out > binarize).to(_F)
    else:
        out = torch.clamp(out, 0, 1)
    return out.to(_C)


def insert_array_masks(x, y, t_u, space, margin=0.0):
    """Tile copies of ``t_u`` on a rectangular lattice of pitch
    ``space`` covering the aperture (minus ``margin``)."""
    sx, sy = (space, space) if np.isscalar(space) else space
    mx, my = (margin, margin) if np.isscalar(margin) else margin
    x = _host(x)
    y = _host(y)
    xs = np.arange(x[0] + mx + sx / 2, x[-1] - mx, sx)
    ys = np.arange(y[0] + my + sy / 2, y[-1] - my, sy)
    XX, YY = np.meshgrid(xs, ys, indexing="ij")
    return masks_to_positions(x, y, t_u, (XX.ravel(), YY.ravel()),
                              binarize=0.5)


def widen(x, y, u, radius, binarize=True):
    """Morphological widening: convolve |u| with a disc of ``radius``
    centered at the grid pixel nearest the domain center (so the stamped
    structure does not shift)."""
    u = _as_tensor(u)
    dev = u.device
    xh, yh = _host(x), _host(y)
    X, Y = torch.meshgrid(torch.as_tensor(xh, device=dev),
                          torch.as_tensor(yh, device=dev), indexing="ij")
    xc = xh[_nearest_idx(xh, (xh[0] + xh[-1]) / 2)[0]]
    yc = yh[_nearest_idx(yh, (yh[0] + yh[-1]) / 2)[0]]
    disc = torch.real(circle(X, Y, (xc, yc), radius))
    disc = disc / torch.sum(disc)
    out = torch.real(_fft_convolve2d(torch.abs(u), disc))
    if binarize:
        out = (out > 0.01 * torch.max(out)).to(_F)
    else:
        out = out / torch.max(out)
    return out.to(_C)


def filter_mask(x, y, u, kernel_u, binarize=False, normalize=False):
    """Convolve |u| with |kernel_u|."""
    u = _as_tensor(u)
    f1 = torch.abs(_as_tensor(kernel_u, u.device))
    if normalize:
        f1 = f1 / torch.sum(f1)
    out = torch.real(_fft_convolve2d(torch.abs(u), f1))
    if binarize is not False:
        out = (out > binarize).to(_F)
    return out.to(_C)


def area(u, dx, dy, percentage=0.001):
    """Area (grid units^2) where intensity exceeds ``percentage`` of max."""
    inten = torch.abs(_as_tensor(u)) ** 2
    return float(int(torch.sum(inten > percentage * torch.max(inten)))
                 * dx * dy)


def inverse_amplitude(u):
    """amplitude -> 1 - amplitude, phase kept."""
    u = _as_tensor(u)
    return (1 - torch.abs(u)) * torch.exp(1j * torch.angle(u))


def inverse_phase(u):
    """phase -> -phase, amplitude kept."""
    u = _as_tensor(u)
    return torch.abs(u) * torch.exp(-1j * torch.angle(u))


def mask_from_function(X, Y, wavelength, r0, index, f1, f2, radius,
                       mask=True):
    """Phase mask between two surfaces h = f2(X, Y) - f1(X, Y); f1 and
    f2 are callables of the grid tensors."""
    X, Y = _xy(X, Y)
    k = 2 * np.pi / wavelength
    h = f2(X, Y) - f1(X, Y)
    t = circle(X, Y, r0, radius) if mask else torch.ones_like(X)
    return t * torch.exp(1j * k * (index - 1) * h)


def extrude_mask_x(x, y, u_1d, y0=None, y1=None):
    """Extrude a 1D mask u(x) along y between y0 and y1."""
    u_1d = _as_tensor(u_1d)
    y = _host(y)
    y0 = y[0] if y0 is None else y0
    y1 = y[-1] if y1 is None else y1
    band = torch.as_tensor(((y >= y0) & (y <= y1)).astype(float),
                           device=u_1d.device)
    return u_1d[:, None] * band[None, :]


def repeat_structure(x, y, u, num_repetitions, position="center"):
    """Tile the mask nrep times; returns (x_new, y_new, u_new)."""
    nx_rep, ny_rep = num_repetitions
    u_new = torch.tile(_as_tensor(u), (nx_rep, ny_rep))
    x = _host(x)
    y = _host(y)
    x_new = np.linspace(nx_rep * x[0], nx_rep * x[-1], nx_rep * len(x))
    y_new = np.linspace(ny_rep * y[0], ny_rep * y[-1], ny_rep * len(y))
    if position == "center":
        x_new = x_new - (x_new[0] + x_new[-1]) / 2
        y_new = y_new - (y_new[0] + y_new[-1]) / 2
    elif position == "previous":
        x_new = x_new - x_new[0] + x[0]
        y_new = y_new - y_new[0] + y[0]
    return x_new, y_new, u_new


def image_mask(x, y, filename, invert=False, device=None):
    """Grey-level amplitude mask from an image file (read by matplotlib,
    imported here), resampled to the (x, y) grid."""
    import matplotlib.image as mpimg
    from scipy.ndimage import zoom
    img = mpimg.imread(filename)
    if img.ndim == 3:
        img = img[..., :3].mean(axis=-1)
    img = np.asarray(img, dtype=float)
    img = img / (img.max() if img.max() > 0 else 1.0)
    if invert:
        img = 1 - img
    zx = len(x) / img.shape[1]
    zy = len(y) / img.shape[0]
    img = zoom(img, (zy, zx), order=1)[:len(y), :len(x)]
    return torch.as_tensor(img.T.astype(complex),
                           device=_device_of(x, device=device))


# -------------------------------------------------------------------
# multi-beam sources
# -------------------------------------------------------------------

def plane_waves_dict(X, Y, wavelength, params):
    """Sum of plane waves, each a dict with A/theta/phi/z0."""
    X, Y = _xy(X, Y)
    u = torch.zeros(X.shape, dtype=_C, device=X.device)
    for p in params:
        u = u + plane_wave(X, Y, wavelength, p.get("theta", 0.0),
                           p.get("phi", 0.0), p.get("A", 1.0),
                           p.get("z0", 0.0))
    return u


def plane_waves_several_inclined(X, Y, wavelength, A, num_beams,
                                 max_angle, z0=0.0):
    """Fan of equally spaced inclined plane waves."""
    X, Y = _xy(X, Y)
    nbx, nby = num_beams
    max_x, max_y = max_angle
    u = torch.zeros(X.shape, dtype=_C, device=X.device)
    for i in range(nbx):
        for j in range(nby):
            th = -max_x / 2 + max_x / nbx * (i + 0.5)
            ph = -max_y / 2 + max_y / nby * (j + 0.5)
            u = u + plane_wave(X, Y, wavelength, th, ph, A, z0)
    return u


def gauss_beams_several_parallel(X, Y, wavelength, r0, A, num_beams, w0,
                                 r_range, z0=0.0, theta=0.0, phi=0.0):
    """Rectangular array of parallel Gaussian beams."""
    X, Y = _xy(X, Y)
    nbx, nby = num_beams
    xr, yr = r_range
    xc, yc = r0
    u = torch.zeros(X.shape, dtype=_C, device=X.device)
    for i in range(nbx):
        xi = xc - xr / 2 + xr / nbx * (i + 0.5)
        for j in range(nby):
            yj = yc - yr / 2 + yr / nby * (j + 0.5)
            u = u + gauss_beam(X, Y, wavelength, w0, (xi, yj), z0, A,
                               theta, phi)
    return u


def gauss_beams_several_inclined(X, Y, wavelength, A, num_beams, w0, r0,
                                 max_angle, z0=0.0):
    """Fan of inclined Gaussian beams sharing one origin."""
    X, Y = _xy(X, Y)
    nbx, nby = num_beams
    max_x, max_y = max_angle
    u = torch.zeros(X.shape, dtype=_C, device=X.device)
    for i in range(nbx):
        for j in range(nby):
            th = -max_x / 2 + max_x / nbx * (i + 0.5)
            ph = -max_y / 2 + max_y / nby * (j + 0.5)
            u = u + gauss_beam(X, Y, wavelength, w0, r0, z0, A, th, ph)
    return u


def set_amplitude(u, amplitude):
    """Replace |u| keeping the phase."""
    u = _as_tensor(u)
    ph = torch.where(torch.abs(u) > 0,
                     u / torch.clamp(torch.abs(u), min=1e-300),
                     torch.ones((), dtype=u.dtype, device=u.device))
    return _as_tensor(amplitude, u.device) * ph


def set_phase(u, phase):
    """Replace the phase keeping |u|."""
    u = _as_tensor(u)
    return torch.abs(u) * torch.exp(1j * _as_tensor(phase, u.device))

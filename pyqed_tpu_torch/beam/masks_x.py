"""1D (line) masks and sources for ``ScalarFieldX``.

PyTorch counterpart of ``pyqed_tpu/beam/masks_x.py``: every mask or
source is a pure function of the coordinate array ``x`` returning a
complex transmission or field vector on the device of ``x`` (a NumPy
``x`` goes to the card). Masks separable along x reuse the 2D ones of
:mod:`.masks` through :func:`from_xy`.

The stochastic masks (``roughness``, ``dust``, ``dust_different_sizes``)
draw from a seeded ``torch.Generator`` on the device, where JAX takes a
``jax.random`` key: ``key`` is an integer seed or a generator, and each
also takes its draws as arguments (``noise=``; ``uniforms=`` and
``normals=``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import masks as _mk2
from .fieldutils import _as_tensor, _host
from .masks import _generator, _normals

_C = torch.complex128
_F = torch.float64


# ------------------------------------------------------------------
# adapter: evaluate any (X, Y) mask on the y = 0 line
# ------------------------------------------------------------------

def from_xy(mask_fn, x, *args, **kwargs):
    """Evaluate a 2D mask of :mod:`.masks` on the y = 0 line -> (nx,)."""
    X = _as_tensor(x)[:, None]
    Y = torch.zeros_like(X)
    return mask_fn(X, Y, *args, **kwargs)[:, 0]


def slit(x, x0, size):
    return from_xy(_mk2.slit, x, x0, size)


def double_slit(x, x0, size, separation):
    return from_xy(_mk2.double_slit, x, x0, size, separation)


def two_levels(x, level1=0.0, level2=1.0, x_edge=0.0):
    x = _as_tensor(x)
    lv = torch.as_tensor(np.asarray([level1, level2]), device=x.device)
    return lv[(x > x_edge).to(torch.int64)].to(_C)


def sine_grating(x, period, x0=0.0, amp_min=0.0, amp_max=1.0):
    return from_xy(_mk2.sine_grating, x, period, x0, amp_min, amp_max)


def binary_grating(x, period, x0=0.0, fill_factor=0.5, kind="amplitude",
                   phase=np.pi):
    return from_xy(_mk2.binary_grating, x, period, x0, fill_factor, 0.0,
                   kind, phase)


ronchi_grating = binary_grating     # fill_factor = 0.5 default


def blazed_grating(x, period, wavelength):
    return from_xy(_mk2.blazed_grating, x, period, wavelength)


def lens(x, wavelength, focal, x0=0.0, radius=None):
    x = _as_tensor(x)
    k = 2 * np.pi / wavelength
    ph = torch.exp(-1j * k * (x - x0) ** 2 / (2 * focal))
    if radius is not None:
        ph = ph * (torch.abs(x - x0) < radius)
    return ph


def lens_spherical(x, wavelength, x0, radius, focal,
                   refraction_index=1.5):
    return from_xy(_mk2.lens_spherical, x, wavelength, (x0, 0.0), radius,
                   focal, refraction_index)


def aspheric(x, wavelength, x0, c, k_conic, a, n0, n1, radius):
    return from_xy(_mk2.aspheric, x, wavelength, (x0, 0.0), c, k_conic,
                   a, n0, n1, radius)


def fresnel_lens(x, wavelength, focal, x0=0.0, radius=None,
                 kind="phase", phase=np.pi):
    return from_xy(_mk2.fresnel_lens, x, wavelength, focal, (x0, 0.0),
                   radius, kind, phase)


def gray_scale(x, num_levels, level_min=0.0, level_max=1.0):
    """Staircase of ``num_levels`` equal-width amplitude levels."""
    x = _as_tensor(x)
    frac = (x - x[0]) / (x[-1] - x[0]) * (1 - 1e-12)
    idx = torch.floor(frac * num_levels)
    levels = torch.as_tensor(np.linspace(level_min, level_max, num_levels),
                             device=x.device)
    return levels[idx.to(torch.int64)].to(_C)


def prism(x, wavelength, x0, n, anglex):
    """Linear phase ramp of a thin prism h = (x - x0) sin(anglex)."""
    x = _as_tensor(x)
    k = 2 * np.pi / wavelength
    return torch.exp(1j * k * (n - 1) * (x - x0) * float(np.sin(anglex)))


def biprism_fresnel(x, wavelength, x0, width, height, n=1.5):
    """Tent-profile Fresnel biprism."""
    return from_xy(_mk2.biprism_fresnel, x, wavelength, (x0, 0.0), width,
                   height, n)


# ------------------------------------------------------------------
# chirped gratings
# ------------------------------------------------------------------

def _grating_kinds(t, kind, amp_min, amp_max, phase_max):
    t = amp_min + (amp_max - amp_min) * t
    if kind.endswith("binary"):
        t = (t > (amp_min + amp_max) / 2).to(_F)
    if kind.startswith("phase"):
        return torch.exp(1j * phase_max * t)
    return t.to(_C)


def chirped_grating_p(x, kind, p0, p1, amp_min=0.0, amp_max=1.0,
                      phase_max=np.pi, x0=None):
    """Grating with LINEAR period variation p(x) = p0 + pa (x - x0):
    accumulated phase = 2 pi ln(p(x)) / pa (the exact integral of
    2 pi / p(x))."""
    x = _as_tensor(x)
    x0 = float(_host(x)[0]) if x0 is None else x0
    size = float(x[-1] - x[0])
    pa = (p1 - p0) / size
    if abs(pa) < 1e-15:
        phi = 2 * np.pi * (x - x0) / p0
    else:
        phi = 2 * np.pi * torch.log(p0 + pa * (x - x0)) / pa
    t = (1 + torch.cos(phi)) / 2
    return _grating_kinds(t, kind, amp_min, amp_max, phase_max)


def chirped_grating_q(x, kind, p0, p1, amp_min=0.0, amp_max=1.0,
                      phase_max=np.pi, x0=None):
    """Grating with LINEAR spatial-frequency variation
    q(x) = q0 + qa (x - x0), q = 2 pi / p: phase =
    (q0 + qa (x - x0)/2)(x - x0)."""
    x = _as_tensor(x)
    x0 = float(_host(x)[0]) if x0 is None else x0
    size = float(x[-1] - x[0])
    q0, q1 = 2 * np.pi / p0, 2 * np.pi / p1
    qa = (q1 - q0) / size
    phi = (q0 + 0.5 * qa * (x - x0)) * (x - x0)
    t = (1 + torch.cos(phi)) / 2
    return _grating_kinds(t, kind, amp_min, amp_max, phase_max)


def chirped_grating(x, kind, p_fn, amp_min=0.0, amp_max=1.0,
                    phase_max=np.pi, x0=None):
    """Grating with an ARBITRARY local period p(x) given as a callable of
    the coordinate tensor: the phase is the cumulative integral of
    2 pi / p(x) on the grid."""
    x = _as_tensor(x)
    dx = x[1] - x[0]
    q = 2 * np.pi / p_fn(x)
    phi = torch.cumsum(q, 0) * dx
    phi = phi - phi[0]
    t = (1 + torch.cos(phi)) / 2
    return _grating_kinds(t, kind, amp_min, amp_max, phase_max)


# ------------------------------------------------------------------
# stochastic masks: a seed or torch.Generator, or the draws
# ------------------------------------------------------------------

def roughness(x, t, s, key=0, noise=None):
    """Gaussian-correlated rough phase edge heights (1D Ogilvy).
    ``noise``: the (nx,) standard normals (default: drawn from
    ``key``)."""
    xt = _as_tensor(x)
    dev = xt.device
    x = _host(x)
    noise = _normals((len(x),), key, dev, noise)
    xc = x - x[len(x) // 2]
    kern = torch.as_tensor(np.exp(-xc ** 2 / t ** 2), device=dev)
    kf = torch.fft.fft(torch.fft.ifftshift(kern))
    h = torch.real(torch.fft.ifft(torch.fft.fft(noise) * kf))
    h = h - torch.mean(h)
    return h * (s / torch.std(h, correction=0))


def dust(x, percentage, size, key=0, std=0.0, uniforms=None, normals=None):
    """Opaque dust particles of mean ``size`` blocking ``percentage`` of
    the line; returns (mask, positions, sizes), the last two NumPy.
    ``uniforms`` (num,) in [0, 1) place the particles and ``normals``
    (num,) spread their sizes; both are drawn from ``key`` (uniforms
    first) when not given."""
    xt = _as_tensor(x)
    dev = xt.device
    x = _host(x)
    total = x[-1] - x[0]
    num = int(percentage * total / size)
    if percentage > 0.5:
        num = int(num * (1 + np.sqrt(percentage)))
    g = None
    if uniforms is None or normals is None:
        g = _generator(key, dev)
    if uniforms is None:
        uniforms = torch.rand((num,), generator=g, dtype=_F, device=dev)
    normals = _normals((num,), g, dev, normals)
    positions = x[0] + total * _host(uniforms)
    sizes = size + std * _host(normals)
    sizes[sizes < 0] = size
    block = torch.any(
        torch.abs(xt[:, None] - torch.as_tensor(positions, device=dev))
        < torch.as_tensor(sizes, device=dev) / 2, dim=1)
    return (~block).to(_C), positions, sizes


def dust_different_sizes(x, percentage, size, key=0, std=None,
                         uniforms=None, normals=None):
    """:func:`dust` with std defaulting to size/4."""
    return dust(x, percentage, size, key,
                std=(size / 4 if std is None else std), uniforms=uniforms,
                normals=normals)


# ------------------------------------------------------------------
# binary codes
# ------------------------------------------------------------------

def binary_code_positions(x, x_transitions, start="down"):
    """Binary code flipping at each transition position."""
    x = _as_tensor(x)
    xt = np.unique(np.asarray(x_transitions, dtype=float))
    t = torch.zeros(len(x), dtype=_F, device=x.device)
    for x0 in xt:
        t = t + (x >= x0)
    t = torch.remainder(t, 2)
    if start == "up":
        t = 1 - t
    return t.to(_C)


def binary_code(x, code, bit_width, x0=0.0, kind="standard"):
    """Bar code: bit j occupies [x0 + j w, x0 + (j+1) w).
    kind='abs_fag' interleaves each bit as (0, 1, bit, 1) quarter-width
    cells (absolute-encoder pattern)."""
    code = np.asarray(code, dtype=float)
    if kind == "abs_fag":
        zeros = np.zeros_like(code)
        ones = np.ones_like(code)
        code = np.stack([zeros, ones, code, ones], 1).reshape(-1)
        bit_width = bit_width / 4
    x = _as_tensor(x)
    j = torch.floor((x - x0) / bit_width).to(torch.int64)
    inside = (j >= 0) & (j < len(code))
    vals = torch.as_tensor(np.concatenate([code, [0.0]]), device=x.device)
    return torch.where(inside, vals[torch.clamp(j, 0, len(code))],
                       torch.zeros((), dtype=_F, device=x.device)).to(_C)


# ------------------------------------------------------------------
# sources
# ------------------------------------------------------------------

def plane_wave(x, wavelength, theta=0.0, A=1.0, z0=0.0):
    x = _as_tensor(x)
    k = 2 * np.pi / wavelength
    return A * torch.exp(1j * k * (x * float(np.sin(theta))
                                   + z0 * float(np.cos(theta))))


def gauss_beam(x, wavelength, w0, x0=0.0, z0=0.0, A=1.0, theta=0.0):
    return from_xy(_mk2.gauss_beam, x, wavelength, w0, (x0, 0.0), z0, A,
                   theta, 0.0)


def spherical_wave(x, wavelength, x0=0.0, z0=-1000.0, A=1.0):
    """Cylindrical (line-source) wave observed at z = 0 from (x0, z0)."""
    x = _as_tensor(x)
    k = 2 * np.pi / wavelength
    R = torch.sqrt((x - x0) ** 2 + z0 ** 2)
    return A * torch.exp(1j * float(np.sign(-z0)) * k * R) / torch.sqrt(R)


def plane_waves_dict(x, wavelength, params):
    xt = _as_tensor(x)
    u = torch.zeros(len(xt), dtype=_C, device=xt.device)
    for p in params:
        u = u + plane_wave(xt, wavelength, p.get("theta", 0.0),
                           p.get("A", 1.0), p.get("z0", 0.0))
    return u


def plane_waves_several_inclined(x, wavelength, A, num_beams, max_angle,
                                 z0=0.0):
    xt = _as_tensor(x)
    u = torch.zeros(len(xt), dtype=_C, device=xt.device)
    for i in range(num_beams):
        th = -max_angle / 2 + max_angle / num_beams * (i + 0.5)
        u = u + plane_wave(xt, wavelength, th, A, z0)
    return u


def gauss_beams_several_parallel(x, wavelength, A, num_beams, w0,
                                 x_central, x_range, z0=0.0):
    xt = _as_tensor(x)
    u = torch.zeros(len(xt), dtype=_C, device=xt.device)
    for i in range(num_beams):
        xi = x_central - x_range / 2 + x_range / num_beams * (i + 0.5)
        u = u + gauss_beam(xt, wavelength, w0, xi, z0, A)
    return u


def gauss_beams_several_inclined(x, wavelength, A, num_beams, w0, x0,
                                 max_angle, z0=0.0):
    xt = _as_tensor(x)
    u = torch.zeros(len(xt), dtype=_C, device=xt.device)
    for i in range(num_beams):
        th = -max_angle / 2 + max_angle / num_beams * (i + 0.5)
        u = u + gauss_beam(xt, wavelength, w0, x0, z0, A, th)
    return u


def dots(x, positions):
    """Delta-like transparent dots at the given positions."""
    xt = _as_tensor(x)
    x = _host(x)
    u = np.zeros(len(x))
    for xi in np.atleast_1d(positions):
        u[int(np.argmin(np.abs(x - xi)))] = 1.0
    return torch.as_tensor(u.astype(complex), device=xt.device)


def mask_from_function(x, f):
    """Amplitude mask from a callable t(x) of the coordinate tensor."""
    x = _as_tensor(x)
    return _as_tensor(f(x), x.device).to(_C)


def mask_from_array(x, x_data, t_data):
    """Amplitude mask interpolated from sampled data (host NumPy
    ``interp``)."""
    xt = _as_tensor(x)
    return torch.as_tensor(np.interp(_host(x), _host(x_data),
                                     _host(t_data)).astype(complex),
                           device=xt.device)


def filter_mask(x, u, kernel_width):
    """Low-pass the mask with a normalized Gaussian kernel (host NumPy
    convolution)."""
    ut = _as_tensor(u)
    x = _host(x)
    k = np.exp(-((x - x.mean()) ** 2) / (2 * kernel_width ** 2))
    k /= k.sum()
    return torch.as_tensor(np.convolve(_host(ut), k, mode="same"),
                           device=ut.device)

"""Scalar and vector optical diffraction: 1D/2D fields, sources, masks,
propagation through homogeneous space and refractive-index volumes.

PyTorch counterpart of ``pyqed_tpu/beam/beam.py``. The field classes
hold their coordinates as NumPy arrays and their fields as complex128
tensors on ``device`` (the card when None, which raises without one;
``"cpu"`` on request). Every FFT runs on ``torch.fft`` (cuFFT on the
card).

- Angular-spectrum propagation keeps JAX's choice between the
  propagating and the evanescent branch, ``where(kz² >= 0, e^{i kz z},
  e^{-|kz| |z|})``. Many planes (``propagate_many``, ``propagate``) are
  one broadcast over planes, filled in chunks at large nz, where JAX
  takes a ``vmap``.
- BPM, WPM, PWD and inverse BPM are JAX's ``lax.scan`` as a loop over
  planes that writes each plane into a preallocated ``(nz, ...)`` stack.
  The homogeneous kernels ``kz`` are built on the host with NumPy's
  principal branch, as JAX builds them, and the uniform-dz hoist of the
  step's transfer function is kept.
- WPM keeps a level index per pixel (nearest level, the first on a tie)
  and gathers the propagated level at each pixel, where JAX sums
  one-hot float64 masks: the two give the same numbers bit for bit.
- Rayleigh-Sommerfeld propagation pads to 2n − 1 points per axis.

The draw methods (``draw``, ``draw_profile``) import matplotlib only when
called.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device
from .fieldutils import _as_tensor, _complex, _host

# planes filled per batched transform where a stack is built by broadcast
_PLANE_CHUNK = 16


def _operand(a, device):
    """A factor for a field product: fields' arrays and arrays become
    tensors on ``device``, Python numbers stay numbers."""
    if isinstance(a, (int, float, complex)):
        return a
    return _as_tensor(a, device)


class ScalarFieldX:
    """1D scalar field u(x) at fixed wavelength, on ``device``."""

    def __init__(self, x, wavelength, u=None, n_background=1.0,
                 device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x)
        self.wavelength = wavelength
        self.n = n_background
        self.k = 2 * np.pi * n_background / wavelength
        self.u = (torch.zeros(len(self.x), dtype=torch.complex128,
                              device=self.device)
                  if u is None else _complex(u, self.device))

    # ------------------------------------------------------------- algebra
    def __add__(self, other):
        return ScalarFieldX(self.x, self.wavelength, self.u + other.u, self.n,
                            device=self.device)

    def __mul__(self, other):
        ou = other.u if isinstance(other, ScalarFieldX) else other
        return ScalarFieldX(self.x, self.wavelength,
                            self.u * _operand(ou, self.device), self.n,
                            device=self.device)

    def duplicate(self):
        return ScalarFieldX(self.x, self.wavelength, self.u, self.n,
                            device=self.device)

    def intensity(self):
        return torch.abs(self.u) ** 2

    def normalize(self):
        dx = self.x[1] - self.x[0]
        self.u = self.u / torch.sqrt(torch.sum(torch.abs(self.u) ** 2) * dx)
        return self

    # --------------------------------------------------------- propagation
    def angular_spectrum(self, z):
        """Band-limited angular-spectrum propagation by distance z."""
        self.u = _asm_1d(self.u, self.x, self.wavelength, z, self.n)
        return self

    def RS(self, z, fast=False, kind="z"):
        """Quadrature Rayleigh-Sommerfeld propagation (Shen & Wang FFT
        convolution): a linear convolution against the free-space RS-I
        kernel. Sets ``self.quality`` (> 1: the grid resolves the
        kernel's fastest fringe)."""
        self.u, self.quality = _rs_1d(self.u, self.x, self.wavelength, z,
                                      self.n, fast=fast, kind=kind)
        return self

    def propagate_many(self, zs):
        """Field at many z planes: (nz, nx), one broadcast over planes."""
        return _asm_planes(self.u, (self.x,), self.wavelength, zs, self.n)

    def fft(self, remove_phase=True):
        """Far-field (Fraunhofer) amplitude: (fx NumPy, U tensor)."""
        dx = self.x[1] - self.x[0]
        U = torch.fft.fftshift(torch.fft.fft(self.u)) * dx
        fx = np.fft.fftshift(np.fft.fftfreq(len(self.x), dx))
        return fx, U

    # ----------------------------------------------------- post-processing
    def binarize(self, kind="amplitude", bin_level=None, level0=None,
                 level1=None):
        from .fieldutils import binarize
        self.u = binarize(self.u, kind, bin_level, level0, level1)
        return self

    def discretize(self, kind="amplitude", num_levels=2, phase0=-np.pi):
        from .fieldutils import discretize
        self.u = discretize(self.u, kind, num_levels, phase0)
        return self

    def get_edges(self, kind_transition="amplitude", min_step=0.0):
        """Edge positions/types of a binary mask (NumPy)."""
        from .fieldutils import get_edges
        return get_edges(self.x, self.u, kind_transition, min_step)


def _freq(x):
    return np.fft.fftfreq(len(x), x[1] - x[0])


def _kz2_asm(axes, wavelength, n, device):
    """k² − Σ (2π f)² over the grid of ``axes`` (1 or 2 coordinate
    arrays), in JAX's order of operations."""
    k = 2 * math.pi * n / wavelength
    fs = [torch.as_tensor(_freq(a), device=device) for a in axes]
    if len(fs) == 1:
        return k ** 2 - (2 * math.pi * fs[0]) ** 2
    return (k ** 2 - (2 * math.pi * fs[0][:, None]) ** 2
            - (2 * math.pi * fs[1][None, :]) ** 2)


def _asm_H(kz2, kz, z):
    """The angular-spectrum transfer function for ``z`` (a number, or a
    tensor of planes broadcast over the leading axis): e^{i kz z} where
    kz² >= 0, e^{-|kz| |z|} where the mode is evanescent."""
    if isinstance(z, torch.Tensor):
        z = z.reshape((-1,) + (1,) * kz.dim())
        az = torch.abs(z)
    else:
        az = abs(z)
    return torch.where(kz2 >= 0, torch.exp(1j * kz * z), torch.exp(-kz * az))


def _asm_1d(u, x, wavelength, z, n=1.0):
    kz2 = _kz2_asm((x,), wavelength, n, u.device)
    kz = torch.sqrt(torch.abs(kz2))
    H = _asm_H(kz2, kz, z)
    return torch.fft.ifft(torch.fft.fft(u) * H)


def _asm_2d(u, x, y, wavelength, z, n=1.0):
    kz2 = _kz2_asm((x, y), wavelength, n, u.device)
    kz = torch.sqrt(torch.abs(kz2))
    H = _asm_H(kz2, kz, z)
    return torch.fft.ifft2(torch.fft.fft2(u) * H)


def _asm_planes(u0, axes, wavelength, zs, n):
    """The angular spectrum of ``u0`` at every z of ``zs``: a stack
    (nz, ...) filled :data:`_PLANE_CHUNK` planes per batched inverse
    transform (JAX's ``vmap`` of ``_asm_1d``/``_asm_2d``)."""
    dev = u0.device
    zs = torch.as_tensor(np.asarray(zs, dtype=float), device=dev)
    kz2 = _kz2_asm(axes, wavelength, n, dev)
    kz = torch.sqrt(torch.abs(kz2))
    dims = tuple(range(-len(axes), 0))
    U0 = torch.fft.fftn(u0, dim=dims)
    out = torch.empty((len(zs),) + tuple(u0.shape), dtype=torch.complex128,
                      device=dev)
    for a in range(0, len(zs), _PLANE_CHUNK):
        H = _asm_H(kz2, kz, zs[a:a + _PLANE_CHUNK])
        out[a:a + _PLANE_CHUNK] = torch.fft.ifftn(U0 * H, dim=dims)
    return out


class ScalarFieldXY:
    """2D scalar field u(x, y), indexed [x, y], on ``device``."""

    def __init__(self, x, y, wavelength, u=None, n_background=1.0,
                 device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.wavelength = wavelength
        self.n = n_background
        self.k = 2 * np.pi * n_background / wavelength
        shape = (len(self.x), len(self.y))
        self.u = (torch.zeros(shape, dtype=torch.complex128,
                              device=self.device)
                  if u is None else _complex(u, self.device))

    def __mul__(self, other):
        ou = other.u if isinstance(other, ScalarFieldXY) else other
        return ScalarFieldXY(self.x, self.y, self.wavelength,
                             self.u * _operand(ou, self.device), self.n,
                             device=self.device)

    def intensity(self):
        return torch.abs(self.u) ** 2

    def angular_spectrum(self, z):
        self.u = _asm_2d(self.u, self.x, self.y, self.wavelength, z, self.n)
        return self

    def RS(self, z, kind="z"):
        """Quadrature Rayleigh-Sommerfeld propagation, 2D, with the
        closed-form RS-I kernel, padded to (2nx − 1, 2ny − 1). Sets
        ``self.quality``."""
        self.u, self.quality = _rs_2d(self.u, self.x, self.y,
                                      self.wavelength, z, self.n,
                                      kind=kind)
        return self

    def propagate_many(self, zs):
        """(nz, nx, ny) volume, one broadcast over planes."""
        return _asm_planes(self.u, (self.x, self.y), self.wavelength, zs,
                           self.n)

    # ----------------------------------------------------- post-processing
    def get_amplitude(self):
        return torch.abs(self.u)

    def get_phase(self):
        return torch.angle(self.u)

    def remove_phase(self, sign=False):
        from .fieldutils import remove_phase
        self.u = remove_phase(self.u, sign)
        return self

    def binarize(self, kind="amplitude", bin_level=None, level0=None,
                 level1=None):
        from .fieldutils import binarize
        self.u = binarize(self.u, kind, bin_level, level0, level1)
        return self

    def discretize(self, kind="amplitude", num_levels=2, phase0=-np.pi):
        from .fieldutils import discretize
        self.u = discretize(self.u, kind, num_levels, phase0)
        return self

    def search_focus(self, kind="maximum"):
        """(x0, y0) of the intensity maximum or centroid."""
        from .fieldutils import search_focus
        return search_focus(self.x, self.y, self.u, kind)

    def profile(self, point1, point2, npixels=None, kind="intensity"):
        """Interpolated line cut between two (x, y) points."""
        from .fieldutils import profile
        return profile(self.x, self.y, self.u, point1, point2, npixels,
                       kind)

    def rotate(self, angle, position=None):
        """Rotate the field about ``position``."""
        from .fieldutils import rotate_field
        self.u = rotate_field(self.x, self.y, self.u, angle, position)
        return self

    def insert_mask(self, other, r0=(0.0, 0.0)):
        """Paste ``other`` (a smaller ScalarFieldXY) into this field at
        ``r0``."""
        from .fieldutils import insert_array
        self.u = insert_array(self.x, self.y, self.u, other.u,
                              other.x, other.y, r0)
        return self


def _rs_quality(rmax, dr, wavelength, z, n):
    """Sampling quality factor for quadrature RS: the ratio of the
    kernel's slowest fringe spacing at the grid edge to the actual grid
    step; > 1 means the discrete sum resolves the integrand."""
    lam = wavelength / n
    dr_ideal = np.sqrt(lam ** 2 + rmax ** 2
                       + 2 * lam * np.sqrt(rmax ** 2 + z ** 2)) - rmax
    return float(dr_ideal / dr / np.sqrt(2))


def _kernel_rs_1d(x, wavelength, z, n=1.0, kind="z", fast=False):
    """RS-I kernel, 1D (cylindrical-wave Green function; z < 0 selects
    the incoming-wave kernel, so RS(z) then RS(-z) is the exact adjoint).
    The exact form uses the Hankel function H1^(1) on the host (SciPy, a
    one-time precompute); ``fast`` uses the large-argument asymptotic
    (DLMF 10.2.5). NumPy."""
    x = np.asarray(x, float)
    k = 2 * np.pi * n / wavelength
    R = np.sqrt(x ** 2 + z ** 2)
    sgn = 1.0 if z > 0 else -1.0
    if fast:
        hk1 = np.sqrt(2 / (np.pi * k * R)) * np.exp(
            sgn * 1j * (k * R - 3 * np.pi / 4))
    else:
        from scipy.special import hankel1
        hk1 = hankel1(1, k * R)
        if z < 0:
            hk1 = np.conj(hk1)
    num = {"z": z, "x": x, "0": sgn}[kind]
    return (0.5j * k * num / R) * hk1


def _kernel_rs_2d(X, Y, wavelength, z, n=1.0, kind="z"):
    """RS-I kernel, 2D closed form, on the device of ``X``; z < 0 is
    conj(forward(|z|)), the exact adjoint."""
    k = 2 * math.pi * n / wavelength
    R = torch.sqrt(X ** 2 + Y ** 2 + z ** 2)
    num = {"z": abs(z), "x": X, "y": Y, "0": 1.0}[kind]
    if z > 0:
        return torch.exp(1j * k * R) * num / R ** 2 * (1 / R - 1j * k) \
            / (2 * math.pi)
    return torch.exp(-1j * k * R) * num / R ** 2 * (1 / R + 1j * k) \
        / (2 * math.pi)


def _rs_1d(u, x, wavelength, z, n=1.0, fast=False, kind="z"):
    """Linear-convolution quadrature RS (Shen & Wang, Appl. Opt. 45,
    1102 (2006)): zero-pad to 2nx − 1, multiply FFTs of field and kernel,
    keep the causal half. Returns (u_out, quality)."""
    x = np.asarray(x, float)
    nx = len(x)
    dx = x[1] - x[0]
    quality = _rs_quality(np.abs(x).max(), dx, wavelength, z, n)
    xext = np.concatenate([(x[0] - x[::-1])[:-1], x - x[0]])
    H = torch.as_tensor(_kernel_rs_1d(xext, wavelength, z, n, kind, fast),
                        device=u.device)
    U = torch.cat([u.to(torch.complex128),
                   torch.zeros(nx - 1, dtype=torch.complex128,
                               device=u.device)])
    S = torch.fft.ifft(torch.fft.fft(U) * torch.fft.fft(H)) * dx
    return S[nx - 1:], quality


def _rs_2d(u, x, y, wavelength, z, n=1.0, kind="z"):
    """2D quadrature RS by zero-padded FFT convolution, padded to
    (2nx − 1, 2ny − 1). Returns (u_out, quality)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    nx, ny = len(x), len(y)
    dx = x[1] - x[0]
    dy = y[1] - y[0]
    rmax = np.sqrt(np.abs(x).max() ** 2 + np.abs(y).max() ** 2)
    quality = _rs_quality(rmax, max(dx, dy), wavelength, z, n)
    dev = u.device
    xext = np.concatenate([(x[0] - x[::-1])[:-1], x - x[0]])
    yext = np.concatenate([(y[0] - y[::-1])[:-1], y - y[0]])
    H = _kernel_rs_2d(torch.as_tensor(xext, device=dev)[:, None],
                      torch.as_tensor(yext, device=dev)[None, :],
                      wavelength, z, n, kind)
    U = torch.zeros((2 * nx - 1, 2 * ny - 1), dtype=torch.complex128,
                    device=dev)
    U[:nx, :ny] = u
    S = torch.fft.ifft2(torch.fft.fft2(U) * torch.fft.fft2(H)) * dx * dy
    return S[nx - 1:, ny - 1:], quality


# ------------------------------------------------------------------ sources

def plane_wave(field, theta=0.0, amplitude=1.0):
    """Tilted plane wave (sets ``field.u``)."""
    kx = field.k * np.sin(theta)
    xs = torch.as_tensor(field.x, device=field.device)
    if isinstance(field, ScalarFieldX):
        field.u = amplitude * torch.exp(1j * kx * xs)
    else:
        field.u = amplitude * torch.exp(1j * kx * xs)[:, None] * torch.ones(
            len(field.y), dtype=torch.float64, device=field.device)
    return field


def gauss_beam(field, w0, x0=0.0, y0=0.0, amplitude=1.0):
    """Gaussian at its waist (sets ``field.u``, real as in JAX)."""
    if isinstance(field, ScalarFieldX):
        xs = torch.as_tensor(field.x, device=field.device)
        field.u = amplitude * torch.exp(-((xs - x0) / w0) ** 2)
    else:
        X, Y = np.meshgrid(field.x, field.y, indexing="ij")
        field.u = amplitude * torch.exp(torch.as_tensor(
            -(((X - x0) ** 2 + (Y - y0) ** 2) / w0 ** 2), device=field.device))
    return field


# -------------------------------------------------------------------- masks

def _times(field, t):
    """field.u times the host transmission ``t`` (broadcast along y for
    a 1D ``t`` on an XY field)."""
    t = torch.as_tensor(t, device=field.device)
    if isinstance(field, ScalarFieldX) or t.dim() == 2:
        field.u = field.u * t
    else:
        field.u = field.u * t[:, None]
    return field


def slit(field, width, x0=0.0):
    t = (np.abs(field.x - x0) <= width / 2).astype(float)
    return _times(field, t)


def double_slit(field, width, separation, x0=0.0):
    t = (((np.abs(field.x - x0 - separation / 2) <= width / 2)
          | (np.abs(field.x - x0 + separation / 2) <= width / 2))
         .astype(float))
    return _times(field, t)


def circular_aperture(field, radius, x0=0.0, y0=0.0):
    X, Y = np.meshgrid(field.x, field.y, indexing="ij")
    t = (((X - x0) ** 2 + (Y - y0) ** 2) <= radius ** 2).astype(float)
    return _times(field, t)


def _exp_host(field, arg):
    """e^{arg} on the field's device for a host argument array."""
    return torch.exp(torch.as_tensor(arg, device=field.device))


def lens(field, focal):
    """Thin-lens quadratic phase."""
    X, Y = np.meshgrid(field.x, field.y, indexing="ij")
    field.u = field.u * _exp_host(
        field, -1j * field.k * (X ** 2 + Y ** 2) / (2 * focal))
    return field


Scalar_field_X = ScalarFieldX
Scalar_field_XY = ScalarFieldXY


# ------------------------------------------------------ volume propagation

def _dzs(z):
    return np.diff(np.concatenate([[0.0], np.asarray(z, float)]))


def _is_uniform(dzs):
    return np.ptp(dzs) <= 1e-12 * np.max(np.abs(dzs))


def _kz_principal(kz2):
    """NumPy's principal complex sqrt of a real host array (+i|.| on the
    evanescent side), JAX's ``np.sqrt(kz2.astype(complex))``."""
    return np.sqrt(np.asarray(kz2).astype(complex))


def _kz_decaying(kz2):
    """The +Im branch of sqrt(kz2) (host): exp(i kz dz) decays."""
    kz = np.sqrt(np.asarray(kz2).astype(complex))
    return np.where(kz.imag < 0, -kz, kz)


def _kperp2(axes):
    ks = [2 * np.pi * _freq(a) for a in axes]
    if len(ks) == 1:
        return ks[0] ** 2
    return ks[0][:, None] ** 2 + ks[1][None, :] ** 2


def _bpm_kz2(axes, k0, n0):
    ks = [2 * np.pi * _freq(a) for a in axes]
    if len(ks) == 1:
        return (k0 * n0) ** 2 - ks[0] ** 2
    return (k0 * n0) ** 2 - ks[0][:, None] ** 2 - ks[1][None, :] ** 2


def _fftn(u, nd):
    return torch.fft.fftn(u, dim=tuple(range(-nd, 0)))


def _ifftn(u, nd):
    return torch.fft.ifftn(u, dim=tuple(range(-nd, 0)))


def _scene_on(n_scene, dev):
    """An index scene (array or tensor) as a tensor on ``dev``, read one
    plane a step (no copy for a tensor already there)."""
    return None if n_scene is None else _as_tensor(n_scene, dev)


def _write(out, k, u, edge):
    """Plane k of ``out`` = u (times the edge filter, written in place);
    returns the plane, the next step's input."""
    if edge is None:
        out[k] = u
    else:
        torch.mul(u, edge, out=out[k])
    return out[k]


def _bpm_stack(u0, axes, z, wavelength, n0, n_scene, edge):
    """Split-step BPM: each z step applies the homogeneous angular-
    spectrum propagator, then the phase screen e^{i k0 (n − n0) dz}, then
    the edge filter; plane k of the returned (nz, ...) stack lies at
    z[k]."""
    nd = len(axes)
    dev = u0.device
    dzs = _dzs(z)
    k0 = 2 * np.pi / wavelength
    kz = _kz_principal(_bpm_kz2(axes, k0, n0))
    out = torch.empty((len(dzs),) + tuple(u0.shape),
                      dtype=torch.complex128, device=dev)
    uniform = _is_uniform(dzs)
    if uniform:
        H = torch.as_tensor(np.exp(1j * kz * dzs[0]), device=dev)
    else:
        kzj = torch.as_tensor(kz, device=dev)
    n_t = _scene_on(n_scene, dev)
    u = u0
    for k, dz in enumerate(dzs):
        if uniform:
            u = _ifftn(H * _fftn(u, nd), nd)
            dz = dzs[0]
        else:
            u = _ifftn(torch.exp(1j * kzj * dz) * _fftn(u, nd), nd)
        if n_t is not None:
            u = u * torch.exp(1j * k0 * (n_t[k] - n0) * dz)
        u = _write(out, k, u, edge)
    return out


def _wpm_stack(u0, axes, z, wavelength, n0, n_scene, levels, edge):
    """Wave propagation method: per step, the exact homogeneous kernel
    of every index level (one batched inverse FFT over the levels), then
    at each pixel the level nearest its index (:func:`_level_index`)."""
    nd = len(axes)
    dev = u0.device
    dzs = _dzs(z)
    k0 = 2 * np.pi / wavelength
    if n_scene is None:          # a uniform scene at the background index
        levels = _wpm_levels(np.full(1, complex(n0)), levels, dev)
        bg = torch.full(tuple(u0.shape), complex(n0), dtype=torch.complex128,
                        device=dev)
        plane = lambda k: bg  # noqa: E731
    else:
        n_t = _scene_on(n_scene, dev)
        levels = _wpm_levels(n_t, levels, dev)
        plane = n_t.__getitem__
    lv = levels.reshape((-1,) + (1,) * nd)
    kz = _kz_decaying((k0 * lv) ** 2 - _kperp2(axes)[None])
    lev_t = torch.as_tensor(levels, device=dev)
    out = torch.empty((len(dzs),) + tuple(u0.shape),
                      dtype=torch.complex128, device=dev)
    uniform = _is_uniform(dzs)
    if uniform:
        Hm = torch.as_tensor(np.exp(1j * kz * dzs[0]), device=dev)
    else:
        kzj = torch.as_tensor(kz, device=dev)
    u = u0
    for k, dz in enumerate(dzs):
        Ek = _fftn(u, nd)
        Hk = Hm if uniform else torch.exp(1j * kzj * dz)
        um = _ifftn(Hk * Ek[None], nd)
        idx = _level_index(plane(k), lev_t)
        u = _write(out, k, torch.gather(um, 0, idx[None])[0], edge)
    return out


def _pwd_stack(u0, axes, z, wavelength, n):
    """Plane-wave decomposition: every step the exact homogeneous kernel
    e^{i dz sqrt((k0 n)² − k⊥²)} at one scalar index."""
    nd = len(axes)
    dev = u0.device
    dzs = _dzs(z)
    k0 = 2 * np.pi / wavelength
    kzj = torch.as_tensor(_kz_decaying((k0 * n) ** 2 - _kperp2(axes)),
                          device=dev)
    out = torch.empty((len(dzs),) + tuple(u0.shape),
                      dtype=torch.complex128, device=dev)
    u = u0
    for k, dz in enumerate(dzs):
        u = _write(out, k, _ifftn(torch.exp(1j * kzj * dz) * _fftn(u, nd),
                                  nd), None)
    return out


def _edge(axes, shape, has_edges, pow_edge, dev):
    if not has_edges:
        return None
    return torch.as_tensor(_edge_filter(shape, axes, pow_edge), device=dev)


class ScalarFieldXZ:
    """Scalar field on an (x, z) sheet: a 1D transverse field propagated
    and stored over a z-stack (nz, nx), on ``device``."""

    def __init__(self, x, z, wavelength, n_background=1.0, device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x)
        self.z = np.asarray(z)
        self.wavelength = wavelength
        self.n = n_background
        self.u = None           # (nz, nx) after propagation

    def incident_field(self, u0):
        self.u0 = _complex(u0, self.device)
        return self

    def propagate(self):
        """Fill the whole (z, x) sheet by the angular spectrum."""
        self.u = _asm_planes(self.u0, (self.x,), self.wavelength, self.z,
                             self.n)
        return self.u

    def bpm(self, n_xz=None, has_edges=True, pow_edge=80):
        """Split-step BPM through n(z, x). n_xz: (nz, nx) index sheet or
        None. Plane k of the result lies at ``self.z[k]`` (the first step
        covers 0 -> z[0]); non-uniform z grids are supported."""
        edge = _edge((self.x,), (len(self.x),), has_edges, pow_edge,
                     self.device)
        self.u = _bpm_stack(self.u0, (self.x,), self.z, self.wavelength,
                            self.n, n_xz, edge)
        return self.u

    def wpm(self, n_xz=None, levels=None, has_edges=True, pow_edge=80):
        """Wave propagation method (Schmidt kernel) through n(z, x): each
        z step propagates the field with the exact homogeneous kernel of
        every index level n_m, then keeps at each pixel the result of the
        level nearest its index. levels: explicit index levels; default
        the unique values of ``n_xz`` rounded to 9 decimals."""
        edge = _edge((self.x,), (len(self.x),), has_edges, pow_edge,
                     self.device)
        self.u = _wpm_stack(self.u0, (self.x,), self.z, self.wavelength,
                            self.n, n_xz, levels, edge)
        return self.u

    def pwd(self, n=None):
        """Plane-wave-decomposition propagation at a single scalar index
        ``n`` (default the background): the one-level case of
        :meth:`wpm`."""
        self.u = _pwd_stack(self.u0, (self.x,), self.z, self.wavelength,
                            self.n if n is None else n)
        return self.u

    def surface_detection(self, n_xz, mode=1, min_incr=0.1):
        """Edge point cloud of an index scene ``n_xz`` (nz, nx); returns
        (xs, zs)."""
        from .fieldutils import surface_detection
        return surface_detection(self.x, self.z, _host(n_xz).T, mode,
                                 min_incr)

    def detect_index_variations(self, n_xz, n_edge, incr_n=0.1):
        """Left/right interface curves of an index scene."""
        from .fieldutils import detect_index_variations
        return detect_index_variations(self.x, self.z, _host(n_xz).T,
                                       n_edge, incr_n)

    def bpm_inverse(self, n_xz=None, has_edges=True, pow_edge=80):
        """Inverse BPM: from the field at the last plane (``self.u0``),
        undo the forward steps; the stack runs from the exit plane back
        toward z = 0."""
        x, z = self.x, self.z
        dev = self.device
        dzs = _dzs(z)[::-1]
        k0 = 2 * np.pi / self.wavelength
        kzj = torch.as_tensor(_kz_principal(_bpm_kz2((x,), k0, self.n)),
                              device=dev)
        edge = _edge((x,), (len(x),), has_edges, pow_edge, dev)
        nz = len(dzs)
        out = torch.empty((nz, len(x)), dtype=torch.complex128, device=dev)
        n_t = _scene_on(n_xz, dev)
        u = self.u0
        for k, dz in enumerate(dzs):
            if n_t is not None:
                u = u * torch.exp(-1j * k0 * (n_t[nz - 1 - k] - self.n) * dz)
            u = torch.fft.ifft(torch.exp(-1j * kzj * dz) * torch.fft.fft(u))
            u = _write(out, k, u, edge)
        self.u = out
        return self.u

    def bpm_back_propagation(self, n_xz=None, **kw):
        """Phase-conjugate back propagation: the conjugated exit field
        retracing the scene (the conjugate of the exact inverse steps).
        Store the exit field in ``self.u0``."""
        u = self.bpm_inverse(n_xz=n_xz, **kw)
        self.u = torch.conj(u).resolve_conj()
        return self.u

    def polychromatic(self, u0_of_wl, wavelengths, spectrum=None,
                      method="bpm", n_xz=None, **kw):
        """Incoherent polychromatic propagation: the spectrum-weighted sum
        of |u(x, z; wl)|² over wavelengths; returns sqrt(I)."""
        wavelengths = np.atleast_1d(np.asarray(wavelengths, float))
        if spectrum is None:
            spectrum = np.ones_like(wavelengths)
        spectrum = np.asarray(spectrum, float)
        I_total = 0.0
        for wl, w in zip(wavelengths, spectrum):
            f = ScalarFieldXZ(self.x, self.z, wl, self.n, device=self.device)
            f.incident_field(u0_of_wl(wl))
            if method == "bpm":
                u = f.bpm(n_xz=n_xz, **kw)
            elif method == "wpm":
                u = f.wpm(n_xz=n_xz, **kw)
            else:
                u = f.propagate()
            I_total = I_total + float(w) * torch.abs(u) ** 2
        self.u = torch.sqrt(I_total)
        return self.u

    def intensity(self):
        return torch.abs(self.u) ** 2

    def profile_longitudinal(self, kind="intensity", x0=0.0):
        """Longitudinal profile through x = x0: a :class:`ScalarFieldZ`
        when kind='field', else the requested NumPy array."""
        ix = int(np.argmin(np.abs(self.x - x0)))
        u = _host(self.u[:, ix])
        if kind == "field":
            from .fieldz import ScalarFieldZ
            out = ScalarFieldZ(self.z, self.wavelength, self.n)
            out.u = u
            return out
        return _profile_kind(u, kind, field_ok=False)

    def profile_transversal(self, kind="intensity", z0=0.0):
        """Transversal profile at z = z0 (NumPy)."""
        iz = int(np.argmin(np.abs(self.z - z0)))
        u = _host(self.u[iz, :])
        return _profile_kind(u, kind, field_ok=True)


def _profile_kind(u, kind, field_ok):
    if kind == "field" and field_ok:
        return u
    if kind == "intensity":
        return np.abs(u) ** 2
    if kind == "amplitude":
        return np.abs(u)
    if kind == "phase":
        return np.angle(u)
    raise ValueError(f"unknown profile kind {kind!r}")


_WPM_LEVELS_BOUND = 32


def _wpm_levels(n_scene, levels, device=None):
    """The WPM index levels as a complex NumPy array: ``levels``, or the
    unique values of the scene rounded to 9 decimals (sorted, complex
    ones by real then imaginary part). Warns above 32 levels: the kernel
    batch is O(n_levels · grid)."""
    if levels is None:
        n = _as_tensor(n_scene, device)
        if n.is_complex():
            pairs = torch.stack([torch.round(n.real, decimals=9),
                                 torch.round(n.imag, decimals=9)], -1)
            u = _host(torch.unique(pairs.reshape(-1, 2), dim=0))
            levels = u[:, 0] + 1j * u[:, 1]
        else:
            levels = _host(torch.unique(torch.round(n, decimals=9)))
    levels = np.asarray(levels, dtype=complex)
    if len(levels) > _WPM_LEVELS_BOUND:
        import warnings
        warnings.warn(
            f"WPM scene has {len(levels)} distinct index levels; the "
            f"kernel batch is O(n_levels * grid). Discretize the scene "
            f"(scenes.discretize_refraction_index) or pass explicit "
            f"`levels=` to bound memory.", RuntimeWarning, stacklevel=4)
    return levels


def _level_index(n_plane, levels):
    """Per pixel, the index of the level nearest to n (|n − level|, the
    first on a tie): the position of the one in JAX's one-hot partition."""
    d = torch.abs(n_plane.to(torch.complex128)[..., None] - levels)
    return torch.argmin(d, dim=-1)


def _edge_filter(shape, axes_coords, pow_edge=80):
    """Super-Gaussian absorbing frame (host NumPy): suppresses
    wrap-around at the periodic FFT boundary."""
    filt = np.ones(shape)
    for ax, c in enumerate(axes_coords):
        c = np.asarray(c)
        half = (c[-1] - c[0]) / 2
        center = (c[-1] + c[0]) / 2
        prof = np.exp(-((c - center) / half) ** pow_edge)
        sh = [1] * len(shape)
        sh[ax] = len(c)
        filt = filt * prof.reshape(sh)
    return filt


class ScalarFieldXYZ:
    """Scalar field in a full (x, y, z) volume, stored (nz, nx, ny) on
    ``device``: the 2D transverse field propagated over a z-stack, plus
    split-step BPM, WPM and PWD through a refractive-index volume."""

    def __init__(self, x, y, z, wavelength, n_background=1.0, device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.z = np.asarray(z)
        self.wavelength = wavelength
        self.n = n_background
        self.u = None           # (nz, nx, ny)

    def incident_field(self, u0):
        self.u0 = _complex(u0, self.device)
        return self

    def propagate(self):
        """The angular spectrum of ``u0`` at every z."""
        self.u = _asm_planes(self.u0, (self.x, self.y), self.wavelength,
                             self.z, self.n)
        return self.u

    def _edge(self, has_edges, pow_edge):
        return _edge((self.x, self.y), (len(self.x), len(self.y)),
                     has_edges, pow_edge, self.device)

    def bpm(self, n_volume=None, has_edges=True, pow_edge=80):
        """Split-step beam propagation through n(x, y, z).

        n_volume: (nz, nx, ny) refractive-index stack (a tensor, read one
        plane a step; None = uniform background, which reduces to the
        angular spectrum). Each z step applies the homogeneous propagator
        then the phase screen e^{i k0 (n − n0) dz}. Plane k lies at
        ``self.z[k]`` (the first step covers 0 -> z[0]); non-uniform z
        grids are supported."""
        self.u = _bpm_stack(self.u0, (self.x, self.y), self.z,
                            self.wavelength, self.n, n_volume,
                            self._edge(has_edges, pow_edge))
        return self.u

    def wpm(self, n_volume=None, levels=None, has_edges=True,
            pow_edge=80):
        """Volume wave propagation method (Schmidt kernel): the exact
        homogeneous step per index level, one batched (n_levels, nx, ny)
        inverse FFT per step, then the nearest level's field per pixel."""
        self.u = _wpm_stack(self.u0, (self.x, self.y), self.z,
                            self.wavelength, self.n, n_volume, levels,
                            self._edge(has_edges, pow_edge))
        return self.u

    def pwd(self, n=None):
        """Plane-wave-decomposition volume propagation at a single scalar
        index (the one-level case of :meth:`wpm`)."""
        self.u = _pwd_stack(self.u0, (self.x, self.y), self.z,
                            self.wavelength, self.n if n is None else n)
        return self.u

    # ------------------------------------------------- volume utilities

    def to_xy(self, z0):
        """Transverse cut nearest z0 -> (nx, ny)."""
        return self.u[int(np.argmin(np.abs(self.z - z0)))]

    def to_xz(self, y0=0.0):
        """(z, x) sheet at the y nearest y0."""
        return self.u[:, :, int(np.argmin(np.abs(self.y - y0)))]

    def to_yz(self, x0=0.0):
        """(z, y) sheet at the x nearest x0."""
        return self.u[:, int(np.argmin(np.abs(self.x - x0))), :]

    def on_axis(self, x0=0.0, y0=0.0):
        """u(z) along the propagation axis."""
        ix = int(np.argmin(np.abs(self.x - x0)))
        iy = int(np.argmin(np.abs(self.y - y0)))
        return self.u[:, ix, iy]

    def average_intensity(self):
        """Mean transverse intensity per z plane."""
        return torch.mean(torch.abs(self.u) ** 2, dim=(1, 2))

    def beam_widths(self):
        """Second-moment 1/e widths (wx(z), wy(z))."""
        I = torch.abs(self.u) ** 2
        W = torch.sum(I, dim=(1, 2))
        xg = torch.as_tensor(self.x, device=self.device)[None, :, None]
        yg = torch.as_tensor(self.y, device=self.device)[None, None, :]
        cx = torch.sum(I * xg, dim=(1, 2)) / W
        cy = torch.sum(I * yg, dim=(1, 2)) / W
        vx = torch.sum(I * (xg - cx[:, None, None]) ** 2, dim=(1, 2)) / W
        vy = torch.sum(I * (yg - cy[:, None, None]) ** 2, dim=(1, 2)) / W
        return torch.sqrt(2 * vx), torch.sqrt(2 * vy)

    def intensity(self):
        return torch.abs(self.u) ** 2


def _ez_spectrum(Exk, Eyk, kx, ky, kz, k0, ring_tol=1e-3):
    """Ez(kx,ky) = −(kx Ex + ky Ey)/kz from transversality k·E = 0;
    modes within ``ring_tol * k0`` of the cutoff ring |kz| -> 0 are
    zeroed instead of amplifying noise by 1/kz."""
    ring = torch.abs(kz) < ring_tol * k0
    one = torch.ones((), dtype=kz.dtype, device=kz.device)
    val = -(kx * Exk + ky * Eyk) / torch.where(ring, one, kz)
    return torch.where(ring, torch.zeros_like(val), val)


class VectorFieldXY:
    """Paraxial vector field (Ex, Ey) on a transverse plane, on
    ``device``, with the longitudinal Ez reconstructed from
    transversality k·E = 0 -> Ez(kx, ky) = −(kx Ex + ky Ey)/kz."""

    def __init__(self, x, y, wavelength, n_background=1.0, device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.wavelength = wavelength
        self.n = n_background
        self.Ex = self.Ey = self.Ez = None

    def incident_field(self, Ex, Ey):
        self.Ex = _complex(Ex, self.device)
        self.Ey = _complex(Ey, self.device)
        self._fill_Ez()
        return self

    def _kgrids(self):
        kx = 2 * np.pi * _freq(self.x)
        ky = 2 * np.pi * _freq(self.y)
        return (torch.as_tensor(kx, device=self.device),
                torch.as_tensor(ky, device=self.device))

    def _kz(self, kx, ky):
        """Complex kz = sqrt(k0² − kx² − ky² + 0i): real for propagating
        modes, +i|kz| for evanescent ones."""
        k0 = 2 * np.pi * self.n / self.wavelength
        kz2 = k0 ** 2 - kx[:, None] ** 2 - ky[None, :] ** 2
        return torch.sqrt(kz2 + 0j)

    def _fill_Ez(self):
        kx, ky = self._kgrids()
        kz = self._kz(kx, ky)
        Exk = torch.fft.fft2(self.Ex)
        Eyk = torch.fft.fft2(self.Ey)
        self.Ez = torch.fft.ifft2(_ez_spectrum(
            Exk, Eyk, kx[:, None], ky[None, :], kz,
            2 * np.pi * self.n / self.wavelength))

    def propagate(self, z):
        """Angular spectrum on each Cartesian component; Ez re-derived."""
        self.Ex = _asm_2d(self.Ex, self.x, self.y, self.wavelength, z,
                          self.n)
        self.Ey = _asm_2d(self.Ey, self.x, self.y, self.wavelength, z,
                          self.n)
        self._fill_Ez()
        return self

    def vrs(self, z):
        """Vectorial Rayleigh-Sommerfeld propagation (Ye et al., Laser
        Phys. Lett. 10, 065004 (2013)): quadrature RS with the z-obliquity
        kernel on Ex/Ey, and Ez from the RS-0 kernel acting on
        (X Ex + Y Ey)/r."""
        x, y, wl, n = self.x, self.y, self.wavelength, self.n
        X, Y = np.meshgrid(x, y, indexing="ij")
        dev = self.device
        r = torch.as_tensor(np.sqrt(X ** 2 + Y ** 2 + z ** 2), device=dev)
        uz = (self.Ex * torch.as_tensor(X, device=dev)
              + self.Ey * torch.as_tensor(Y, device=dev)) / r
        self.Ex, self.quality = _rs_2d(self.Ex, x, y, wl, z, n, kind="z")
        self.Ey, _ = _rs_2d(self.Ey, x, y, wl, z, n, kind="z")
        self.Ez, _ = _rs_2d(uz, x, y, wl, z, n, kind="0")
        return self

    def _aplanatic(self, radius, focal):
        """Richards-Wolf geometry factors for an aplanatic lens of
        ``radius``/``focal`` on this grid: (rotation stack M(θ, φ), pupil
        mask, sinθ_max), M and the pupil as tensors."""
        X, Y = np.meshgrid(self.x, self.y, indexing="ij")
        sin_t_max = radius / np.sqrt(radius ** 2 + focal ** 2)
        r = np.sqrt(X ** 2 + Y ** 2)
        phi = np.arctan2(Y, X)
        theta = r / focal
        ct, st = np.cos(theta), np.sin(theta)
        cp, sp = np.cos(phi), np.sin(phi)
        M = np.empty(X.shape + (3, 3))
        M[..., 0, 0] = cp ** 2 * ct + sp ** 2
        M[..., 0, 1] = sp * cp * ct - sp * cp
        M[..., 0, 2] = -st * cp
        M[..., 1, 0] = M[..., 0, 1]
        M[..., 1, 1] = sp ** 2 * ct + cp ** 2
        M[..., 1, 2] = -st * sp
        M[..., 2, 0] = st * cp
        M[..., 2, 1] = st * sp
        M[..., 2, 2] = ct
        pupil = (r <= radius).astype(float)
        return (torch.as_tensor(M, device=self.device),
                torch.as_tensor(pupil, device=self.device), sin_t_max)

    def vfft(self, radius, focal, remove0=True, shift=True):
        """High-NA aplanatic-lens vector focusing: rotate (Ex, Ey, Ez)
        onto the converging wavefront, apodize by sqrt(cosθ) and the
        aplanatic 1/sqrt(1 − sin²θ_max (u² + v²)) factor, and FFT to the
        focal region. Updates the field in place and returns self."""
        M, pupil, stm = self._aplanatic(radius, focal)
        X, Y = np.meshgrid(self.x, self.y, indexing="ij")
        dev = self.device
        uv2 = torch.as_tensor((X ** 2 + Y ** 2) / radius ** 2, device=dev)
        G = pupil / torch.sqrt(torch.clamp(1.0 - stm ** 2 * uv2, min=1e-12))
        theta = torch.as_tensor(np.hypot(X, Y) / focal, device=dev)
        apod = torch.sqrt(torch.abs(torch.cos(theta)))
        E = torch.stack([self.Ex * pupil, self.Ey * pupil,
                         self.Ez * pupil], dim=-1)
        E0 = torch.einsum("xyij,xyj->xyi", M.to(torch.complex128), E)
        factor = -1j * stm ** 2 / (focal * self.wavelength)
        comps = []
        for i in range(3):
            Ek = torch.fft.fft2(apod * G * E0[..., i])
            if remove0 and i < 2:
                Ek[0, 0] = 0.0
            if shift:
                Ek = torch.fft.fftshift(Ek)
            comps.append(factor * Ek)
        self.Ex, self.Ey, self.Ez = comps
        return self

    def ivfft(self, radius, focal, shift=True):
        """Inverse of :meth:`vfft`: inverse-FFT the focal field back to
        the pupil, undo the aplanatic weighting, and rotate the spherical
        wavefront back to collimated Cartesian components (θ -> −θ)."""
        M, pupil, stm = self._aplanatic(radius, -focal)
        X, Y = np.meshgrid(self.x, self.y, indexing="ij")
        uv2 = torch.as_tensor((X ** 2 + Y ** 2) / radius ** 2,
                              device=self.device)
        G = pupil * torch.sqrt(torch.clamp(1.0 - stm ** 2 * uv2, min=0.0))
        factor = 1.0 / (-1j * stm ** 2 / (focal * self.wavelength))
        comps = []
        for E in (self.Ex, self.Ey, self.Ez):
            Ek = torch.fft.ifftshift(E) if shift else E
            comps.append(factor * torch.fft.ifft2(Ek) * G)
        Es = torch.stack(comps, dim=-1)
        E0 = torch.einsum("xyij,xyj->xyi", M.to(torch.complex128), Es)
        self.Ex, self.Ey, self.Ez = (E0[..., 0] * pupil,
                                     E0[..., 1] * pupil,
                                     E0[..., 2] * pupil)
        return self

    def intensity(self):
        return (torch.abs(self.Ex) ** 2 + torch.abs(self.Ey) ** 2
                + torch.abs(self.Ez) ** 2)

    def stokes(self):
        """(S0, S1, S2, S3) transverse Stokes parameters (S3 =
        −2 Im(Ex Ey*))."""
        return _stokes(self.Ex, self.Ey)


def _stokes(Ex, Ey):
    S0 = torch.abs(Ex) ** 2 + torch.abs(Ey) ** 2
    S1 = torch.abs(Ex) ** 2 - torch.abs(Ey) ** 2
    S2 = 2 * torch.real(Ex * torch.conj(Ey))
    S3 = -2 * torch.imag(Ex * torch.conj(Ey))
    return S0, S1, S2, S3


class VectorFieldXYZ:
    """Vector field over a full (x, y, z) volume, each component stored
    (nz, nx, ny) on ``device``: the transverse components' spectra taken
    once and propagated to every plane by the angular spectrum, with Ez
    from transversality per plane. Free space or a uniform background;
    for inhomogeneous isotropic media run the transverse components
    through ``ScalarFieldXYZ.bpm``."""

    def __init__(self, x, y, z, wavelength, n_background=1.0, device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.z = np.asarray(z)
        self.wavelength = wavelength
        self.n = n_background
        self.Ex = self.Ey = self.Ez = None      # (nz, nx, ny)

    def incident_field(self, Ex, Ey):
        self.Ex0 = _complex(Ex, self.device)
        self.Ey0 = _complex(Ey, self.device)
        return self

    def propagate(self):
        """Fill the three (nz, nx, ny) stacks, :data:`_PLANE_CHUNK` planes
        per batched inverse transform."""
        dev = self.device
        kx = torch.as_tensor(2 * np.pi * _freq(self.x), device=dev)[:, None]
        ky = torch.as_tensor(2 * np.pi * _freq(self.y), device=dev)[None, :]
        k0 = 2 * np.pi * self.n / self.wavelength
        kz2 = k0 ** 2 - kx ** 2 - ky ** 2
        kz_prop = torch.sqrt(torch.abs(kz2))
        kz_c = torch.sqrt(kz2 + 0j)
        Exk0 = torch.fft.fft2(self.Ex0)
        Eyk0 = torch.fft.fft2(self.Ey0)
        zs = torch.as_tensor(np.asarray(self.z, dtype=float), device=dev)
        shape = (len(zs),) + tuple(self.Ex0.shape)
        stacks = [torch.empty(shape, dtype=torch.complex128, device=dev)
                  for _ in range(3)]
        for a in range(0, len(zs), _PLANE_CHUNK):
            H = _asm_H(kz2, kz_prop, zs[a:a + _PLANE_CHUNK])
            Exk = Exk0 * H
            Eyk = Eyk0 * H
            Ezk = _ez_spectrum(Exk, Eyk, kx, ky, kz_c, k0)
            for s, Ek in zip(stacks, (Exk, Eyk, Ezk)):
                s[a:a + _PLANE_CHUNK] = torch.fft.ifft2(Ek)
        self.Ex, self.Ey, self.Ez = stacks
        return self

    def to_xy(self, z0):
        """Nearest-plane VectorFieldXY view at z ~ z0."""
        k = int(np.argmin(np.abs(self.z - z0)))
        out = VectorFieldXY(self.x, self.y, self.wavelength, self.n,
                            device=self.device)
        out.Ex, out.Ey, out.Ez = self.Ex[k], self.Ey[k], self.Ez[k]
        return out

    def intensity(self):
        """(nz, nx, ny) total intensity |Ex|² + |Ey|² + |Ez|²."""
        return (torch.abs(self.Ex) ** 2 + torch.abs(self.Ey) ** 2
                + torch.abs(self.Ez) ** 2)

    def on_axis(self, x0=0.0, y0=0.0):
        """(|Ex|²+|Ey|², |Ez|²) along z at the nearest (x0, y0)."""
        i = int(np.argmin(np.abs(self.x - x0)))
        j = int(np.argmin(np.abs(self.y - y0)))
        It = (torch.abs(self.Ex[:, i, j]) ** 2
              + torch.abs(self.Ey[:, i, j]) ** 2)
        Iz = torch.abs(self.Ez[:, i, j]) ** 2
        return It, Iz

    def stokes(self):
        """Transverse Stokes stacks, each (nz, nx, ny)."""
        return _stokes(self.Ex, self.Ey)


def laguerre_gauss_beam(field, w0, l=1, p=0, x0=0.0, y0=0.0,
                        amplitude=1.0):
    """Laguerre-Gaussian LG_{p,l} vortex source at the waist plane:
    azimuthal phase e^{i l phi} carrying orbital angular momentum l hbar
    per photon (host SciPy, then the field's device)."""
    from scipy.special import genlaguerre
    X, Y = np.meshgrid(field.x, field.y, indexing="ij")
    r2 = (X - x0) ** 2 + (Y - y0) ** 2
    phi = np.arctan2(Y - y0, X - x0)
    rho = 2.0 * r2 / w0 ** 2
    L = genlaguerre(p, abs(l))(rho)
    u = (amplitude * (np.sqrt(r2) * np.sqrt(2.0) / w0) ** abs(l) * L
         * np.exp(-r2 / w0 ** 2) * np.exp(1j * l * phi))
    field.u = torch.as_tensor(u, device=field.device)
    return field


# ---------------------------------------------------------------------------
# mask zoo on fields (transmissions built on the host, applied on the device)
# ---------------------------------------------------------------------------

def _XY(field):
    return np.meshgrid(field.x, field.y, indexing="ij")


def square(field, size, x0=0.0, y0=0.0):
    """Square aperture."""
    X, Y = _XY(field)
    t = (np.abs(X - x0) <= size / 2) & (np.abs(Y - y0) <= size / 2)
    return _times(field, t.astype(float))


def ring(field, r_in, r_out, x0=0.0, y0=0.0):
    """Annular aperture."""
    X, Y = _XY(field)
    r = np.hypot(X - x0, Y - y0)
    t = (r >= r_in) & (r <= r_out)
    return _times(field, t.astype(float))


def cross(field, width, length=None):
    """Cross aperture."""
    X, Y = _XY(field)
    L = length if length is not None else np.inf
    t = ((np.abs(X) <= width / 2) & (np.abs(Y) <= L / 2)) | \
        ((np.abs(Y) <= width / 2) & (np.abs(X) <= L / 2))
    return _times(field, t.astype(float))


def super_gauss(field, w, power=8, x0=0.0, y0=0.0):
    """Super-Gaussian soft aperture."""
    X, Y = _XY(field)
    r2 = (X - x0) ** 2 + (Y - y0) ** 2
    return _times(field, np.exp(-(r2 / w ** 2) ** (power / 2)))


def prism(field, angle_x=0.0, angle_y=0.0):
    """Thin prism: linear phase ramp."""
    X, Y = _XY(field)
    field.u = field.u * _exp_host(
        field, 1j * field.k * (np.sin(angle_x) * X + np.sin(angle_y) * Y))
    return field


def axicon(field, angle, n_refr=1.5):
    """Conical lens: radial phase ramp producing a Bessel-like zone."""
    X, Y = _XY(field)
    r = np.hypot(X, Y)
    kr = field.k * (n_refr - 1.0) * np.tan(angle)
    field.u = field.u * _exp_host(field, -1j * kr * r)
    return field


def fresnel_lens(field, focal, levels=2):
    """Binary (or multilevel) Fresnel zone lens: the ideal quadratic
    phase quantized to ``levels`` steps."""
    X, Y = _XY(field)
    r2 = X ** 2 + Y ** 2
    phi = -field.k * r2 / (2 * focal)
    phi_q = (np.floor((phi / (2 * np.pi) % 1.0) * levels) / levels
             * 2 * np.pi)
    field.u = field.u * _exp_host(field, 1j * phi_q)
    return field


def sine_grating(field, period, depth=np.pi, x0=0.0):
    """Thin sinusoidal phase grating t = exp(i depth/2 sin(2 pi x/p))."""
    X, _ = _XY(field)
    field.u = field.u * _exp_host(
        field, 1j * depth / 2 * np.sin(2 * np.pi * (X - x0) / period))
    return field


def ronchi_grating(field, period, x0=0.0, fill=0.5):
    """Binary amplitude (Ronchi) grating."""
    X, _ = _XY(field)
    t = ((X - x0) / period % 1.0) < fill
    return _times(field, t.astype(float))


def binary_grating(field, period, amin=0.0, amax=1.0, phase=0.0, fill=0.5):
    """General binary amplitude/phase grating."""
    X, _ = _XY(field)
    t = (X / period % 1.0) < fill
    amp = np.where(t, amax, amin)
    ph = np.where(t, phase, 0.0)
    return _times(field, amp * np.exp(1j * ph))


def blazed_grating(field, period, phase_max=2 * np.pi):
    """Sawtooth phase grating; phase_max = 2 pi throws all energy into
    the +1 order."""
    X, _ = _XY(field)
    field.u = field.u * _exp_host(
        field, 1j * phase_max * ((X / period) % 1.0))
    return field


def forked_grating(field, period, l=1, depth=np.pi):
    """Fork hologram: binary grating with an embedded l-charge
    dislocation."""
    X, Y = _XY(field)
    phi = np.arctan2(Y, X)
    arg = 2 * np.pi * X / period - l * phi
    t = np.cos(arg) > 0
    return _times(field, t.astype(float))


# ---------------------------------------------------------------------------
# source zoo
# ---------------------------------------------------------------------------

def spherical_wave(field, z0, x0=0.0, y0=0.0, amplitude=1.0):
    """Paraxial spherical wave from a point at distance z0 behind the
    plane."""
    X, Y = _XY(field)
    r2 = (X - x0) ** 2 + (Y - y0) ** 2
    field.u = torch.as_tensor(
        amplitude * np.exp(1j * field.k * r2 / (2 * z0)), device=field.device)
    return field


def hermite_gauss_beam(field, w0, m=0, n=0, amplitude=1.0):
    """HG_{mn} mode at the waist."""
    from scipy.special import eval_hermite
    X, Y = _XY(field)
    s = np.sqrt(2.0) / w0
    u = (amplitude * eval_hermite(m, s * X) * eval_hermite(n, s * Y)
         * np.exp(-(X ** 2 + Y ** 2) / w0 ** 2))
    field.u = torch.as_tensor(u.astype(complex), device=field.device)
    return field


def bessel_beam(field, kr, l=0, amplitude=1.0):
    """Nondiffracting Bessel beam J_l(kr r) e^{i l phi}."""
    from scipy.special import jv
    X, Y = _XY(field)
    r = np.hypot(X, Y)
    phi = np.arctan2(Y, X)
    field.u = torch.as_tensor(amplitude * jv(l, kr * r)
                              * np.exp(1j * l * phi), device=field.device)
    return field


def vortex_beam(field, w0, l=1, amplitude=1.0):
    """Gaussian with an embedded l-charge vortex."""
    return laguerre_gauss_beam(field, w0, l=l, p=0, amplitude=amplitude)


def plane_waves_several_inclined(field, angles, amplitude=1.0):
    """Coherent superposition of tilted plane waves."""
    X, _ = _XY(field)
    u = np.zeros_like(X, dtype=complex)
    for th in np.atleast_1d(angles):
        u += amplitude * np.exp(1j * field.k * np.sin(th) * X)
    field.u = torch.as_tensor(u, device=field.device)
    return field


Scalar_field_XZ = ScalarFieldXZ
Scalar_field_XYZ = ScalarFieldXYZ


# ----------------------------------------------------------------------
# drawing conveniences: every field class's draw()/draw_profile, through
# utils.style's Agg-safe matplotlib (imported when a method is called)
# ----------------------------------------------------------------------

def _field_view(u, kind, logarithm=False, normalize=False, cut_value=None):
    """The view of a complex field that every drawing path shares
    (beam.drawing.field_view)."""
    from .drawing import field_view
    return field_view(u, kind, logarithm=logarithm, normalize=normalize,
                      cut_value=cut_value)


def _draw_1d(x, u, kind, logarithm, normalize, cut_value, filename,
             xlabel="x"):
    from ..utils.style import _mpl
    plt = _mpl()
    data = _field_view(u, kind, logarithm, normalize, cut_value)
    fig, ax = plt.subplots(figsize=(4.5, 3))
    ax.plot(_host(x), data)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(kind)
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=150)
        plt.close(fig)
    return fig, ax


def _draw_2d(x, y, u, kind, logarithm, normalize, cut_value, filename,
             xlabel="x", ylabel="y"):
    from ..utils.style import _mpl
    plt = _mpl()
    data = _field_view(u, kind, logarithm, normalize, cut_value)
    fig, ax = plt.subplots(figsize=(4.5, 3.6))
    ext = [float(np.min(x)), float(np.max(x)),
           float(np.min(y)), float(np.max(y))]
    im = ax.imshow(data.T, origin="lower", extent=ext, aspect="auto",
                   cmap="inferno" if kind != "phase" else "twilight")
    fig.colorbar(im, ax=ax, label=kind)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=150)
        plt.close(fig)
    return fig, ax


def _add_draw_methods():
    def draw_x(self, kind="intensity", logarithm=False, normalize=False,
               cut_value=None, filename=""):
        """Plot the 1D field."""
        return _draw_1d(self.x, self.u, kind, logarithm, normalize,
                        cut_value, filename)

    def draw_xy(self, kind="intensity", logarithm=False, normalize=False,
                cut_value=None, filename=""):
        """Plot the 2D field."""
        return _draw_2d(self.x, self.y, self.u, kind, logarithm,
                        normalize, cut_value, filename)

    def draw_profile(self, point1, point2, npoints=256, kind="intensity",
                     filename=""):
        """Field profile along the segment point1 -> point2 by bilinear
        interpolation (host SciPy). Returns (s, profile) as NumPy."""
        x0, y0 = point1
        x1, y1 = point2
        ts = np.linspace(0.0, 1.0, npoints)
        xs = x0 + ts * (x1 - x0)
        ys = y0 + ts * (y1 - y0)
        from scipy.interpolate import RegularGridInterpolator
        u = _host(self.u)
        itp_r = RegularGridInterpolator((self.x, self.y), u.real)
        itp_i = RegularGridInterpolator((self.x, self.y), u.imag)
        pts = np.stack([xs, ys], axis=1)
        prof = itp_r(pts) + 1j * itp_i(pts)
        s = np.hypot(xs - x0, ys - y0)
        if filename:
            _draw_1d(s, prof, kind, False, False, None, filename,
                     xlabel="s")
        return s, prof

    def draw_xz(self, kind="intensity", logarithm=False, normalize=False,
                cut_value=None, filename=""):
        """Plot the XZ field (rows follow z, columns x)."""
        return _draw_2d(self.z, self.x, self.u, kind, logarithm, normalize,
                        cut_value, filename, xlabel="z", ylabel="x")

    def draw_vector(self, kind="intensity", logarithm=False,
                    normalize=False, cut_value=None, filename=""):
        """Panel per component (Ex, Ey, Ez) plus the total intensity."""
        from ..utils.style import _mpl
        plt = _mpl()
        comps = [("Ex", self.Ex), ("Ey", self.Ey)]
        if getattr(self, "Ez", None) is not None:
            comps.append(("Ez", self.Ez))
        fig, axs = plt.subplots(1, len(comps) + 1,
                                figsize=(3.2 * (len(comps) + 1), 3))
        ext = [float(np.min(self.x)), float(np.max(self.x)),
               float(np.min(self.y)), float(np.max(self.y))]
        for a, (name, E) in zip(axs, comps):
            data = _field_view(E, kind, logarithm, normalize, cut_value)
            a.imshow(data.T, origin="lower", extent=ext, aspect="auto",
                     cmap="inferno" if kind != "phase" else "twilight")
            a.set_title(f"{name} {kind}")
        tot = _field_view(np.sqrt(_host(self.intensity())),
                          "intensity", logarithm, normalize, cut_value)
        axs[-1].imshow(tot.T, origin="lower", extent=ext, aspect="auto",
                       cmap="inferno")
        axs[-1].set_title("total intensity")
        fig.tight_layout()
        if filename:
            fig.savefig(filename, dpi=150)
            plt.close(fig)
        return fig, axs

    ScalarFieldX.draw = draw_x
    ScalarFieldXY.draw = draw_xy
    ScalarFieldXY.draw_profile = draw_profile
    ScalarFieldXZ.draw = draw_xz
    VectorFieldXY.draw = draw_vector


_add_draw_methods()


def draw_several_fields(fields, titles=(), kind="intensity",
                        logarithm=False, normalize=False, filename=""):
    """One row of panels, one 2D field each. Returns (fig, axes)."""
    from ..utils.style import _mpl
    plt = _mpl()
    n = len(fields)
    fig, axs = plt.subplots(1, n, figsize=(3.4 * n, 3))
    axs = np.atleast_1d(axs)
    for k, (f, a) in enumerate(zip(fields, axs)):
        data = _field_view(f.u, kind, logarithm, normalize, None)
        ext = [float(np.min(f.x)), float(np.max(f.x)),
               float(np.min(f.y)), float(np.max(f.y))]
        a.imshow(data.T, origin="lower", extent=ext, aspect="auto",
                 cmap="inferno" if kind != "phase" else "twilight")
        if k < len(titles):
            a.set_title(titles[k])
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=150)
        plt.close(fig)
    return fig, axs


# ----------------------------------------------------------- MTF utilities
def mtf_ideal(frequencies, wavelength, diameter, focal, kind="2D"):
    """Diffraction-limited MTF of an ideal lens at the given spatial
    frequencies in lines/mm (1D slit: triangle; 2D circular pupil: the
    autocorrelation-of-disks arc formula). Returns (mtf,
    cutoff_frequency_lines_per_mm), NumPy."""
    f_number = focal / diameter
    f_cut = 1000.0 / (wavelength * f_number)
    fn = np.abs(np.asarray(frequencies, dtype=float)) / f_cut
    if kind == "1D":
        mtf = np.clip(1.0 - fn, 0.0, None)
    elif kind == "2D":
        fn_c = np.minimum(fn, 1.0)
        phi = np.arccos(fn_c)
        mtf = np.where(fn <= 1.0,
                       (2.0 / np.pi) * (phi - np.cos(phi) * np.sin(phi)),
                       0.0)
    else:
        raise ValueError(f"kind {kind!r}")
    return mtf, f_cut


def _mtf_1d(self):
    """Normalized MTF of the 1D field: |FT of the intensity PSF|,
    normalized at zero frequency. Returns (fx_lines_per_mm, mtf), NumPy."""
    dx = self.x[1] - self.x[0]
    psf = np.abs(_host(self.u)) ** 2
    otf = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(psf)))
    mtf = np.abs(otf)
    mtf = mtf / mtf[len(mtf) // 2]
    fx = 1000.0 * np.fft.fftshift(np.fft.fftfreq(len(self.x), dx))
    return fx, mtf


def _mtf_2d(self):
    """2D MTF (NumPy). Returns (fx, fy, mtf)."""
    dx = self.x[1] - self.x[0]
    dy = self.y[1] - self.y[0]
    psf = np.abs(_host(self.u)) ** 2
    otf = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(psf)))
    mtf = np.abs(otf)
    mtf = mtf / mtf[mtf.shape[0] // 2, mtf.shape[1] // 2]
    fx = 1000.0 * np.fft.fftshift(np.fft.fftfreq(len(self.x), dx))
    fy = 1000.0 * np.fft.fftshift(np.fft.fftfreq(len(self.y), dy))
    return fx, fy, mtf


ScalarFieldX.MTF = _mtf_1d
ScalarFieldXY.MTF = _mtf_2d

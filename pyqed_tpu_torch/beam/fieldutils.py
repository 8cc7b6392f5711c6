"""Field post-processing and analysis utilities for the beam layer.

PyTorch counterpart of ``pyqed_tpu/beam/fieldutils.py``: amplitude and
phase, binarize and discretize, edges of binary masks, focus search, line
profiles, rotation, pasting, the XZ scene analysis and the edge filters.
The field math runs on the device of the field tensor; the coordinate
bookkeeping and the point-cloud analyses stay on the host, as in the JAX
package.

Interpolation is JAX's ``map_coordinates(order=1)`` with its default
``mode='constant'``, ``cval=0``: an explicit bilinear gather over the four
neighbours, in the same order, where a neighbour outside the grid adds
nothing (:func:`_bilinear`).

Array arguments that are tensors keep their device; NumPy arguments go to
the card (``device=None``), which raises without one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..utils.style import _host


# ------------------------------------------------------------------
# host/device helpers shared by the beam modules
# ------------------------------------------------------------------

def _device_of(*arrays, device=None):
    """``device`` if given, else the device of the first tensor among
    ``arrays``, else the card."""
    if device is not None:
        return resolve_device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def _as_tensor(a, device=None, dtype=None):
    """``a`` as a tensor on ``device`` (see :func:`_device_of`)."""
    dev = _device_of(a, device=device)
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    a = np.asarray(a)
    if not a.flags.writeable or any(s < 0 for s in a.strides):
        a = a.copy()
    return torch.as_tensor(a, device=dev, dtype=dtype)


def _complex(a, device=None):
    """``a`` as a complex128 tensor on ``device``."""
    return _as_tensor(a, device, torch.complex128)


def _bilinear(img, ci, cj):
    """JAX's ``map_coordinates(img, [ci, cj], order=1)`` (mode 'constant',
    cval 0) for a real 2-D tensor: the four neighbours (lower/upper along
    each axis, in that order), weights multiplied per axis, a neighbour
    outside the grid contributing zero, the four terms summed left to
    right."""
    n0, n1 = img.shape
    axes = []
    for c, size in ((ci, n0), (cj, n1)):
        lower = torch.floor(c)
        upper_w = c - lower
        lower_w = 1 - upper_w
        idx = lower.to(torch.int64)
        axes.append([(idx, lower_w, size), (idx + 1, upper_w, size)])
    out = None
    for (i, wi, si) in axes[0]:
        for (j, wj, sj) in axes[1]:
            valid = (i >= 0) & (i < si) & (j >= 0) & (j < sj)
            val = img[i.clamp(0, si - 1), j.clamp(0, sj - 1)]
            term = (wi * wj) * torch.where(valid, val, torch.zeros_like(val))
            out = term if out is None else out + term
    return out


# ------------------------------------------------------------------
# amplitude / phase decomposition
# ------------------------------------------------------------------

def get_amplitude(u):
    """|u| as a real tensor."""
    return torch.abs(_as_tensor(u))


def get_phase(u, keep_amplitude=False):
    """arg(u); with ``keep_amplitude`` returns |u|·e^{i arg u}."""
    u = _as_tensor(u)
    ph = torch.angle(u)
    return torch.abs(u) * torch.exp(1j * ph) if keep_amplitude else ph


def remove_phase(u, sign=False):
    """Strip the phase, keeping amplitude; with ``sign`` the amplitude
    keeps the cos-sign of the phase."""
    u = _as_tensor(u)
    a = torch.abs(u)
    if sign:
        a = a * torch.sign(torch.cos(torch.angle(u)))
    return a.to(torch.complex128)


# ------------------------------------------------------------------
# binarize / discretize
# ------------------------------------------------------------------

def binarize(u, kind="amplitude", bin_level=None, level0=None,
             level1=None):
    """Two-level quantization.

    kind='amplitude': |u| <= bin_level -> level0 else level1 (phase
    kept).  kind='phase': phase <= bin_level -> level0 else level1
    (amplitude kept).  Defaults: bin_level = mean, levels = min/max.
    """
    u = _as_tensor(u)
    amp = torch.abs(u)
    ph = torch.angle(u)
    t = amp if kind == "amplitude" else ph
    if bin_level is None:
        bin_level = torch.mean(t)
    lo = torch.min(t) if level0 is None else level0
    hi = torch.max(t) if level1 is None else level1
    q = torch.where(t <= bin_level, torch.as_tensor(lo, dtype=t.dtype,
                                                   device=t.device),
                    torch.as_tensor(hi, dtype=t.dtype, device=t.device))
    if kind == "amplitude":
        return q * torch.exp(1j * ph)
    return amp * torch.exp(1j * q)


def discretize(u, kind="amplitude", num_levels=2, phase0=-np.pi):
    """N-level quantization (nearest level).

    kind='amplitude': |u| snapped to ``num_levels`` uniform levels on
    [min, max].  kind='phase': phase snapped to ``num_levels`` uniform
    levels on [phase0, phase0 + 2*pi).
    """
    u = _as_tensor(u)
    amp = torch.abs(u)
    ph = torch.angle(u)
    if kind == "amplitude":
        lo, hi = torch.min(amp), torch.max(amp)
        span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
        idx = torch.round((amp - lo) / span * (num_levels - 1))
        q = lo + idx * span / (num_levels - 1)
        return q * torch.exp(1j * ph)
    w = torch.remainder(ph - phase0, 2 * np.pi)
    step = 2 * np.pi / num_levels
    q = phase0 + (torch.floor(w / step) + 0.5) * step
    return amp * torch.exp(1j * q)


# ------------------------------------------------------------------
# edges of binary masks (host, as in the JAX package)
# ------------------------------------------------------------------

def get_edges(x, u, kind_transition="amplitude", min_step=0.0):
    """Edge locations of a (quasi-)binary 1D transmission.

    Returns ``(pos_transitions, type_transitions, raising, falling)`` as
    NumPy arrays: x positions of every |step| > min_step, the sign of each
    step, and the raising/falling subsets.
    """
    x = _host(x)
    u = _host(u)
    t = np.abs(u) if kind_transition == "amplitude" else np.angle(u)
    d = np.diff(t)
    if min_step <= 0:
        min_step = 0.5 * (np.max(np.abs(d)) if np.any(d) else 1.0)
    idx = np.nonzero(np.abs(d) > min_step)[0]
    pos = 0.5 * (x[idx] + x[idx + 1])
    typ = np.sign(d[idx])
    return pos, typ, pos[typ > 0], pos[typ < 0]


# ------------------------------------------------------------------
# focus search
# ------------------------------------------------------------------

def search_focus(x, y, u, kind="maximum"):
    """(x0, y0) of the intensity maximum ('maximum') or intensity
    centroid ('moments'), as 0-dim tensors on the field's device."""
    u = _as_tensor(u)
    I = torch.abs(u) ** 2
    x = _as_tensor(x, u.device)
    y = _as_tensor(y, u.device)
    if kind == "maximum":
        k = int(torch.argmax(I))
        ix, iy = divmod(k, I.shape[1])
        return x[ix], y[iy]
    W = torch.sum(I)
    return (torch.sum(I * x[:, None]) / W, torch.sum(I * y[None, :]) / W)


# ------------------------------------------------------------------
# line profile
# ------------------------------------------------------------------

def profile(x, y, u, point1, point2, npixels=None, kind="intensity"):
    """Interpolated 1D cut of the field between ``point1`` and
    ``point2`` (each (x, y)).  Returns (s, values) with ``s`` the
    arclength coordinate (NumPy) and the values on the field's device.
    kind: 'intensity' | 'amplitude' | 'phase' | 'field'.  Bilinear
    interpolation (:func:`_bilinear`)."""
    x = _host(x)
    y = _host(y)
    uj = _as_tensor(u)
    if npixels is None:
        npixels = len(x)
    x1, y1 = point1
    x2, y2 = point2
    xs = np.linspace(x1, x2, npixels)
    ys = np.linspace(y1, y2, npixels)
    ci = torch.as_tensor((xs - x[0]) / (x[1] - x[0]), device=uj.device)
    cj = torch.as_tensor((ys - y[0]) / (y[1] - y[0]), device=uj.device)
    uj = uj.to(torch.complex128)
    re = _bilinear(uj.real, ci, cj)
    im = _bilinear(uj.imag, ci, cj)
    val = re + 1j * im
    s = np.hypot(xs - x1, ys - y1)
    if kind == "intensity":
        return s, torch.abs(val) ** 2
    if kind == "amplitude":
        return s, torch.abs(val)
    if kind == "phase":
        return s, torch.angle(val)
    return s, val


# ------------------------------------------------------------------
# rotation / paste
# ------------------------------------------------------------------

def rotate_field(x, y, u, angle, position=None):
    """Rotate u(x, y) by ``angle`` about ``position`` (default: grid
    center) by inverse-mapping with bilinear interpolation; points
    mapped from outside the grid are zero."""
    x = _host(x)
    y = _host(y)
    uj = _as_tensor(u).to(torch.complex128)
    if position is None:
        position = (0.5 * (x[0] + x[-1]), 0.5 * (y[0] + y[-1]))
    x0, y0 = position
    X, Y = np.meshgrid(x, y, indexing="ij")
    c, s = np.cos(angle), np.sin(angle)
    Xs = c * (X - x0) + s * (Y - y0) + x0
    Ys = -s * (X - x0) + c * (Y - y0) + y0
    ci = (Xs - x[0]) / (x[1] - x[0])
    cj = (Ys - y[0]) / (y[1] - y[0])
    inside = ((ci >= 0) & (ci <= len(x) - 1)
              & (cj >= 0) & (cj <= len(y) - 1))
    dev = uj.device
    ci, cj = torch.as_tensor(ci, device=dev), torch.as_tensor(cj, device=dev)
    re = _bilinear(uj.real, ci, cj)
    im = _bilinear(uj.imag, ci, cj)
    return torch.where(torch.as_tensor(inside, device=dev), re + 1j * im,
                       torch.zeros((), dtype=torch.complex128, device=dev))


def insert_array(x, y, u_base, u_small, xs, ys, r0=(0.0, 0.0)):
    """Paste a smaller field sampled on (xs, ys) into u_base centered
    at ``r0`` (nearest-node alignment, clipped at the borders)."""
    x = _host(x)
    y = _host(y)
    out = _as_tensor(u_base).to(torch.complex128).clone()
    small = _as_tensor(u_small, out.device).to(torch.complex128)
    dx = x[1] - x[0]
    dy = y[1] - y[0]
    i0 = int(round((r0[0] + _host(xs)[0] - x[0]) / dx))
    j0 = int(round((r0[1] + _host(ys)[0] - y[0]) / dy))
    ns, ms = small.shape
    ia, ja = max(i0, 0), max(j0, 0)
    ib, jb = min(i0 + ns, len(x)), min(j0 + ms, len(y))
    if ib <= ia or jb <= ja:
        return out
    out[ia:ib, ja:jb] = small[ia - i0:ib - i0, ja - j0:jb - j0]
    return out


# ------------------------------------------------------------------
# XZ scene analysis (host point clouds, as in the JAX package)
# ------------------------------------------------------------------

def detect_index_variations(x, z, n, n_edge, incr_n=0.1):
    """Left/right interface curves of an index scene n(x, z): for each x
    row, the z where the indicator Re(n) > n_edge rises (left) and falls
    (right). Returns ``(x_left, h_left, x_right, h_right)`` (NumPy)."""
    x = _host(x)
    z = _host(z)
    ind = (np.real(_host(n)) > n_edge).astype(float)
    d = np.diff(ind, axis=1)
    ix_l, iz_l = np.nonzero(d > incr_n)
    ix_r, iz_r = np.nonzero(d < -incr_n)
    return x[ix_l], z[iz_l], x[ix_r], z[iz_r]


def surface_detection(x, z, n, mode=1, min_incr=0.1):
    """All edge points of an index scene: |∇n| (mode 1) or |Δn| along
    both axes (mode 2) above ``min_incr``. Returns ``(xs, zs)`` point
    clouds (NumPy)."""
    x = _host(x)
    z = _host(z)
    nr = np.real(_host(n))
    if mode == 1:
        gx, gz = np.gradient(nr, x, z)
        mag = np.hypot(gx, gz)
        mag = mag * min(x[1] - x[0], z[1] - z[0])
    else:
        mag = np.zeros_like(nr)
        mag[:-1, :] = np.maximum(mag[:-1, :], np.abs(np.diff(nr, axis=0)))
        mag[:, :-1] = np.maximum(mag[:, :-1], np.abs(np.diff(nr, axis=1)))
    ix, iz = np.nonzero(mag > min_incr)
    return x[ix], z[iz]


def rotate_image(x, z, img, angle, pivot_point):
    """Rotate a real (nz, nx) image by ``angle`` DEGREES about the
    physical pivot ``(z0, x0)`` by a direct inverse map with bilinear
    interpolation about the pivot. Points mapped from outside keep 0."""
    x = _host(x)
    z = _host(z)
    img = _as_tensor(img)
    z0, x0 = pivot_point
    th = np.deg2rad(angle)
    Z, X = np.meshgrid(z, x, indexing="ij")
    c, s = np.cos(th), np.sin(th)
    Zs = c * (Z - z0) + s * (X - x0) + z0
    Xs = -s * (Z - z0) + c * (X - x0) + x0
    ci = (Zs - z[0]) / (z[1] - z[0])
    cj = (Xs - x[0]) / (x[1] - x[0])
    inside = ((ci >= 0) & (ci <= len(z) - 1)
              & (cj >= 0) & (cj <= len(x) - 1))
    dev = img.device
    out = _bilinear(img, torch.as_tensor(ci, device=dev),
                    torch.as_tensor(cj, device=dev))
    return torch.where(torch.as_tensor(inside, device=dev), out,
                       torch.zeros((), dtype=out.dtype, device=dev))


def filter_edge_1D(x, size=1.1, exponent=32):
    """Super-Gaussian window, 1 at the center falling at the borders —
    the absorbing edge filter for propagation algorithms (NumPy).
    ``|base|**p``: a signed base with an odd or non-integer exponent
    would amplify (or NaN) the left half."""
    x = _host(x)
    x_center = (x[-1] + x[0]) / 2
    Dx = size * (x[-1] - x[0])
    return np.exp(-np.abs(2 * (x - x_center) / Dx) ** np.abs(exponent))


def filter_edge_2D(x, y, size=1.1, exponent=32):
    """Separable 2D super-Gaussian edge filter, indexed (len(x),
    len(y)) (NumPy)."""
    return np.outer(filter_edge_1D(x, size, exponent),
                    filter_edge_1D(y, size, exponent))

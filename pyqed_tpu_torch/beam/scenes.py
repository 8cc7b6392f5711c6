"""Refraction-index scene builders for the XZ sheet and XYZ volume BPM.

PyTorch counterpart of ``pyqed_tpu/beam/scenes.py``. A scene is a plain
``(nz, nx)`` (XZ) or ``(nz, nx, ny)`` (XYZ) index tensor, exactly the
``n_xz`` / ``n_volume`` input of ``ScalarFieldXZ.bpm`` /
``ScalarFieldXYZ.bpm``, and builders are pure: ``n_new = builder(n, x, z,
...)``. Surface conditions are Python callables ``f(Xrot, Zrot) -> bool
tensor`` of the grid tensors.

A builder works on the device of ``n`` when ``n`` is a tensor, else on
the card. The XYZ grids are expanded views of the coordinate vectors
(full shape, no copy), so the conditions see JAX's meshgrid values
without three volumes of memory.

``rough_sheet`` draws its normals from a seeded ``torch.Generator``
(``key``: an integer seed or a generator) where JAX takes a
``jax.random`` key, and takes them as ``noise=``.
"""
from __future__ import annotations

import numpy as np
import torch

from .fieldutils import _as_tensor, _device_of, _host
from .masks import _normals

__all__ = [
    "xz_grids", "object_by_surfaces", "semi_plane", "layer", "rectangle",
    "slit", "sphere", "semi_sphere", "wedge", "prism", "biprism", "probe",
    "lens_plane_convergent", "lens_convergent", "lens_plane_divergent",
    "lens_divergent", "aspheric_surface_z", "aspheric_lens",
    "mask_from_function_xz", "mask_from_array_xz", "rough_sheet",
    "discretize_refraction_index", "image_xz",
    "extrude_mask_xz", "dots_xz", "add_surfaces", "ronchi_grating_xz",
    "sine_grating_xz",
    "sphere_xyz", "cylinder_xyz", "object_by_surfaces_xyz",
]


def xz_grids(x, z, device=None):
    """Meshgrids with the BPM sheet layout (nz, nx): returns (X, Z)."""
    dev = _device_of(x, z, device=device)
    Z, X = torch.meshgrid(_as_tensor(z, dev), _as_tensor(x, dev),
                          indexing="ij")
    return X, Z


def _rot_xz(X, Z, angle, point):
    """Rotate about ``point``; stays in the absolute frame."""
    x0, z0 = point
    c, s = float(np.cos(angle)), float(np.sin(angle))
    Xr = x0 + (X - x0) * c + (Z - z0) * s
    Zr = z0 - (X - x0) * s + (Z - z0) * c
    return Xr, Zr


def object_by_surfaces(n, x, z, conditions, refraction_index, angle=0.0,
                       rotation_point=(0.0, 0.0)):
    """Set ``refraction_index`` where ALL ``conditions`` hold.

    conditions: iterable of callables ``f(Xrot, Zrot) -> bool tensor``
    (absolute rotated coordinates). ``refraction_index`` may be a scalar
    or a callable ``n(Xrot, Zrot)``. Returns the updated (nz, nx) sheet.
    """
    dev = _device_of(n, x, z)
    X, Z = xz_grids(x, z, dev)
    Xr, Zr = _rot_xz(X, Z, angle, rotation_point)
    inside = torch.ones(X.shape, dtype=torch.bool, device=dev)
    for cond in conditions:
        inside = inside & cond(Xr, Zr)
    if callable(refraction_index):
        val = refraction_index(Xr, Zr)
    else:
        val = refraction_index
    return torch.where(inside, val, _as_tensor(n, dev))


def semi_plane(n, x, z, r0, refraction_index, angle=0.0,
               rotation_point=None):
    """Half space z > z0."""
    x0, z0 = r0
    rp = r0 if rotation_point is None else rotation_point
    return object_by_surfaces(n, x, z, [lambda X, Z: Z > z0],
                              refraction_index, angle, rp)


def layer(n, x, z, r0, depth, refraction_index, angle=0.0,
          rotation_point=None):
    """Slab z0 < z < z0 + depth."""
    x0, z0 = r0
    rp = r0 if rotation_point is None else rotation_point
    return object_by_surfaces(
        n, x, z, [lambda X, Z: (Z > z0) & (Z < z0 + depth)],
        refraction_index, angle, rp)


def rectangle(n, x, z, r0, size, refraction_index, angle=0.0,
              rotation_point=None):
    """Centered rectangle of (sizex, sizez)."""
    x0, z0 = r0
    sx, sz = (size, size) if np.isscalar(size) else size
    rp = r0 if rotation_point is None else rotation_point
    return object_by_surfaces(
        n, x, z,
        [lambda X, Z: (torch.abs(X - x0) < sx / 2)
         & (torch.abs(Z - z0) < sz / 2)],
        refraction_index, angle, rp)


def slit(n, x, z, r0, aperture, depth, refraction_index,
         refraction_index_center=None, angle=0.0, rotation_point=None):
    """Opaque screen of ``depth`` with an opening of ``aperture``.
    The opening keeps the previous index (or gets
    ``refraction_index_center`` if given)."""
    x0, z0 = r0
    rp = r0 if rotation_point is None else rotation_point
    dev = _device_of(n, x, z)
    n_prev = _as_tensor(n, dev)
    n1 = object_by_surfaces(
        n_prev, x, z, [lambda X, Z: (Z > z0) & (Z < z0 + depth)],
        refraction_index, angle, rp)
    inside_center = [lambda X, Z: (Z > z0) & (Z < z0 + depth)
                     & (torch.abs(X - x0) < aperture / 2)]
    if refraction_index_center is not None:
        return object_by_surfaces(n1, x, z, inside_center,
                                  refraction_index_center, angle, rp)
    X, Z = xz_grids(x, z, dev)
    Xr, Zr = _rot_xz(X, Z, angle, rp)
    hole = inside_center[0](Xr, Zr)
    return torch.where(hole, n_prev, n1)


def sphere(n, x, z, r0, radius, refraction_index, angle=0.0,
           rotation_point=None):
    """Circle/ellipse cross-section (the XZ cut of a sphere)."""
    x0, z0 = r0
    rx, rz = (radius, radius) if np.isscalar(radius) else radius
    rp = r0 if rotation_point is None else rotation_point
    return object_by_surfaces(
        n, x, z,
        [lambda X, Z: (X - x0) ** 2 / rx ** 2
         + (Z - z0) ** 2 / rz ** 2 < 1],
        refraction_index, angle, rp)


def semi_sphere(n, x, z, r0, radius, refraction_index, angle=0.0,
                rotation_point=None):
    """Half-disc z > z0 inside the ellipse."""
    x0, z0 = r0
    rx, rz = (radius, radius) if np.isscalar(radius) else radius
    rp = r0 if rotation_point is None else rotation_point
    return object_by_surfaces(
        n, x, z,
        [lambda X, Z: Z > z0,
         lambda X, Z: (X - x0) ** 2 / rx ** 2
         + (Z - z0) ** 2 / rz ** 2 < 1],
        refraction_index, angle, rp)


def wedge(n, x, z, r0, length, refraction_index, angle_wedge, angle=0.0,
          rotation_point=None):
    """Wedge pointing into the beam: x > x0, z < z0 + length,
    (x - x0) < tan(angle_wedge) (z - z0)."""
    x0, z0 = r0
    rp = r0 if rotation_point is None else rotation_point
    t = float(np.tan(angle_wedge))
    return object_by_surfaces(
        n, x, z,
        [lambda X, Z: X > x0,
         lambda X, Z: Z < z0 + length,
         lambda X, Z: (X - x0) < t * (Z - z0)],
        refraction_index, angle, rp)


def prism(n, x, z, r0, length, refraction_index, angle_prism, angle=0.0,
          rotation_point=None):
    """Prism with one face parallel to x = x0."""
    x0, z0 = r0
    rp = r0 if rotation_point is None else rotation_point
    t1 = float(np.tan(angle_prism / 2))
    t2 = float(np.tan(np.pi - angle_prism / 2))
    return object_by_surfaces(
        n, x, z,
        [lambda X, Z: X > x0,
         lambda X, Z: (Z - z0) > t1 * (X - x0),
         lambda X, Z: (Z - (z0 + length)) < t2 * (X - x0)],
        refraction_index, angle, rp)


def biprism(n, x, z, r0, length, height, refraction_index, angle=0.0):
    """Fresnel biprism: tent profile of base ``length`` and apex
    ``height`` sitting on z = z0."""
    x0, z0 = r0
    slope = 2 * height / length
    return object_by_surfaces(
        n, x, z,
        [lambda X, Z: Z > z0,
         lambda X, Z: (Z - (z0 + height)) < -slope * (X - x0),
         lambda X, Z: (Z - (z0 + height)) < slope * (X - x0)],
        refraction_index, angle, r0)


def probe(n, x, z, r0, base, length, refraction_index, angle=0.0):
    """Sinusoidal-tip probe (near-field tip model)."""
    x0, z0 = r0
    return object_by_surfaces(
        n, x, z,
        [lambda X, Z: Z < (length - z0)
         + length / 2 * torch.cos(2 * np.pi * X / base),
         lambda X, Z: torch.abs(X - x0) < base / 2,
         lambda X, Z: Z > z0],
        refraction_index, angle, r0)


# ------------------------------------------------------------------
# lens builders (spherical surfaces)
# ------------------------------------------------------------------

def lens_plane_convergent(n, x, z, r0, aperture, radius, thickness,
                          refraction_index, angle=0.0, mask=None):
    """Plano-convex lens: flat entry face at z0, spherical exit face of
    curvature ``radius`` (center at z0 + thickness - radius).
    Returns (n_new, focal) with focal = radius / (n_lens - 1)."""
    x0, z0 = r0
    n_new = object_by_surfaces(
        n, x, z,
        [lambda X, Z: Z > z0,
         lambda X, Z: torch.abs(X - x0) < aperture / 2,
         lambda X, Z: (X - x0) ** 2
         + (Z - (z0 + thickness - radius)) ** 2 < radius ** 2],
        refraction_index, angle, r0)
    focal = radius / (refraction_index - 1)
    return n_new, focal


def lens_convergent(n, x, z, r0, aperture, radius, thickness,
                    refraction_index, angle=0.0):
    """Biconvex lens from two spherical caps; radius=(R1, -R2) with the
    diffractio sign convention (R1 > 0 entry, R2 < 0 exit).
    Returns (n_new, focal) via the lensmaker equation."""
    x0, z0 = r0
    R1, R2 = radius
    nl = refraction_index
    n_new = object_by_surfaces(
        n, x, z,
        [lambda X, Z: torch.abs(X - x0) < aperture / 2,
         lambda X, Z: (X - x0) ** 2 + (Z - (z0 + R1)) ** 2 < R1 ** 2,
         lambda X, Z: (X - x0) ** 2
         + (Z - (z0 + thickness + R2)) ** 2 < R2 ** 2],
        refraction_index, angle, r0)
    inv_f = (nl - 1) * (1 / R1 - 1 / R2
                        + (nl - 1) * thickness / (nl * R1 * (-R2)))
    return n_new, 1.0 / inv_f


def lens_plane_divergent(n, x, z, r0, aperture, radius, thickness,
                         refraction_index, angle=0.0):
    """Plano-concave lens: flat entry at z0, concave exit (the sphere of
    curvature ``radius`` centered beyond the exit face is removed).
    Returns (n_new, focal), focal < 0."""
    x0, z0 = r0
    n_new = object_by_surfaces(
        n, x, z,
        [lambda X, Z: Z > z0,
         lambda X, Z: Z < z0 + thickness,
         lambda X, Z: torch.abs(X - x0) < aperture / 2,
         lambda X, Z: (X - x0) ** 2
         + (Z - (z0 + thickness + radius)) ** 2 > radius ** 2],
        refraction_index, angle, r0)
    return n_new, -radius / (refraction_index - 1)


def lens_divergent(n, x, z, r0, aperture, radius, thickness,
                   refraction_index, angle=0.0):
    """Biconcave lens; radius=(-R1, R2) diffractio convention.
    Returns (n_new, focal) via the lensmaker equation."""
    x0, z0 = r0
    R1, R2 = radius
    nl = refraction_index
    n_new = object_by_surfaces(
        n, x, z,
        [lambda X, Z: torch.abs(X - x0) < aperture / 2,
         lambda X, Z: Z > z0,
         lambda X, Z: Z < z0 + thickness,
         lambda X, Z: (X - x0) ** 2 + (Z - (z0 + R1)) ** 2 > R1 ** 2,
         lambda X, Z: (X - x0) ** 2
         + (Z - (z0 + thickness + R2)) ** 2 > R2 ** 2],
        refraction_index, angle, r0)
    inv_f = (nl - 1) * (1 / R1 - 1 / R2
                        + (nl - 1) * thickness / (nl * R1 * (-R2)))
    return n_new, 1.0 / inv_f


def _asphere_sag(X, x0, cx, Qx, a2, a3, a4):
    r2 = (X - x0) ** 2
    disc = torch.clamp(1 - (1 + Qx) * cx ** 2 * r2, min=0.0)
    return (cx * r2 / (1 + torch.sqrt(disc))
            + a2 * r2 ** 2 + a3 * r2 ** 3 + a4 * r2 ** 4)


def aspheric_surface_z(n, x, z, r0, refraction_index, cx, Qx, a2=0.0,
                       a3=0.0, a4=0.0, side="right", angle=0.0):
    """Half-space bounded by the even-asphere surface z = z0 + sag(x);
    ``side`` picks which half gets the index."""
    x0, z0 = r0

    def cond(X, Z):
        surf = z0 + _asphere_sag(X, x0, cx, Qx, a2, a3, a4)
        return Z > surf if side == "right" else Z < surf
    return object_by_surfaces(n, x, z, [cond], refraction_index, angle, r0)


def aspheric_lens(n, x, z, r0, refraction_index, cx, Qx, depth, size,
                  a2=(0.0, 0.0), a3=(0.0, 0.0), a4=(0.0, 0.0), angle=0.0):
    """Lens bounded by two aspheric surfaces a distance ``depth`` apart
    (Gomez-Pedrero parameterization)."""
    x0, z0 = r0
    cx1, cx2 = cx
    Qx1, Qx2 = Qx
    a21, a22 = a2
    a31, a32 = a3
    a41, a42 = a4

    def cond1(X, Z):
        return Z > z0 + _asphere_sag(X, x0, cx1, Qx1, a21, a31, a41)

    def cond2(X, Z):
        return Z < z0 + depth + _asphere_sag(X, x0, cx2, Qx2, a22, a32,
                                             a42)

    return object_by_surfaces(
        n, x, z,
        [cond1, cond2,
         lambda X, Z: torch.abs(X - x0) < size / 2,
         lambda X, Z: (Z > z0 - depth) & (Z < z0 + 2 * depth)],
        refraction_index, angle, r0)


# ------------------------------------------------------------------
# generic builders
# ------------------------------------------------------------------

def mask_from_function_xz(n, x, z, f1, f2, refraction_index, x_sides=None,
                          angle=0.0, rotation_point=(0.0, 0.0)):
    """Material between two surface functions f1(x) < z < f2(x)
    (callables of the coordinate tensor)."""
    conds = [lambda X, Z: (Z > f1(X)) & (Z < f2(X))]
    if x_sides is not None:
        conds.append(lambda X, Z: (X > x_sides[0]) & (X < x_sides[1]))
    return object_by_surfaces(n, x, z, conds, refraction_index, angle,
                              rotation_point)


def _interp(x, xp, fp):
    """JAX's ``jnp.interp(x, xp, fp)`` (constant extrapolation) on
    tensors, in its order of operations."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(
                        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def mask_from_array_xz(n, x, z, array1, array2, refraction_index,
                       x_sides=None, angle=0.0,
                       rotation_point=(0.0, 0.0)):
    """Material between two sampled profiles given as (N, 2) arrays of
    (x, z) points, linearly interpolated."""
    dev = _device_of(n, x, z)
    a1 = torch.as_tensor(np.asarray(array1, dtype=float), device=dev)
    a2 = torch.as_tensor(np.asarray(array2, dtype=float), device=dev)

    def f1(X):
        return _interp(X, a1[:, 0].contiguous(), a1[:, 1].contiguous())

    def f2(X):
        return _interp(X, a2[:, 0].contiguous(), a2[:, 1].contiguous())

    return mask_from_function_xz(n, x, z, f1, f2, refraction_index,
                                 x_sides, angle, rotation_point)


def rough_sheet(n, x, z, r0, size, t, s, refraction_index, key=0,
                angle=0.0, rotation_point=None, noise=None):
    """Sheet whose exit surface has Gaussian-correlated roughness
    (correlation length t, std s; Ogilvy p.224). ``noise``: the (nx,)
    standard normals (default: drawn from ``key``)."""
    x0, z0 = r0
    rp = r0 if rotation_point is None else rotation_point
    sx, sz = (size, size) if np.isscalar(size) else size
    dev = _device_of(n, x, z)
    xa = _host(x)
    noise = _normals((len(xa),), key, dev, noise)
    xc = xa - xa[len(xa) // 2]
    kern = torch.as_tensor(np.exp(-xc ** 2 / t ** 2), device=dev)
    kf = torch.fft.fft(torch.fft.ifftshift(kern))
    h = torch.real(torch.fft.ifft(torch.fft.fft(noise) * kf))
    h = h - torch.mean(h)
    h = h * (s / torch.std(h, correction=0))
    x_t = torch.as_tensor(xa, device=dev)

    def cond(X, Z):
        hX = _interp(X, x_t, h)
        return ((Z > z0) & (Z < z0 + sz - hX)
                & (torch.abs(X - x0) < sx / 2))

    return object_by_surfaces(n, x, z, [cond], refraction_index, angle,
                              rp)


def discretize_refraction_index(n, levels):
    """Snap every pixel of the index sheet/volume to the nearest value
    in ``levels`` (by the real part; the imaginary part carried along).
    Returns a complex tensor."""
    n = _as_tensor(n)
    levels = torch.as_tensor(np.asarray(levels, dtype=complex),
                             device=n.device)
    dist = torch.abs(torch.real(n)[..., None] - torch.real(levels))
    idx = torch.argmin(dist, dim=-1)
    return levels[idx]


def image_xz(n, x, z, filename, n_max, n_min=1.0, invert=False,
             device=None):
    """Grey-level image -> refraction-index sheet in [n_min, n_max]
    (read by matplotlib, imported here)."""
    import matplotlib.image as mpimg
    from scipy.ndimage import zoom
    img = mpimg.imread(filename)
    if img.ndim == 3:
        img = img[..., :3].mean(axis=-1)
    img = np.asarray(img, dtype=float)
    img = img / (img.max() if img.max() > 0 else 1.0)
    if invert:
        img = 1 - img
    img = zoom(img, (len(z) / img.shape[0], len(x) / img.shape[1]),
               order=1)[:len(z), :len(x)]
    return torch.as_tensor(n_min + (n_max - n_min) * img,
                           device=_device_of(n, device=device))


# ------------------------------------------------------------------
# XYZ volume builders
# ------------------------------------------------------------------

def xyz_grids(x, y, z, device=None):
    """Grids with the volume BPM layout (nz, nx, ny): expanded views of
    the coordinate vectors, returned as (X, Y, Z)."""
    dev = _device_of(x, y, z, device=device)
    xt, yt, zt = (_as_tensor(a, dev) for a in (x, y, z))
    shape = (len(zt), len(xt), len(yt))
    return (xt[None, :, None].expand(shape), yt[None, None, :].expand(shape),
            zt[:, None, None].expand(shape))


def object_by_surfaces_xyz(n, x, y, z, conditions, refraction_index):
    """Set ``refraction_index`` where ALL callables
    ``f(X, Y, Z) -> bool`` hold, on the (nz, nx, ny) volume."""
    dev = _device_of(n, x, y, z)
    X, Y, Z = xyz_grids(x, y, z, dev)
    inside = torch.ones(X.shape, dtype=torch.bool, device=dev)
    for cond in conditions:
        inside = inside & cond(X, Y, Z)
    if callable(refraction_index):
        val = refraction_index(X, Y, Z)
    else:
        val = refraction_index
    return torch.where(inside, val, _as_tensor(n, dev))


def sphere_xyz(n, x, y, z, r0, radius, refraction_index):
    """Ellipsoid (rx, ry, rz) centered at r0 = (x0, y0, z0)."""
    x0, y0, z0 = r0
    rx, ry, rz = ((radius,) * 3 if np.isscalar(radius) else radius)
    return object_by_surfaces_xyz(
        n, x, y, z,
        [lambda X, Y, Z: (X - x0) ** 2 / rx ** 2
         + (Y - y0) ** 2 / ry ** 2 + (Z - z0) ** 2 / rz ** 2 < 1],
        refraction_index)


def square_xyz(n, x, y, z, r0, lengths, refraction_index):
    """Axis-aligned box of half-extents ``lengths/2`` centered at
    ``r0 = (x0, y0, z0)`` (for a rotated box pass rotated conditions to
    ``object_by_surfaces_xyz``)."""
    x0, y0, z0 = r0
    lx, ly, lz = ((lengths,) * 3 if np.isscalar(lengths) else lengths)
    return object_by_surfaces_xyz(
        n, x, y, z,
        [lambda X, Y, Z: torch.abs(X - x0) < lx / 2,
         lambda X, Y, Z: torch.abs(Y - y0) < ly / 2,
         lambda X, Y, Z: torch.abs(Z - z0) < lz / 2],
        refraction_index)


def cylinder_xyz(n, x, y, z, r0, radius, length, refraction_index,
                 axis="z"):
    """Circular cylinder of ``radius`` and ``length`` along ``axis``."""
    x0, y0, z0 = r0
    rx, ry = (radius, radius) if np.isscalar(radius) else radius
    if axis == "z":
        conds = [lambda X, Y, Z: (X - x0) ** 2 / rx ** 2
                 + (Y - y0) ** 2 / ry ** 2 < 1,
                 lambda X, Y, Z: torch.abs(Z - z0) < length / 2]
    elif axis == "x":
        conds = [lambda X, Y, Z: (Y - y0) ** 2 / rx ** 2
                 + (Z - z0) ** 2 / ry ** 2 < 1,
                 lambda X, Y, Z: torch.abs(X - x0) < length / 2]
    else:
        conds = [lambda X, Y, Z: (X - x0) ** 2 / rx ** 2
                 + (Z - z0) ** 2 / ry ** 2 < 1,
                 lambda X, Y, Z: torch.abs(Y - y0) < length / 2]
    return object_by_surfaces_xyz(n, x, y, z, conds, refraction_index)


def extrude_mask_xz(n, x, z, t_u, z0, z1, refraction_index,
                    n_background=1.0):
    """Extrude a 1D amplitude mask t(x) into the slab z0 < z < z1:
    inside the slab, n = index (1 - t) + n_background t — transparent
    (t=1) pixels keep the background, opaque (t=0) pixels get the
    material."""
    dev = _device_of(n, t_u, x, z)
    X, Z = xz_grids(x, z, dev)
    t_u = _as_tensor(t_u, dev)
    inside = (Z >= z0) & (Z <= z1)
    val = (refraction_index * (1.0 - t_u)[None, :]
           + n_background * t_u[None, :])
    return torch.where(inside, val, _as_tensor(n, dev))


def dots_xz(n, x, z, positions, refraction_index):
    """Single-pixel scatterers at (x_i, z_i)."""
    dev = _device_of(n, x, z)
    x = _host(x)
    z = _host(z)
    n = _as_tensor(n, dev).clone()
    for (xi, zi) in positions:
        ix = int(np.argmin(np.abs(x - xi)))
        iz = int(np.argmin(np.abs(z - zi)))
        n[iz, ix] = refraction_index
    return n


def add_surfaces(n, x, z, f_bottom, f_top, x_sides, refraction_index):
    """Region between two height profiles z = f_bottom(x) and
    z = f_top(x) (callables of the coordinate tensor), clipped to
    x_sides = (x_min, x_max)."""
    dev = _device_of(n, x, z)
    X, Z = xz_grids(x, z, dev)
    cond = ((Z >= f_bottom(X)) & (Z <= f_top(X))
            & (X >= x_sides[0]) & (X <= x_sides[1]))
    return torch.where(cond, refraction_index, _as_tensor(n, dev))


def ronchi_grating_xz(n, x, z, r0, period, fill_factor, length, height,
                      Dx, refraction_index, height_substrate=0.0,
                      refraction_index_substrate=None,
                      n_background=1.0):
    """Surface-relief Ronchi grating on an optional substrate: extrude a
    1D Ronchi amplitude mask, then the substrate rectangle, then clip to
    ``length``."""
    x0, z0 = r0
    dev = _device_of(n, x, z)
    xs = _host(x)
    t = (np.cos(2 * np.pi * (xs - Dx) / period)
         > np.cos(np.pi * fill_factor)).astype(float)
    zb = z0 + height_substrate / 2
    n1 = extrude_mask_xz(_as_tensor(n, dev), x, z, 1.0 - t, zb, zb + height,
                         refraction_index, n_background)
    if height_substrate > 0 and refraction_index_substrate is not None:
        n1 = rectangle(n1, x, z, r0, (length, height_substrate),
                       refraction_index_substrate)
    X, Z = xz_grids(x, z, dev)
    outside = ((torch.abs(X - x0) > length / 2)
               & (Z >= zb) & (Z <= zb + height))
    return torch.where(outside, n_background, n1)


def sine_grating_xz(n, x, z, r0, period, height_sine,
                    refraction_index, height_substrate=0.0,
                    n_background=1.0):
    """Sinusoidal surface-relief grating: material below the surface
    z = z0 + h_sub + (h_sine/2)(1 + sin(2 pi x / period))."""
    x0, z0 = r0
    dev = _device_of(n, x, z)
    X, Z = xz_grids(x, z, dev)
    zsurf = (z0 + height_substrate
             + 0.5 * height_sine * (1 + torch.sin(2 * np.pi
                                                  * (X - x0) / period)))
    cond = (Z >= z0) & (Z <= zsurf)
    return torch.where(cond, refraction_index, _as_tensor(n, dev))

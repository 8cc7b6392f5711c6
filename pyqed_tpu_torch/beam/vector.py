"""Vector (polarization) optics on the XY transverse plane.

PyTorch counterpart of ``pyqed_tpu/beam/vector.py``: the Jones calculus
as closed-form 2x2 matrix fields, built on the host with NumPy as in the
JAX package, and applied to a field with one einsum over the grid on the
field's device.

Conventions
-----------
Jones vectors are (Ex, Ey); a device with fast axis at ``azimuth`` a is
J = R(a) J0 R(-a) with R the usual rotation.  Stokes parameters follow
``VectorFieldXY.stokes`` (S3 = -2 Im(Ex Ey*), i.e. Ey = +i Ex is
S3 = +S0).
"""
from __future__ import annotations

import numpy as np
import torch

from .beam import ScalarFieldXY, VectorFieldXY
from .fieldutils import _complex, _host


def _XY(x, y):
    X, Y = np.meshgrid(np.asarray(x), np.asarray(y), indexing="ij")
    return X, Y


def _rot(a):
    """Rotation matrix stack R(a); ``a`` scalar or (nx, ny) array ->
    (..., 2, 2) (NumPy)."""
    a = np.asarray(a, dtype=float)
    c, s = np.cos(a), np.sin(a)
    return np.stack([np.stack([c, -s], -1),
                     np.stack([s, c], -1)], -2)


def jones_rotated(J0, azimuth):
    """R(a) @ J0 @ R(-a) for scalar or per-pixel ``azimuth``
    (J0 (2, 2), azimuth () or (nx, ny)); NumPy."""
    R = _rot(azimuth)
    Rm = _rot(-np.asarray(azimuth))
    return np.einsum("...ij, jk, ...kl -> ...il", R, np.asarray(J0), Rm)


# ------------------------------------------------------------------
# Jones devices (closed forms, NumPy)
# ------------------------------------------------------------------

def polarizer_linear(azimuth=0.0):
    """Perfect linear diattenuator at ``azimuth``."""
    return jones_rotated(np.array([[1.0, 0.0], [0.0, 0.0]]), azimuth)


def retarder(retardance, azimuth=0.0, p1=1.0, p2=1.0):
    """Linear retarder/diattenuator: fast axis at ``azimuth``,
    J0 = diag(p1 e^{-iR/2}, p2 e^{+iR/2})."""
    J0 = np.diag([p1 * np.exp(-0.5j * retardance),
                  p2 * np.exp(+0.5j * retardance)])
    return jones_rotated(J0, azimuth)


def quarter_waveplate(azimuth=0.0):
    return retarder(np.pi / 2, azimuth)


def half_waveplate(azimuth=0.0):
    return retarder(np.pi, azimuth)


class VectorMaskXY(VectorFieldXY):
    """Spatially-resolved Jones-matrix mask on the XY grid.

    ``self.M`` is an (nx, ny, 2, 2) complex Jones field on the host;
    uniform devices broadcast, and ``azimuth`` may be an (nx, ny) array
    (q-plates, radial polarizers). Applying the mask moves it to the
    field's device.
    """

    def __init__(self, x, y, wavelength, device=None):
        super().__init__(x, y, wavelength, device=device)
        nx, ny = len(self.x), len(self.y)
        self.M = np.broadcast_to(np.eye(2, dtype=complex),
                                 (nx, ny, 2, 2)).copy()

    # -- device constructors -------------------------------------
    def _set(self, J):
        nx, ny = len(self.x), len(self.y)
        self.M = np.broadcast_to(np.asarray(J, dtype=complex),
                                 (nx, ny, 2, 2)).copy()
        return self

    def polarizer_linear(self, azimuth=0.0):
        return self._set(polarizer_linear(azimuth))

    def quarter_waveplate(self, azimuth=0.0):
        return self._set(quarter_waveplate(azimuth))

    def half_waveplate(self, azimuth=0.0):
        return self._set(half_waveplate(azimuth))

    def polarizer_retarder(self, retardance=0.0, p1=1.0, p2=1.0,
                           azimuth=0.0):
        return self._set(retarder(retardance, azimuth, p1, p2))

    def q_plate(self, q=1, alpha0=0.0):
        """Half-wave plate whose fast axis rotates q times around the
        center: azimuth = q * atan2(y, x) + alpha0."""
        X, Y = _XY(self.x, self.y)
        return self._set(half_waveplate(q * np.arctan2(Y, X) + alpha0))

    def apply_scalar_mask(self, u_mask):
        """Multiply a scalar transmission onto the Jones field."""
        u = (u_mask.u if isinstance(u_mask, ScalarFieldXY) else u_mask)
        self.M = self.M * _host(u)[..., None, None]
        return self

    def apply_circle(self, r0=(0.0, 0.0), radius=None):
        """Zero the Jones field outside a circular pupil."""
        X, Y = _XY(self.x, self.y)
        if radius is None:
            radius = 0.5 * min(self.x[-1] - self.x[0],
                               self.y[-1] - self.y[0])
        inside = ((X - r0[0]) ** 2 + (Y - r0[1]) ** 2) <= radius ** 2
        self.M = self.M * inside[..., None, None]
        return self

    def pupil(self, r0=(0.0, 0.0), radius=None, angle=0.0):
        """Elliptic pupil: identity Jones inside, zero outside. radius may
        be a scalar or (rx, ry); ``angle`` rotates the ellipse."""
        X, Y = _XY(self.x, self.y)
        if radius is None:
            radius = (0.5 * (self.x[-1] - self.x[0]),
                      0.5 * (self.y[-1] - self.y[0]))
        rx, ry = ((radius, radius) if np.isscalar(radius) else radius)
        Xr = (X - r0[0]) * np.cos(angle) + (Y - r0[1]) * np.sin(angle)
        Yr = -(X - r0[0]) * np.sin(angle) + (Y - r0[1]) * np.cos(angle)
        inside = (Xr / rx) ** 2 + (Yr / ry) ** 2 <= 1.0
        self.M = self.M * inside[..., None, None]
        return self

    def complementary_masks(self, u_mask, J_on, J_off, threshold=0.5):
        """Binary scalar mask -> two-region Jones device: pixels where
        |u| > threshold get J_on, the rest J_off."""
        u = (u_mask.u if isinstance(u_mask, ScalarFieldXY) else u_mask)
        t = (np.abs(_host(u)) > threshold)[..., None, None]
        self.M = np.where(t, np.asarray(J_on, dtype=complex),
                          np.asarray(J_off, dtype=complex)) \
            * np.ones_like(self.M)
        return self

    def multilevel_mask(self, u_mask, states, discretize=True):
        """Multi-level scalar mask -> per-level Jones devices: level i of
        ``u_mask`` (n levels over [0, 1]) gets Jones matrix
        ``states[i]``."""
        u = np.abs(_host(
            u_mask.u if isinstance(u_mask, ScalarFieldXY) else u_mask))
        n = len(states)
        levels = np.linspace(u.min(), u.max(), n)
        idx = (np.argmin(np.abs(u[..., None] - levels[None, None, :]),
                         axis=-1) if discretize
               else np.clip((u * n).astype(int), 0, n - 1))
        Js = np.asarray(states, dtype=complex)      # (n, 2, 2)
        self.M = Js[idx] * np.ones_like(self.M)
        return self

    # -- application ---------------------------------------------
    def __mul__(self, field: VectorFieldXY) -> VectorFieldXY:
        """Apply the mask to a vector field: E' = M E, one einsum over
        the grid on the field's device."""
        E = torch.stack([field.Ex, field.Ey], dim=-1)
        M = torch.as_tensor(self.M, device=field.device)
        Ep = torch.einsum("xyij,xyj->xyi", M, E)
        out = VectorFieldXY(field.x, field.y, field.wavelength, field.n,
                            device=field.device)
        out.incident_field(Ep[..., 0], Ep[..., 1])
        return out

    apply = __mul__


class VectorSourceXY(VectorFieldXY):
    """Structured-polarization sources on ``device``.

    Every method takes ``u``: a scalar envelope — complex constant,
    (nx, ny) array or tensor, or ``ScalarFieldXY`` — and imposes the
    polarization structure on it over the whole grid at once.
    """

    def _envelope(self, u):
        nx, ny = len(self.x), len(self.y)
        if isinstance(u, ScalarFieldXY):
            u = u.u
        if isinstance(u, (int, float, complex)):
            return torch.full((nx, ny), complex(u), dtype=torch.complex128,
                              device=self.device)
        return torch.broadcast_to(_complex(u, self.device), (nx, ny))

    def _angle(self, r0):
        X, Y = _XY(self.x, self.y)
        return torch.as_tensor(np.arctan2(Y - r0[1], X - r0[0]),
                               device=self.device)

    def constant_wave(self, u=1.0, v=(1.0, 0.0), normalize=False):
        """Uniform Jones vector ``v``."""
        v = np.asarray(v, dtype=complex)
        if normalize:
            v = v / np.linalg.norm(v)
        e = self._envelope(u)
        return self.incident_field(complex(v[0]) * e, complex(v[1]) * e)

    def radial_wave(self, u=1.0, r0=(0.0, 0.0)):
        """E parallel to the radial unit vector."""
        th, e = self._angle(r0), self._envelope(u)
        return self.incident_field(torch.cos(th) * e, torch.sin(th) * e)

    def azimuthal_wave(self, u=1.0, r0=(0.0, 0.0)):
        """E parallel to the azimuthal unit vector (sign convention
        (sin, -cos), as in the JAX package)."""
        th, e = self._angle(r0), self._envelope(u)
        return self.incident_field(torch.sin(th) * e, -torch.cos(th) * e)

    def radial_inverse_wave(self, u=1.0, r0=(0.0, 0.0)):
        th, e = self._angle(r0), self._envelope(u)
        return self.incident_field(-torch.cos(th) * e, -torch.sin(th) * e)

    def azimuthal_inverse_wave(self, u=1.0, r0=(0.0, 0.0)):
        th, e = self._angle(r0), self._envelope(u)
        return self.incident_field(-torch.sin(th) * e, torch.cos(th) * e)

    def spiral_polarized_beam(self, u=1.0, r0=(0.0, 0.0), alpha=0.0):
        """Spiral polarization at angle ``alpha`` to the azimuthal
        direction (Ramirez-Sanchez et al., J. Opt. A 11, 085708 (2009))."""
        th, e = self._angle(r0), self._envelope(u)
        return self.incident_field(-torch.sin(th + alpha) * e,
                                   torch.cos(th + alpha) * e)

    def local_polarized_vector_wave(self, u=1.0, r0=(0.0, 0.0), m=1,
                                    fi0=0.0):
        """Linear polarization angle delta = m*theta + fi0."""
        d = m * self._angle(r0) + fi0
        e = self._envelope(u)
        return self.incident_field(torch.cos(d) * e, torch.sin(d) * e)

    def local_polarized_vector_wave_radial(self, u=1.0, r0=(0.0, 0.0),
                                           m=1, fi0=0.0, radius0=None):
        """delta = 2 pi m r / radius0 + fi0."""
        X, Y = _XY(self.x, self.y)
        r = np.hypot(X - r0[0], Y - r0[1])
        if radius0 is None:
            radius0 = 0.5 * (self.x[-1] - self.x[0])
        d = torch.as_tensor(2 * np.pi * m * r / radius0 + fi0,
                            device=self.device)
        e = self._envelope(u)
        return self.incident_field(torch.cos(d) * e, torch.sin(d) * e)

    def local_polarized_vector_wave_hybrid(self, u=1.0, r0=(0.0, 0.0),
                                           m=1, n=1, fi0=0.0,
                                           radius0=None):
        """delta = m*theta + 2 pi n r / radius0 + fi0."""
        X, Y = _XY(self.x, self.y)
        r = np.hypot(X - r0[0], Y - r0[1])
        if radius0 is None:
            radius0 = 0.5 * (self.x[-1] - self.x[0])
        d = torch.as_tensor(m * np.arctan2(Y - r0[1], X - r0[0])
                            + 2 * np.pi * n * r / radius0 + fi0,
                            device=self.device)
        e = self._envelope(u)
        return self.incident_field(torch.cos(d) * e, torch.sin(d) * e)

    def mask_circle(self, r0=(0.0, 0.0), radius=None):
        X, Y = _XY(self.x, self.y)
        if radius is None:
            radius = 0.5 * min(self.x[-1] - self.x[0],
                               self.y[-1] - self.y[0])
        inside = torch.as_tensor(((X - r0[0]) ** 2 + (Y - r0[1]) ** 2)
                                 <= radius ** 2, device=self.device)
        self.Ex = self.Ex * inside
        self.Ey = self.Ey * inside
        self._fill_Ez()
        return self


# ------------------------------------------------------------------
# polarization analysis on VectorFieldXY
# ------------------------------------------------------------------

def polarization_states(field: VectorFieldXY):
    """(S0, S1, S2, S3) per pixel — ``field.stokes()``."""
    return field.stokes()


def polarization_ellipse(field: VectorFieldXY, eps=1e-30):
    """Per-pixel ellipse parameters (A, B, theta, h): semi-axes,
    orientation, handedness."""
    S0, S1, S2, S3 = field.stokes()
    Ip = torch.sqrt(S1 ** 2 + S2 ** 2 + S3 ** 2)
    Labs = torch.sqrt(S1 ** 2 + S2 ** 2)
    A = torch.sqrt(torch.clamp(0.5 * (Ip + Labs), min=0.0))
    B = torch.sqrt(torch.clamp(0.5 * (Ip - Labs), min=0.0))
    theta = 0.5 * torch.atan2(S2, S1 + eps)
    h = torch.sign(S3 + eps)
    return A, B, theta, h


Vector_mask_XY = VectorMaskXY
Vector_source_XY = VectorSourceXY

"""On-axis / longitudinal scalar fields u(z).

The port's own copy of ``pyqed_tpu/beam/fieldz.py``: a thin NumPy
analysis container. Z fields are extracted from XZ sheets or XYZ volumes
propagated on the device (``ScalarFieldXZ.profile_longitudinal``, or
``ScalarFieldXYZ.on_axis`` copied to the host) and analyzed on the host
(FWHM, DOF, intensity statistics).
"""
from __future__ import annotations

import numpy as np

from .optics import FWHM1D, DOF, normalize_field, field_parameters


class ScalarFieldZ:
    """Complex field sampled along the propagation axis
    (reference: scalar_fields_Z.py:52)."""

    def __init__(self, z, wavelength=None, n_background=1.0, info=""):
        self.z = np.asarray(z, dtype=float)
        self.wavelength = wavelength
        self.n_background = n_background
        self.info = info
        self.u = np.zeros_like(self.z, dtype=complex)

    # ------------------------------------------------------------ algebra
    def __add__(self, other):
        out = self.duplicate(clear=True)
        out.u = self.u + other.u
        return out

    def __sub__(self, other):
        out = self.duplicate(clear=True)
        out.u = self.u - other.u
        return out

    def duplicate(self, clear=False):
        out = ScalarFieldZ(self.z, self.wavelength, self.n_background,
                           self.info)
        if not clear:
            out.u = np.array(self.u)
        return out

    def clear_field(self):
        self.u = np.zeros_like(self.u)

    # ---------------------------------------------------------------- I/O
    def save_data(self, filename, description=""):
        """NPZ dump (the reference pickles; NPZ is portable)."""
        np.savez(filename, z=self.z, u=self.u,
                 wavelength=np.asarray(self.wavelength or 0.0),
                 description=np.asarray(description))

    @classmethod
    def load_data(cls, filename):
        d = np.load(filename, allow_pickle=False)
        out = cls(d["z"], float(d["wavelength"]) or None)
        out.u = d["u"]
        return out

    # ----------------------------------------------------------- editing
    def cut_resample(self, z_limits=None, num_points=None,
                     new_field=False):
        """Cut to (z0, z1) and optionally resample to num_points via
        linear interpolation of amplitude and phase
        (reference: scalar_fields_Z.py:210 — whose resample branch
        interpolates |u| and Im u and calls np.ezp; fixed here to
        amplitude/unwrapped-phase interpolation)."""
        z0, z1 = (self.z[0], self.z[-1]) if not z_limits else z_limits
        z0 = max(z0, self.z[0])
        z1 = min(z1, self.z[-1])
        if num_points:
            z_new = np.linspace(z0, z1, num_points)
            amp = np.interp(z_new, self.z, np.abs(self.u))
            phase = np.interp(z_new, self.z,
                              np.unwrap(np.angle(self.u)))
            u_new = amp * np.exp(1j * phase)
        else:
            i0 = int(np.argmin(np.abs(self.z - z0)))
            i1 = int(np.argmin(np.abs(self.z - z1)))
            z_new = self.z[i0:i1 + 1]
            u_new = self.u[i0:i1 + 1]
        if new_field:
            out = ScalarFieldZ(z_new, self.wavelength)
            out.u = u_new
            return out
        self.z, self.u = z_new, u_new
        return self

    def normalize(self, kind="intensity", new_field=False):
        u_new = normalize_field(self.u, kind)
        if new_field:
            out = self.duplicate(clear=True)
            out.u = u_new
            return out
        self.u = u_new
        return self

    # ---------------------------------------------------------- analysis
    def intensity(self):
        return np.abs(self.u) ** 2

    def average_intensity(self):
        return float(self.intensity().mean())

    def field_parameters(self):
        return field_parameters(self.u)

    def FWHM1D(self, percentage=0.5, remove_background=None):
        return FWHM1D(self.z, self.intensity(), percentage,
                      remove_background)

    def DOF(self, w_factor=np.sqrt(2), w_fixed=0.0):
        """Depth of focus of the on-axis intensity: by Saleh-Teich the
        axial intensity of a Gaussian beam is I0/(1+(z/zR)^2), so the
        width-vs-z curve is w0*sqrt(I0/I(z))
        (reference: scalar_fields_Z.py:330)."""
        I = self.intensity()
        widths = 1.0 / np.sqrt(np.maximum(I / I.max(), 1e-30))
        return DOF(self.z, widths, w_factor, w_fixed)

"""Beam/optics analysis layer: widths, FWHM, depth of focus, MTF,
spectra, Fresnel coefficients.

The port's own copy of ``pyqed_tpu/beam/optics.py``: pure NumPy on small
1D/2D analysis arrays (post-processing diagnostics, not propagation hot
paths). Fields produced on the device are copied to the host first.

Deliberate fixes vs the reference (noted per function):
- ``reflectance_transmitance_dielectric`` no longer swaps its arguments
  when delegating to the coefficient routine
  (utils_optics.py:853 passes (n1, theta_i, n2) into a
  (theta_i, n1, n2) signature);
- the spectrum builders return the normalized weights for BOTH branches
  (utils_optics.py:664 gauss_spectrum NameErrors for normalize=False);
- ``remove_background`` subtraction actually subtracts the minimum
  (utils_optics.py:121 ``intensity - intensity - min()``).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "beam_width_1D", "beam_width_2D", "width_percentage",
    "FWHM1D", "FWHM2D", "DOF", "detect_intensity_range",
    "MTF_ideal", "MTF_parameters", "lines_mm_2_cycles_degree",
    "gauss_spectrum", "lorentz_spectrum", "uniform_spectrum",
    "normalize_field", "field_parameters",
    "convert_phase2heights", "convert_amplitude2heights",
    "fresnel_coefficients_dielectric",
    "reflectance_transmitance_dielectric",
    "fresnel_coefficients_complex",
    "reflectance_transmitance_complex",
    "roughness_1D", "roughness_2D",
]


def _nearest(values, target):
    """Index of the element of ``values`` closest to ``target`` plus the
    signed distance value-target (the reference's utils_math.nearest)."""
    values = np.asarray(values)
    i = int(np.argmin(np.abs(values - target)))
    return i, values[i], float(values[i] - target)


# ------------------------------------------------------------------
# widths
# ------------------------------------------------------------------

def beam_width_1D(u, x, remove_background=False):
    """Second-moment (D4σ-style) beam width and centroid
    (reference: utils_optics.py:104 — which weights by |u|⁴; kept for
    parity: for u = exp(−x²/w²) the returned width is w·√2).

    Returns (width, x_mean)."""
    u = np.asarray(u)
    x = np.asarray(x)
    intensity = np.abs(u) ** 4
    if remove_background:
        intensity = intensity - intensity.min()
    P = intensity.sum()
    x_mean = (intensity * x).sum() / P
    x2_mean = (intensity * (x - x_mean) ** 2).sum() / P
    return 4 * np.sqrt(x2_mean), x_mean


def beam_width_2D(x, y, intensity, remove_background=False):
    """ISO 11146 principal-axis beam widths from second moments
    (reference: utils_optics.py:179).

    Returns (dx, dy, principal_axis_angle,
    (x_mean, y_mean, x2_mean, y2_mean, xy_mean))."""
    x = np.asarray(x)
    y = np.asarray(y)
    intensity = np.asarray(intensity, dtype=float)
    X, Y = np.meshgrid(x, y, indexing="ij")
    if remove_background:
        intensity = intensity - intensity.min()
    P = intensity.sum()
    x_mean = (intensity * X).sum() / P
    y_mean = (intensity * Y).sum() / P
    x2 = (intensity * (X - x_mean) ** 2).sum() / P
    y2 = (intensity * (Y - y_mean) ** 2).sum() / P
    xy = (intensity * (X - x_mean) * (Y - y_mean)).sum() / P
    gamma = np.sign(x2 - y2 + 1e-10)
    rt = np.sqrt((x2 - y2) ** 2 + 4 * xy ** 2)
    dx = 2 * np.sqrt(2) * np.sqrt(x2 + y2 + gamma * rt)
    dy = 2 * np.sqrt(2) * np.sqrt(x2 + y2 - gamma * rt)
    principal_axis = 0.5 * np.arctan2(2 * xy, x2 - y2)
    return dx, dy, principal_axis, (x_mean, y_mean, x2, y2, xy)


def width_percentage(x, y, percentage=0.5):
    """Width of profile y(x) at ``percentage`` of its maximum
    (reference: utils_optics.py:131). Returns
    (width, (x_left, x_max, x_right), (i_left, i_max, i_right))."""
    x = np.asarray(x)
    y = np.asarray(y)
    level = percentage * y.max()
    i_max = int(np.argmax(y))
    if i_max == 0:
        i_left = 0
    else:
        i_left, _, _ = _nearest(y[:i_max], level)
    if i_max == len(y) - 1:
        i_right = len(y) - 1
    else:
        i_right, _, _ = _nearest(y[i_max:-1], level)
        i_right += i_max
    width = x[i_right] - x[i_left]
    return width, (x[i_left], x[i_max], x[i_right]), (i_left, i_max,
                                                      i_right)


def FWHM1D(x, intensity, percentage=0.5, remove_background=None):
    """Full width at ``percentage`` of maximum with sub-pixel linear
    interpolation at both crossings (reference: utils_optics.py:298).
    remove_background: 'mean' | 'min' | float threshold | None."""
    x = np.asarray(x, dtype=float)
    intensity = np.asarray(intensity, dtype=float).copy()
    if remove_background == "mean":
        bg = intensity.mean()
    elif remove_background == "min":
        bg = intensity.min()
    else:
        bg = 0.0
    intensity = intensity - bg
    if isinstance(remove_background, float):
        intensity[intensity < remove_background * intensity.max()] = 0

    dx = x[1] - x[0]
    amp_max = intensity.max()
    level = percentage * amp_max
    i_max = int(np.argmax(intensity))

    i_left, _, d_left = _nearest(intensity[:i_max] if i_max > 0
                                 else intensity[:1], level)
    slope_left = ((intensity[i_left + 1] - intensity[i_left]) / dx
                  if i_left + 1 < len(intensity) else 1.0)
    i_r, _, d_right = _nearest(intensity[i_max:], level)
    i_right = i_r + i_max
    slope_right = ((intensity[i_right] - intensity[i_right - 1]) / dx
                   if i_right > 0 else -1.0)

    x_left = i_left * dx - (d_left / slope_left if slope_left != 0
                            else 0.0)
    x_right = i_right * dx - (d_right / slope_right if slope_right != 0
                              else 0.0)
    return x_right - x_left


def FWHM2D(x, y, intensity, percentage=0.5, remove_background=None):
    """FWHM along x and y through the intensity maximum
    (reference: utils_optics.py:364). intensity is indexed [ix, iy]."""
    intensity = np.asarray(intensity)
    i_x, i_y = np.unravel_index(np.argmax(intensity), intensity.shape)
    fw_x = FWHM1D(x, intensity[:, i_y], percentage, remove_background)
    fw_y = FWHM1D(y, intensity[i_x, :], percentage, remove_background)
    return fw_x, fw_y


def DOF(z, widths, w_factor=np.sqrt(2), w_fixed=0.0):
    """Depth of focus from a width-vs-z curve: the z range where
    w ≤ w_factor·w0 (reference: utils_optics.py:396; Saleh & Teich
    eqs. 3.1-18/3.1-22). Returns (z_rayleigh_range, beam_waist,
    (z_min, z_0, z_max))."""
    z = np.asarray(z)
    widths = np.asarray(widths)
    if w_fixed == 0:
        beam_waist = widths.min()
        i_w0 = int(np.argmin(widths))
    else:
        beam_waist = w_fixed
        i_w0, _, _ = _nearest(widths, beam_waist)
    i_left, _, _ = _nearest(widths[:i_w0] if i_w0 > 0 else widths[:1],
                            w_factor * beam_waist)
    i_r, _, _ = _nearest(widths[i_w0:], w_factor * beam_waist)
    i_right = i_r + i_w0
    return (z[i_right] - z[i_left], beam_waist,
            np.array([z[i_left], z[i_w0], z[i_right]]))


def detect_intensity_range(x, intensity, percentage=0.95):
    """(x_min, x_max) enclosing ``percentage`` of the cumulative beam
    power, centered (reference: utils_optics.py:472)."""
    x = np.asarray(x)
    I_cum = np.cumsum(np.asarray(intensity, dtype=float))
    pc = percentage + (1 - percentage) / 2
    i_min, _, _ = _nearest(I_cum, (1 - pc) * I_cum[-1])
    i_max, _, _ = _nearest(I_cum, pc * I_cum[-1])
    return x[i_min], x[i_max]


# ------------------------------------------------------------------
# MTF
# ------------------------------------------------------------------

def MTF_ideal(frequencies, wavelength, diameter, focal, kind="1D"):
    """Diffraction-limited MTF of an ideal lens at cutoff
    f_max = 1/(λ·F#) (frequencies in lines/mm, λ in µm — hence the 1000;
    reference: utils_optics.py:531). Returns (MTF, frequency_max)."""
    frequencies = np.asarray(frequencies, dtype=float)
    F_number = focal / diameter
    frequency_max = 1000.0 / (wavelength * F_number)
    fx = np.abs(frequencies / frequency_max)
    if kind == "1D":
        MTF = np.where(fx > 1, 0.0, 1 - fx)
    elif kind == "2D":
        fx_c = np.clip(fx, 0.0, 1.0)
        a = np.arccos(fx_c)
        MTF = np.where(fx > 1, 0.0,
                       (2 / np.pi) * (a - np.cos(a) * np.sin(a)))
    else:
        raise ValueError(f"kind must be '1D' or '2D', got {kind!r}")
    return MTF, frequency_max


def lines_mm_2_cycles_degree(lines_mm, focal):
    """lines/mm -> cycles/degree for a lens of the given focal
    (reference: utils_optics.py:589)."""
    return 180 * focal * np.asarray(lines_mm) / np.pi


def MTF_parameters(MTF, MTF_ideal_, lines_mm=50):
    """Strehl ratio (area ratio of measured to ideal MTF) and the MTF
    ratio/values at a probe frequency (reference: utils_optics.py:602).

    MTF, MTF_ideal_: (frequencies, mtf) pairs. Returns
    (strehl_ratio, mtf_ratio, mtf_real_at_f, mtf_ideal_at_f)."""
    fx_real, mtf_real = (np.asarray(a, dtype=float) for a in MTF)
    fx_ideal, mtf_ideal = (np.asarray(a, dtype=float) for a in MTF_ideal_)
    i0r, _, _ = _nearest(fx_real, 0)
    i0i, _, _ = _nearest(fx_ideal, 0)
    dxr = fx_real[1] - fx_real[0]
    dxi = fx_ideal[1] - fx_ideal[0]
    mtf_real, fx_real = mtf_real[i0r:], fx_real[i0r:]
    mtf_ideal, fx_ideal = mtf_ideal[i0i:], fx_ideal[i0i:]
    strehl_ratio = (mtf_real.sum() * dxr) / (mtf_ideal.sum() * dxi)
    ii, _, _ = _nearest(fx_ideal, lines_mm)
    ir, _, _ = _nearest(fx_real, lines_mm)
    v_ideal = np.abs(mtf_ideal[ii])
    v_real = np.abs(mtf_real[ir])
    return strehl_ratio, v_real / v_ideal, v_real, v_ideal


# ------------------------------------------------------------------
# spectra / field utilities
# ------------------------------------------------------------------

def gauss_spectrum(wavelengths, w_central, Dw, normalize=True):
    """Gaussian spectral weights (reference: utils_optics.py:664)."""
    w = np.exp(-(np.asarray(wavelengths) - w_central) ** 2
               / (2 * Dw ** 2))
    return w / w.sum() if normalize else w


def lorentz_spectrum(wavelengths, w_central, Dw, normalize=True):
    """Lorentzian spectral weights (reference: utils_optics.py:682)."""
    w = 1.0 / (1 + ((np.asarray(wavelengths) - w_central)
                    / (Dw / 2)) ** 2)
    return w / w.sum() if normalize else w


def uniform_spectrum(wavelengths, normalize=True):
    """Flat spectral weights (reference: utils_optics.py:700)."""
    w = np.ones_like(np.asarray(wavelengths, dtype=float))
    return w / w.sum() if normalize else w


def normalize_field(u, kind="intensity"):
    """Normalize a field (reference: utils_optics.py:718 ``normalize``):
    'intensity' -> max |u| = 1; 'amplitude' -> max sqrt|u| = 1."""
    u = np.asarray(u)
    if kind == "intensity":
        return u / np.abs(u).max()
    if kind == "amplitude":
        return u / np.sqrt(np.abs(u)).max()
    raise ValueError(f"unknown normalization {kind!r}")


def field_parameters(u, has_amplitude_sign=False):
    """(amplitude, intensity, phase) of a complex field
    (reference: utils_optics.py:754)."""
    u = np.asarray(u)
    intensity = np.abs(u) ** 2
    phase = np.angle(u)
    if has_amplitude_sign:
        amplitude = np.sign(np.real(u)) * np.abs(u)
    else:
        amplitude = np.abs(u)
    return np.real(amplitude), intensity, phase


def convert_phase2heights(phase, wavelength, n, n_background):
    """Phase -> material depth: φ = k (n − n0) h
    (reference: utils_optics.py:783)."""
    k = 2 * np.pi / wavelength
    return np.asarray(phase) / (k * (np.real(n) - n_background))


def convert_amplitude2heights(amplitude, wavelength, kappa,
                              n_background=1.0, eps_depth=1e-4):
    """Amplitude attenuation -> absorber depth: |t| = exp(−2πκh/λ)
    (reference: utils_optics.py:803)."""
    a = np.maximum(np.asarray(amplitude, dtype=float), eps_depth)
    return np.log(a) * wavelength / (-2 * np.pi * kappa)


# ------------------------------------------------------------------
# Fresnel coefficients
# ------------------------------------------------------------------

def fresnel_coefficients_dielectric(theta_i, n1, n2):
    """(r_perp, r_par, t_perp, t_par) at a dielectric interface
    (reference: utils_optics.py:825)."""
    theta_i = np.asarray(theta_i, dtype=float)
    theta_t = np.arcsin(np.clip(n1 * np.sin(theta_i) / n2, -1, 1))
    ci, ct = np.cos(theta_i), np.cos(theta_t)
    r_par = (n2 * ci - n1 * ct) / (n2 * ci + n1 * ct)
    r_perp = (n1 * ci - n2 * ct) / (n1 * ci + n2 * ct)
    t_par = 2 * n1 * ci / (n2 * ci + n1 * ct)
    t_perp = 2 * n1 * ci / (n1 * ci + n2 * ct)
    return r_perp, r_par, t_perp, t_par


def reflectance_transmitance_dielectric(theta_i, n1, n2):
    """(R_perp, R_par, T_perp, T_par); energy conservation R + T = 1
    per polarization. (The reference at utils_optics.py:853 delegates
    with its arguments swapped — fixed here, pinned by the
    R+T=1 test.)"""
    r_perp, r_par, t_perp, t_par = fresnel_coefficients_dielectric(
        theta_i, n1, n2)
    theta_t = np.arcsin(np.clip(n1 * np.sin(np.asarray(theta_i)) / n2,
                                -1, 1))
    ratio = (n2 * np.cos(theta_t)) / (n1 * np.cos(theta_i))
    return (np.abs(r_perp) ** 2, np.abs(r_par) ** 2,
            np.abs(t_perp) ** 2 * ratio, np.abs(t_par) ** 2 * ratio)


def fresnel_coefficients_complex(theta_i, n1, n2c):
    """Fresnel coefficients for an absorbing second medium n̂ = n − iκ
    (reference: utils_optics.py:883)."""
    theta_i = np.asarray(theta_i, dtype=float)
    kiz = np.cos(theta_i)
    ktcz = np.sqrt(np.asarray(n2c) ** 2
                   - n1 ** 2 * np.sin(theta_i) ** 2 + 0j)
    ktc2 = np.asarray(n2c) ** 2
    ki2 = n1 ** 2
    r_perp = (kiz - ktcz) / (kiz + ktcz)
    t_perp = 2 * kiz / (kiz + ktcz)
    r_par = (kiz * ktc2 - ktcz * ki2) / (kiz * ktc2 + ktcz * ki2)
    t_par = 2 * kiz * ktc2 / (kiz * ktc2 + ktcz * ki2)
    return r_perp, r_par, t_perp, t_par


def reflectance_transmitance_complex(theta_i, n1, n2c):
    """(R_perp, R_par, T_perp, T_par) for an absorbing second medium
    (reference: utils_optics.py:909)."""
    r_perp, r_par, t_perp, t_par = fresnel_coefficients_complex(
        theta_i, n1, n2c)
    theta_i = np.asarray(theta_i, dtype=float)
    kiz = np.cos(theta_i)
    ki2 = n1 ** 2
    ktcz = np.sqrt(np.asarray(n2c) ** 2
                   - n1 ** 2 * np.sin(theta_i) ** 2 + 0j)
    ktc2 = np.asarray(n2c) ** 2
    n2R, kappa2 = np.real(n2c), -np.imag(n2c)
    B = n2R ** 2 - kappa2 ** 2 - n1 ** 2 * np.sin(theta_i) ** 2
    ktz = np.sqrt(0.5 * (B + np.sqrt(B ** 2
                                     + 4 * n2R ** 2 * kappa2 ** 2)))
    R_perp = np.abs(r_perp) ** 2
    R_par = np.abs(r_par) ** 2
    T_perp = ktz * np.abs(t_perp) ** 2 / kiz
    T_par = ki2 * np.real(ktcz / ktc2) * np.abs(t_par) ** 2 / kiz
    return R_perp, R_par, T_perp, T_par


# ------------------------------------------------------------------
# rough surfaces (Ogilvy correlated-Gaussian topography)
# ------------------------------------------------------------------

def roughness_1D(x, t, s, kind="normal", seed=0):
    """Correlated rough-surface topography h(x) with correlation
    length ``t`` and height std ``s`` (J.A. Ogilvy, "Theory of Wave
    Scattering from Random Rough Surfaces", p. 224; reference:
    pyqed/beam/utils_optics.py:14 ``roughness_1D``).

    ``kind='normal'``: white Gaussian heights convolved with the
    exp(-2 x²/t²) correlation kernel (unit-L2 weights keep the std at
    ``s``); ``kind='uniform'``: uncorrelated uniform heights in
    [-s/2, s/2).  ``seed`` replaces the reference's global numpy RNG
    so masks are reproducible."""
    x = np.asarray(x, float)
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return s * (rng.random(len(x)) - 0.5)
    if kind != "normal":
        raise ValueError(f"kind {kind!r} (use 'normal' or 'uniform')")
    dx = x[1] - x[0]
    M = max(1, round(4 * t / (np.sqrt(2.0) * dx)))
    w = np.exp(-2.0 * (np.arange(-M, M + 1) * dx) ** 2 / t ** 2)
    w = w / np.sqrt((w ** 2).sum())
    h = s * rng.standard_normal(len(x) + 2 * M)
    return np.convolve(h, w, mode="valid")[:len(x)]


def roughness_2D(x, y, t, s, seed=0):
    """2D correlated rough surface h(x, y): anisotropic correlation
    lengths ``t=(tx, ty)`` (scalar = isotropic), height std ``s``
    (reference: pyqed/beam/utils_optics.py:57 ``roughness_2D``).
    Returns (len(x), len(y))."""
    if np.isscalar(t):
        t = (t, t)
    tx, ty = t
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    dx = x[1] - x[0]
    rng = np.random.default_rng(seed)
    M = max(1, round(4 * tx / (np.sqrt(2.0) * dx)))
    gx, gy = np.meshgrid(np.arange(-M, M + 1) * dx,
                         np.arange(-M, M + 1) * dx, indexing="ij")
    w = np.exp(-2.0 * (gx ** 2 / tx ** 2 + gy ** 2 / ty ** 2))
    w = w / np.sqrt((w ** 2).sum())
    h = s * rng.standard_normal((len(x) + 2 * M, len(y) + 2 * M))
    from scipy.signal import fftconvolve
    return fftconvolve(h, w, mode="valid")[:len(x), :len(y)]

"""Laser pulses and entangled-photon (biphoton) sources (PyTorch).

Counterpart of ``pyqed_tpu/models/pulse.py`` (reference: pyqed/optics.py —
``Pulse:230``, ``GaussianPulse:353``, ``ChirpedPulse:454``,
``Biphoton:545``, ``intensity_to_field:22``, ``_jsa:791``, ``jta:737``,
``rdm:761``, ``hom:844``).

A pulse's field is evaluated where its argument lives: a Python float or
a NumPy array gives NumPy (a float gives a NumPy float, which the solvers
read on the host once per RK4 stage, so a driven step launches nothing
for the field), a tensor gives a tensor on its device. The amplitude
functions (``jsa``, ``jta``, ``rdm``, ``hom``, the Schmidt helpers) move
their arguments to ``device`` and run there, and ``Biphoton`` and
``Analyser`` keep their grids on ``device``: the card when None.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import dag
from ..ops.math import _t, interval, rect, sinc
from ..units import alpha as fine_structure
from ..units import au2ev, au2fs, au2watt_per_centimeter_squared

FWHM_FACTOR = 2.3548200450309493  # 2 sqrt(2 ln 2)


def _xp(t):
    """The array namespace of ``t``: torch for tensors, else NumPy."""
    return torch if isinstance(t, torch.Tensor) else np


def _on(dev, *xs):
    """Each of ``xs`` as a tensor on ``dev``."""
    return tuple(_t(x).to(dev) for x in xs)


def _host_value(v):
    """A JAX or NumPy scalar as a Python number, an array as NumPy; other
    values unchanged."""
    if hasattr(v, "__array__") and not isinstance(v, torch.Tensor):
        a = np.asarray(v)
        return a.item() if a.ndim == 0 else a
    return v


def intensity_to_field(I):
    """E (a.u.) from intensity in W/cm^2 (reference: pyqed/optics.py:22)."""
    return np.sqrt(2.0 * I * 4.0 * np.pi / au2watt_per_centimeter_squared
                   / fine_structure)


def field_to_intensity(E):
    """Intensity (W/cm^2) from field amplitude (a.u.), the inverse of
    :func:`intensity_to_field`."""
    return E ** 2 * au2watt_per_centimeter_squared * fine_structure \
        / (8.0 * np.pi)


def std_to_fwhm(tau):
    return FWHM_FACTOR * tau


def fwhm_to_std(fwhm):
    """Gaussian sigma from FWHM."""
    return fwhm / FWHM_FACTOR


class Pulse:
    """Gaussian pulse; ``efield`` returns the *real* field
    Re[A e^{-(t-tc)^2/2tau^2} e^{-i w (t-tc)}]
    (reference: pyqed/optics.py:230-340)."""

    def __init__(self, omegac=3.0 / au2ev, tau=5.0 / au2fs, tc=0.0, delay=0.0,
                 amplitude=0.001, intensity=None, cep=0.0, beta=0.0,
                 polarization=None):
        self.delay = delay
        self.tc = tc
        self.tau = tau
        self.fwhm = tau * FWHM_FACTOR
        self.sigma = tau
        self.omegac = omegac
        self.unit = 'au'
        self.amplitude = (intensity_to_field(intensity)
                          if intensity is not None else amplitude)
        self.cep = cep
        self.bandwidth = 1.0 / tau
        self.duration = 2.0 * tau
        self.beta = beta
        self.ndim = 1
        self.polarization = polarization

    @classmethod
    def from_reference(cls, ref):
        """The port's pulse of the same class name as the JAX pulse
        ``ref``, with its attributes (JAX arrays as NumPy)."""
        out = object.__new__(globals()[type(ref).__name__])
        out.__dict__.update({k: _host_value(v) for k, v in vars(ref).items()})
        return out

    def envelop(self, t):
        xp = _xp(t)
        return self.amplitude * xp.exp(-((t - self.tc) ** 2) / 2.0
                                       / self.tau ** 2)

    def spectrum(self, omega):
        xp = _xp(omega)
        return (self.amplitude * self.tau * np.sqrt(2.0 * np.pi)
                * xp.exp(-((omega - self.omegac) ** 2) * self.tau ** 2 / 2.0))

    def efield(self, t):
        return _xp(t).real(self.efield_complex(t))

    def field(self, t):
        return self.efield(t)

    def efield_complex(self, t):
        """Positive-frequency analytic field (half the real field's analytic
        signal, used by perturbative signal drivers)."""
        xp = _xp(t)
        return (self.amplitude
                * xp.exp(-((t - self.tc) ** 2) / 2.0 / self.tau ** 2)
                * xp.exp(-1j * self.omegac * (t - self.tc)))

    def E(self, t):
        if self.polarization is None:
            raise ValueError("polarization not set")
        xp = _xp(t)
        pol = np.asarray(self.polarization)
        if xp is torch:
            pol = torch.as_tensor(pol, device=t.device)
        return xp.real(pol * self.efield_complex(t))


class GaussianPulse(Pulse):
    """cos-carrier Gaussian pulse (reference: pyqed/optics.py:353-455)."""

    def efield(self, t):
        xp = _xp(t)
        return (self.amplitude
                * xp.exp(-((t - self.tc) ** 2) / 2.0 / self.tau ** 2)
                * xp.cos(self.omegac * (t - self.tc)))


class ChirpedPulse(Pulse):
    """Linearly chirped Gaussian pulse (reference: pyqed/optics.py:454-545)."""

    def efield(self, t):
        xp = _xp(t)
        u = t - self.tc
        E = (self.amplitude * xp.exp(-(u ** 2) / 2.0 / self.tau ** 2)
             * xp.exp(-1j * self.omegac * u)
             * xp.exp(-1j * self.beta * self.omegac * u ** 2 / self.tau))
        return xp.real(E)

    def spectrum(self, omega):
        a = complex(0.5 / self.tau ** 2 + 1j * self.beta * self.omegac
                    / self.tau)
        return (self.amplitude * complex(np.sqrt(np.pi / a))
                * _xp(omega).exp(-((omega - self.omegac) ** 2) / 4.0 / a))


# --------------------------------------------------------------- biphoton

def jsa(p, q, pump_bw, model="sinc", Te=None, device=None):
    """Joint spectral amplitude of an SPDC pair on the (q, p) grid, on
    ``device`` (reference: pyqed/optics.py:791-836)."""
    P, Q = torch.meshgrid(*_on(resolve_device(device), p, q), indexing="xy")
    sigma_plus = pump_bw
    pump = (np.sqrt(1.0 / (np.sqrt(2.0 * np.pi) * sigma_plus))
            * torch.exp(-((P + Q) ** 2) / 4.0 / sigma_plus ** 2))
    if model == "Gaussian":
        sigma_minus = 1.0 / Te
        beta = (np.sqrt(1.0 / np.sqrt(2.0 * np.pi) / sigma_minus)
                * torch.exp(-((P - Q) ** 2) / 4.0 / sigma_minus ** 2))
        return np.sqrt(2.0) * pump * beta
    if model == "sinc":
        beta = np.sqrt(0.5 * Te / np.pi) * sinc(Te * (P - Q) / 4.0)
        return pump * beta
    raise ValueError(f"unknown phase-matching model {model!r}")


def jta(t2, t1, omegap, sigmap, Te, device=None):
    """Analytic joint temporal amplitude for type-II SPDC, on ``device``
    (reference: pyqed/optics.py:737-760)."""
    t2, t1 = _on(resolve_device(device), t2, t1)
    omegas = omegap / 2.0
    omegai = omegap / 2.0
    tau = t2 - t1
    return (np.sqrt(sigmap / Te) * (2.0 * np.pi) ** 0.75
            * rect(tau / 2.0 / Te)
            * torch.exp(-(sigmap ** 2) * (t1 + t2) ** 2 / 4.0)
            * torch.exp(-1j * omegas * t1 - 1j * omegai * t2))


def rdm(f, dx=1.0, dy=1.0, which="x", device=None):
    """Reduced density matrix of a 2D amplitude, on ``device``
    (reference: pyqed/optics.py:761)."""
    f, = _on(resolve_device(device), f)
    if which == "x":
        return f @ dag(f) * dy
    if which == "y":
        return f.T @ f.conj() * dx
    raise ValueError("which can only be x or y.")


def hom(p, q, f, tau, device=None):
    """Hong-Ou-Mandel coincidence dip (reference: pyqed/optics.py:844),
    vectorized over the delays ``tau``, on ``device``."""
    p, q, f, tau = _on(resolve_device(device), p, q, f, tau)
    dp, dq = interval(p), interval(q)
    P, Q = torch.meshgrid(p, q, indexing="xy")
    phases = torch.exp(1j * (P - Q)[None, :, :] * tau[:, None, None])
    overlap = ((f.conj()[None] * f.T[None] * phases).sum(dim=(1, 2)).real
               * dp * dq)
    return 0.5 - 0.5 * overlap


def _freqs(n, d, device):
    """Angular frequencies of an n-point grid of spacing d, ascending."""
    return 2.0 * np.pi * torch.fft.fftshift(
        torch.fft.fftfreq(n, d=float(d), dtype=torch.float64, device=device))


def _fft2(f, dx, dy):
    """Continuous 2-D Fourier transform, as ``pyqed_tpu/ops/fft.py:71``:
    (freqx, freqy, g)."""
    nx, ny = f.shape
    g = torch.fft.fftshift(torch.fft.fft2(f)) * dx * dy
    return _freqs(nx, dx, f.device), _freqs(ny, dy, f.device), g


class Biphoton:
    """Entangled photon pair (reference: pyqed/optics.py:545-760). The
    frequency grids ``p``, ``q`` live on ``device`` (the card when
    None)."""

    def __init__(self, omegap, bw, Te, p=None, q=None, phase_matching="sinc",
                 device=None):
        self.device = resolve_device(device)
        self.omegap = omegap
        self.pump_bandwidth = bw
        self.phase_matching = phase_matching
        self.signal_center_frequency = omegap / 2.0
        self.idler_center_frequency = omegap / 2.0
        self.entanglement_time = Te
        self.jsa = None
        self.jta = None
        self.p = self.q = None
        if p is not None:
            self.set_grid(p, q)
        self.grid = [self.p, self.q]

    def set_grid(self, p, q):
        self.p, self.q = (_t(x).to(self.device) for x in (p, q))
        self.dp, self.dq = interval(self.p), interval(self.q)

    def get_jsa(self):
        self.jsa = jsa(self.p, self.q, self.pump_bandwidth,
                       model=self.phase_matching, Te=self.entanglement_time,
                       device=self.device)
        return self.jsa

    def get_jta(self):
        if self.jsa is None:
            raise ValueError("jsa is None. Call get_jsa() first.")
        ts, ti, jta_ = _fft2(self.jsa, self.dp, self.dq)
        self.jta = jta_
        return ts, ti, jta_

    def pump(self, bandwidth=None):
        """Pump spectral envelope alpha(p + q) on the (p, q) grid."""
        if bandwidth is None:
            bandwidth = self.pump_bandwidth
        P, Q = torch.meshgrid(self.p, self.q, indexing="ij")
        return (np.sqrt(1.0 / (np.sqrt(2.0 * np.pi) * bandwidth))
                * torch.exp(-(P + Q) ** 2 / (4.0 * bandwidth ** 2)))

    def detect(self):
        """Two-photon detection amplitude <0|E(t1)E(t2)|Phi> on the
        temporal grid conjugate to (p, q): both photon-ordering terms,
        carrier phases restored. Returns (t1, t2, d)."""
        if self.jsa is None:
            raise ValueError("Please call get_jsa() first.")
        om_s = self.signal_center_frequency
        om_i = self.idler_center_frequency
        t1, t2, jta_ = _fft2(self.jsa, self.dp, self.dq)
        T1, T2 = torch.meshgrid(t1, t2, indexing="xy")
        amp = np.sqrt(om_s * om_i)
        d = (torch.exp(-1j * om_i * T1 - 1j * om_s * T2) * amp * jta_.T
             + torch.exp(-1j * om_s * T1 - 1j * om_i * T2) * amp * jta_)
        return t1, t2, d

    def bandwidth(self, which="signal"):
        p, q = self.p, self.q
        dp, dq = interval(p), interval(q)
        f = self.jsa
        if which == "signal":
            rho = rdm(f, dy=dq, which="x", device=self.device)
            return torch.sqrt(torch.diagonal(rho) @ (p ** 2).to(rho.dtype)
                              * dp).real
        rho = rdm(f, dx=dp, which="y", device=self.device)
        return torch.sqrt(torch.diagonal(rho) @ (q ** 2).to(rho.dtype)
                          * dq).real

    def rdm(self, which="signal"):
        if which == "signal":
            return rdm(self.jsa, dy=self.dq, which="x", device=self.device)
        return rdm(self.jsa, dx=self.dp, which="y", device=self.device)

    def schmidt_number(self):
        """Schmidt number K of the JSA (effective mode count)."""
        if self.jsa is None:
            self.get_jsa()
        return schmidt_number(self.jsa, self.dp, self.dq, device=self.device)

    def g2(self):
        """Unheralded second-order coherence of the signal beam,
        g2(0) = 1 + 1/K with K the Schmidt number (each marginal of an
        SPDC twin beam is a K-mode thermal state)."""
        return 1.0 + 1.0 / self.schmidt_number()


class Analyser:
    """Pulse characterization: FROG trace and spectrogram of a sampled
    field (reference: pyqed/optics.py:182 ``Analyser`` — FROG:190,
    spectrogram:212), on ``device`` (the card when None).

    The SHG-FROG trace I(w, tau) = |int dt E(t) E(t - tau) e^{i w t}|^2 is
    one batched FFT over the gate delays."""

    def __init__(self, E, t, device=None):
        self.device = resolve_device(device)
        self.E = _t(E).to(self.device)
        self.t = np.asarray(t)
        self.dt = float(self.t[1] - self.t[0])

    def frog(self, gate=None):
        """Returns (omega, tau, trace (nw, ntau)) — SHG FROG when
        gate is None (gate = the field itself)."""
        E = self.E
        g = E if gate is None else _t(gate).to(self.device)
        n = E.numel()
        dev = self.device
        shifts = torch.arange(-(n // 2), n // 2, device=dev)
        i = torch.arange(n, device=dev)
        # row s: the gate rolled by s, masked where the roll wrapped around
        gs = g[(i[None, :] - shifts[:, None]) % n]
        mask = torch.where(shifts[:, None] >= 0, i[None, :] >= shifts[:, None],
                           i[None, :] < n + shifts[:, None])
        sig = E[None, :] * gs * mask
        trace = (torch.fft.fftshift(torch.fft.fft(sig, dim=-1), dim=-1).abs()
                 ** 2 * self.dt ** 2).T
        omega = 2 * np.pi * np.fft.fftshift(np.fft.fftfreq(n, self.dt))
        tau = np.arange(-(n // 2), n // 2) * self.dt
        return omega, tau, trace

    FROG = frog

    def spectrogram(self, window_width=None):
        """Gated power spectrum with a Gaussian gate."""
        n = self.E.numel()
        w = window_width or (self.t[-1] - self.t[0]) / 10
        gate = np.exp(-((self.t - self.t[n // 2]) / w) ** 2)
        return self.frog(gate=gate)


def schmidt_decompose(f, dp, dq, nmodes=5, method="svd", device=None):
    """Schmidt decomposition of a joint spectral amplitude,
    f(p, q) = sum_a s_a phi_a(p) chi_a(q) (reference: pyqed/optics.py:922),
    by SVD or (``method='rdm'``) by eigh of the Hermitian kernel, on
    ``device``. Returns (s (nmodes,), phi (np, nmodes), chi (nq, nmodes))
    with continuum normalization int |phi|^2 dp = 1."""
    f, = _on(resolve_device(device), f)
    if method == "svd":
        U, S, Vh = torch.linalg.svd(f, full_matrices=False)
        s = S * (dp * dq) ** 0.5
        phi = U / dp ** 0.5
        # f = U S Vh -> chi_a(q) = Vh[a, q], not its conjugate
        chi = Vh.T / dq ** 0.5
    elif method == "rdm":
        k1 = f @ f.conj().T * dp * dq
        w1, phi = torch.linalg.eigh(k1)
        idx = torch.argsort(w1, descending=True)
        w1, phi = w1[idx], phi[:, idx]
        s = torch.sqrt(torch.clamp(w1, min=0))
        phi = phi / dp ** 0.5
        # partner modes: s_a chi_a(q) = sum_p conj(phi_a(p)) f(p, q) dp
        chi = f.T @ phi.conj() * dp
        chi = chi / torch.clamp(s[None, :], min=1e-300)
    else:
        raise ValueError(method)
    return s[:nmodes], phi[:, :nmodes], chi[:, :nmodes]


def schmidt_number(f, dp, dq, device=None):
    """Entanglement (Schmidt) number K = (sum s^2)^2 / sum s^4, from the
    singular values on ``device``."""
    s, _, _ = schmidt_decompose(f, dp, dq, nmodes=min(f.shape),
                                device=device)
    s2 = s ** 2
    return float(s2.sum() ** 2 / (s2 ** 2).sum())


def hom_schmidt(p, q, f, tau, nmodes=8, device=None):
    """HOM coincidence through the Schmidt modes, on ``device`` (reference:
    pyqed/optics.py:881, whose body never ran; equal to :func:`hom`)."""
    dev = resolve_device(device)
    dp = float(_t(p)[1] - _t(p)[0])
    dq = float(_t(q)[1] - _t(q)[0])
    p, q, tau = _on(dev, p, q, tau)
    s, phi, chi = schmidt_decompose(f, dp, dq, nmodes=nmodes, device=dev)
    eip = torch.exp(1j * p[None, :] * tau[:, None])      # (nt, np)
    phi, chi = phi.to(eip.dtype), chi.to(eip.dtype)
    A = torch.einsum("pa, pb, tp -> tab", phi.conj(), chi, eip) * dp
    eiq = torch.exp(-1j * q[None, :] * tau[:, None])
    B = torch.einsum("qb, qa, tq -> tab", phi, chi.conj(), eiq) * dq
    s = s.to(A.dtype)
    corr = torch.einsum("a, b, tab, tab -> t", s, s, A, B)
    return 0.5 - 0.5 * corr.real

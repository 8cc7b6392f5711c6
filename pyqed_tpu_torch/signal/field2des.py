"""Explicit-field, phase-cycled 2D electronic spectroscopy (PyTorch).

PyTorch counterpart of ``pyqed_tpu/signal/field2des.py``: the three laser
pulses are propagated explicitly through the driven hierarchy of a
:class:`~pyqed_tpu_torch.open.heom.HEOMSolver`, and the rephasing
(−k1+k2+k3) third-order signal is isolated by phase cycling.

Every propagation of the (phase × phase × t1) batch is one member of a
single ``(nado, B, n, n)`` ADO state advanced by one RK4 loop: the
solver's right-hand side takes the batch as it is (``kernel='cuda'``:
one launch of the HEOM coupling kernel per right-hand side for the whole
batch). The fields of every member at every RK4 stage time are tabulated
on the device before the loop, and the detected polarization is written
into a device buffer, so the loop never reads the host.

Phase cycling: with pulse phases (φ1, φ2, 0) the detected polarization is
P = Σ_{a,b} P_{ab} e^{i(a φ1 + b φ2)}; an N1 × N2 cycle extracts the
(a, b) = (−1, +1) component by a discrete Fourier sum.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import complex_dtype_for
from ..core.diagnostics import span
from ..ops.linalg import as_tensor
from ..parallel.mesh import check_mesh


def _three_pulse_field(t, E0, tau, omega, tc1, tc2, tc3, ph1, ph2):
    """Sum of three Gaussian-envelope carrier pulses; the third phase is
    the detection reference (0). Broadcasts over tensors."""
    def one(tc, ph, amp):
        return amp * torch.exp(-((t - tc) ** 2) / (2.0 * tau ** 2)) * \
            torch.cos(omega * (t - tc) + ph)
    return (one(tc1, ph1, E0[0]) + one(tc2, ph2, E0[1])
            + one(tc3, 0.0, E0[2]))


def field_2des_rephasing(solver, rho0, mu, t1s, t2, nt3, dt,
                         pulse_width, e_amps, omega_c, pad=None,
                         n_phase=(4, 4), kernel="einsum", mesh=None):
    """Rephasing (−k1+k2+k3) 2DES signal from explicit three-pulse
    propagation with phase cycling.

    solver : a :class:`HEOMSolver` (any hierarchy solver whose
        ``rhs_fn(dtype, kernel=)`` closure takes a (nado, B, n, n) batch);
        the propagation runs on its device.
    rho0   : initial density matrix (n, n)
    mu     : dipole operator (n, n)
    t1s    : coherence-time delays (multiples of dt)
    t2     : waiting time (a multiple of dt)
    nt3    : number of detection samples (t3 axis, spacing dt)
    pulse_width : Gaussian sigma of each pulse
    e_amps : (E1, E2, E3) field amplitudes (weak for a clean chi3)
    omega_c: carrier frequency
    pad    : time before the first pulse centre (default 4 sigma)
    kernel : the solver's right-hand side (``einsum`` by default, as in
        the JAX package; ``cuda``/``pallas`` runs the coupling kernel).
    mesh   : a :class:`~torch.distributed.device_mesh.DeviceMesh`: the
        (phase × t1) batch is cut over its first axis, each rank
        propagating its members as one batch (with ``cuda``, one kernel
        launch a right-hand side for them), with no collective until the
        polarizations are gathered once for the phase-cycle sum. Every
        rank returns the whole result.

    Returns (P3, t1s, t3s) as tensors on the solver's device: the
    phase-cycled third-order polarization P3[t1_idx, t3_idx] (complex),
    ready for :func:`rephasing_spectrum`, and the two time axes (float64).

    With spans on (:mod:`..core.diagnostics`) the call is span
    ``f2des.map`` (attributes ``B``, ``nt_total``), holding the solver's
    ``heom.build``, the field table ``f2des.fields``, the RK4 loop with
    the polarization rows ``f2des.loop`` (the solver's ``heom.rhs``
    inside) and the phase-cycle sum ``f2des.phase_cycle``.
    """
    mesh = check_mesh(mesh)
    if pad is None:
        pad = 4.0 * pulse_width
    with span("f2des.map") as attrs:
        return _rephasing(attrs, solver, rho0, mu, t1s, t2, nt3, dt,
                          pulse_width, e_amps, omega_c, pad, n_phase, kernel,
                          mesh)


def _rephasing(attrs, solver, rho0, mu, t1s, t2, nt3, dt, pulse_width,
               e_amps, omega_c, pad, n_phase, kernel, mesh):
    """:func:`field_2des_rephasing`'s body; ``attrs`` are its span's."""
    dev = solver.device
    t1s = np.asarray(t1s, dtype=float)
    mu = as_tensor(mu, device=dev)
    rho0 = as_tensor(rho0, device=dev)
    dtype = complex_dtype_for(rho0, mu)
    rhs, nado = solver.rhs_fn(dtype, kernel=kernel)
    n = solver.n
    mu = mu.to(dtype)
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32

    with span("f2des.fields"):
        N1, N2 = n_phase
        ph1 = 2.0 * np.pi * np.arange(N1) / N1
        ph2 = 2.0 * np.pi * np.arange(N2) / N2
        # batch = (N1, N2, nt1) flattened
        P1, P2, T1 = np.meshgrid(ph1, ph2, t1s, indexing="ij")
        bshape = P1.shape
        B = P1.size
        lo, hi = 0, B
        if mesh is not None:
            from ..parallel.mesh import axis_group, gather_rows, local_range
            group, rank, d = axis_group(mesh)
            lo, hi, _ = local_range(B, rank, d)

        t1_max = float(t1s.max())
        tc1 = pad
        # total horizon: pad + t1_max + t2 + pad (after the third pulse) + t3
        t_det0 = tc1 + t1_max + t2 + pad          # detection start (shared)
        nt_total = int(round(t_det0 / dt)) + nt3
        attrs.update(B=B, nt_total=nt_total)
        E0 = torch.as_tensor(np.asarray(e_amps, dtype=float), dtype=rdt,
                             device=dev)

        # The third pulse is anchored so that detection starts at the same
        # time for every t1; pulses 1 and 2 move backwards with t1. Every
        # RK4 stage time is a multiple of dt / 2: row m of the table is the
        # field of every batch member at t = m dt / 2.
        tc3 = tc1 + t1_max + t2
        tc2 = tc3 - t2
        col = lambda a: torch.as_tensor(  # noqa: E731
            a.ravel()[lo:hi], dtype=rdt, device=dev)
        t = (torch.arange(2 * nt_total + 1, dtype=rdt, device=dev)
             * (dt / 2))[:, None]
        fields = _three_pulse_field(t, E0, pulse_width, omega_c,
                                    tc2 - col(T1)[None, :], tc2, tc3,
                                    col(P1)[None, :], col(P2)[None, :])
        # (2nt+1, 1, B, 1, 1)
        drive = (-1j * fields).to(dtype)[:, None, :, None, None]

    def f(y, m):
        out = rhs(y)
        return out.addcmul_(drive[m], mu @ y - y @ mu)

    with span("f2des.loop"):
        y = torch.zeros((nado, hi - lo, n, n), dtype=dtype, device=dev)
        y[0] = rho0.to(dtype)
        mu_t = mu.transpose(0, 1).contiguous()
        pols = torch.empty((nt3, hi - lo), dtype=dtype, device=dev)
        first = nt_total - nt3
        for k in range(nt_total if hi > lo else 0):
            k1 = f(y, 2 * k)
            k2 = f(y + k1 * (dt / 2), 2 * k + 1)
            k3 = f(y + k2 * (dt / 2), 2 * k + 1)
            k4 = f(y + k3 * dt, 2 * k + 2)
            y = y + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
            if k >= first:
                # tr(mu @ rho_b) = sum_ij mu_ij rho_b[j, i]
                pols[k - first] = (y[0] * mu_t).sum(dim=(-2, -1))

    with span("f2des.phase_cycle"):
        if mesh is not None:
            pols = gather_rows(pols, group, d, n=B, dim=1)
        pols = pols.T.reshape(bshape + (nt3,))

        # phase-cycle extraction of the (a, b) = (-1, +1) component:
        # P_{-1,+1} = (1/N1N2) sum e^{+i phi1} e^{-i phi2} P(phi1, phi2)
        w1 = torch.exp(1j * torch.as_tensor(ph1, device=dev)).to(dtype)
        w2 = torch.exp(-1j * torch.as_tensor(ph2, device=dev)).to(dtype)
        P3 = torch.einsum("a, b, abts -> ts", w1, w2, pols) / (N1 * N2)
    t3s = torch.arange(nt3, dtype=torch.float64, device=dev) * dt
    return P3, torch.as_tensor(t1s, device=dev), t3s


def rephasing_spectrum(P3, t1s, t3s, pad_factor=4):
    """Double Fourier transform of the phase-cycled polarization:
    conjugate-FT over t1 (rephasing), FT over t3. Returns tensors
    (omega1, omega3, S) with S[w1_idx, w3_idx], on P3's device."""
    P3 = as_tensor(P3)
    t1s = as_tensor(t1s, dtype=torch.float64)
    t3s = as_tensor(t3s, dtype=torch.float64)
    n1 = pad_factor * len(t1s)
    n3 = pad_factor * len(t3s)
    dt1 = float(t1s[1] - t1s[0]) if len(t1s) > 1 else 1.0
    dt3 = float(t3s[1] - t3s[0]) if len(t3s) > 1 else 1.0
    S = torch.fft.fft(torch.conj(torch.fft.fft(P3, n=n1, dim=0)),
                      n=n3, dim=1)
    S = torch.fft.fftshift(S, dim=(0, 1))
    freq = lambda m, d: 2 * math.pi * torch.fft.fftshift(
        torch.fft.fftfreq(m, d, dtype=torch.float64, device=P3.device))
    return freq(n1, dt1), freq(n3, dt3), S

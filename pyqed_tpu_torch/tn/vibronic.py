"""Vibronic-model MPS dynamics: the LVC Hamiltonian as a compact MPO,
propagated with two-site TDVP (PyTorch).

Counterpart of ``pyqed_tpu/tn/vibronic.py`` (reference:
pyqed/mps/vibronic.py:25 ``MatrixState``/:428 ``MatrixProductState``,
pyqed/mps/lvc.py). The Hamiltonian is encoded exactly as an MPO of bond
dimension nmodes+2 and propagated with ``tn/tdvp``.

Chain layout: site 0 = electronic system (d = nstates), sites 1..M =
harmonic modes (d = nb levels each):

    H = H_el(0) + Σ_m ω_m n_m + Σ_m V_m(0) ⊗ x_m,   x_m = (a + a†)/√2,

V_m any Hermitian electronic matrix (diagonal κ = tuning modes,
off-diagonal λ = coupling modes).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import resolve_device
from .mps import MPS, MPO, two_site_dmrg
from .tdvp import TDVP2


def boson_ops(nb):
    a = np.diag(np.sqrt(np.arange(1, nb)), 1)
    return a, a.T, np.diag(np.arange(nb))


def lvc_mpo(H_el, omegas: Sequence, couplings: Sequence, nb: int,
            device=None) -> MPO:
    """MPO of the LVC Hamiltonian (NumPy W tensors, as JAX builds them,
    on ``device``).

    H_el : (ns, ns) electronic Hamiltonian.
    omegas : (M,) mode frequencies.
    couplings : list of (ns, ns) Hermitian electronic matrices V_m
        multiplying x_m (diagonal entries = κ, off-diagonal = λ).
    nb : boson levels per mode.
    """
    dev = resolve_device(device)
    H_el = np.asarray(H_el)
    ns = H_el.shape[0]
    M = len(omegas)
    a, ad, num = boson_ops(nb)
    x = (a + ad) / np.sqrt(2.0)
    D = M + 2

    # site 0 (electronic): channels [idle, mode couplings..., done]
    W0 = np.zeros((D, D, ns, ns))
    W0[0, 0] = np.eye(ns)
    for m in range(M):
        W0[0, 1 + m] = np.asarray(couplings[m])
    W0[0, D - 1] = H_el
    W0[D - 1, D - 1] = np.eye(ns)

    Ws = [W0]
    for k in range(M):
        W = np.zeros((D, D, nb, nb))
        W[0, 0] = np.eye(nb)
        W[D - 1, D - 1] = np.eye(nb)
        W[0, D - 1] = omegas[k] * num        # mode energy
        W[1 + k, D - 1] = x                  # terminate coupling channel k
        for m in range(M):
            if m != k:
                W[1 + m, 1 + m] = np.eye(nb)  # pass the other channels
        Ws.append(W)
    return MPO([torch.as_tensor(W, device=dev) for W in Ws])


class VibronicMPS:
    """Driver: build the LVC MPO, prepare |el⟩⊗|0...0⟩, propagate with
    TDVP2 and record the electronic populations (reference:
    pyqed/mps/vibronic.py:428 run loop), on ``device`` (the card when
    None, raises without one)."""

    def __init__(self, H_el, omegas, couplings, nb=8, chi_max=32,
                 device=None):
        self.device = resolve_device(device)
        self.ns = np.asarray(H_el).shape[0]
        self.M = len(omegas)
        self.nb = nb
        self.chi_max = chi_max
        self.mpo = lvc_mpo(H_el, omegas, couplings, nb, device=self.device)

    def initial_state(self, el_state: int):
        """|el_state⟩ ⊗ |0...0⟩ as a product MPS."""
        el = np.zeros(self.ns)
        el[el_state] = 1.0
        ground = [1.0] + [0.0] * (self.nb - 1)
        return MPS.from_product_state([el] + [ground] * self.M,
                                      device=self.device)

    def run(self, el_state, dt, nt, nout=1, chi_pad=8, noise=1e-8):
        """Returns (times, populations (nt // nout + 1, ns)), float64
        tensors on the device."""
        psi = self.initial_state(el_state)
        if chi_pad and chi_pad > 1:
            psi = psi.pad_noise(chi_pad, noise=noise)
        td = TDVP2(self.mpo, psi, chi_max=self.chi_max)
        pops = [self._populations(td)]
        for _ in range(nt // nout):
            for _ in range(nout):
                td.step(dt)
            pops.append(self._populations(td))
        self.td = td
        times = dt * nout * torch.arange(nt // nout + 1, dtype=torch.float64,
                                         device=self.device)
        return times, torch.stack(pops)

    @staticmethod
    def _populations(td):
        """P_s = Σ_ab |θ_0[a, s, b]|² at the canonical centre, site 0
        (JAX evaluates <|s><s|> one state at a time, with one
        canonicalisation each; the numbers agree to rounding)."""
        th = td.to_mps().get_theta1(0)
        return (th.abs() ** 2).sum(dim=(0, 2))

    def ground_state(self, sweeps=8, chi_pad=8):
        # noise-pad: a pure product seed can trap the two-site sweeps
        mps = self.initial_state(0).pad_noise(chi_pad, noise=1e-3)
        energies, gs = two_site_dmrg(self.mpo, mps, chi_max=self.chi_max,
                                     sweeps=sweeps)
        return energies[-1], gs

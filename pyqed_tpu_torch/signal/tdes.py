"""Time-domain third-order response functions and 2DES spectra (PyTorch).

Counterpart of ``pyqed_tpu/signal/tdes.py`` (reference:
pyqed/signal/2DES.py — ``ESA:102``, ``GSB:156``, ``SE:202``,
``response2_freq:71``; Liouville-space Green's function ``G:36``).

Every pathway is evaluated on the full (t1, t2, t3) grid from
single-coherence propagators. Where the JAX package writes one
seven-operand einsum, the port contracts pairwise: the state sums that
do not touch t1 first, into a small (state, t2, t3) tensor Y, then one
product R[i, j, k] = sum_b U_ab[b, i] Y[b, j, k] over the last state
index. ``twodes`` adds the three pathways' Y before that product, so the
(t1, t2, t3) cube is written once. A 2D FFT along (t1, t3)
(``torch.fft``) gives the (w1, w3) correlation spectra.

Functions take ``device``: the card (``cuda``) when None, which raises
without one; ``device="cpu"`` runs on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .sos import _cast, _idx, _real


def _U(E, gamma, a_idx, b_idx, t, device=None):
    """Stack of coherence propagators U_{ab}(t) = -i e^{-i w_ab t - g_ab t}
    for all a in a_idx, b in b_idx over the time grid t: (A, B, T)
    (reference: pyqed/signal/2DES.py:36 ``G``)."""
    dev = resolve_device(device)
    E, gamma, t = _real(E, dev), _real(gamma, dev), _real(t, dev)
    a, b = _idx(a_idx, dev), _idx(b_idx, dev)
    wab = E[a][:, None] - E[b][None, :]
    gab = (gamma[a][:, None] + gamma[b][None, :]) / 2.0
    return -1j * torch.exp(-(1j * wab[..., None] + gab[..., None])
                           * t[None, None, :])


def _finish(U_ab, Y):
    """R[i, j, k] = sum_b U_ab[b, i] Y[b, j, k]: (T1, T2, T3)."""
    B, T2, T3 = Y.shape
    return (U_ab.T @ Y.reshape(B, T2 * T3)).reshape(-1, T2, T3)


def _esa_y(dip, E, gamma, e_idx, f_idx, t2, t3, dev, a=0):
    """ESA's Y (B, T2, T3), sign and mu_b0 included:
    -mu_b0 sum_{c,d} mu_c0 mu_dc mu_bd U_cb(t2) U_db(t3)."""
    e, f = _idx(e_idx, dev), _idx(f_idx, dev)
    U_cb = _U(E, gamma, e_idx, e_idx, t2, dev)       # (C, B, T2)
    U_db = _U(E, gamma, f_idx, e_idx, t3, dev)       # (D, B, T3)
    d1, d2, d3, d4 = _cast(U_cb.dtype, dip[e, a], dip[e, a], dip[f][:, e],
                           dip[e][:, f])
    X = torch.einsum("dc, cbj -> bjd", d3 * d2[None, :], U_cb)   # (B, T2, D)
    coef = -(d1[:, None] * d4)[:, None, :] * X
    return coef @ U_db.transpose(0, 1)                # (B, T2, T3)


def _gsb_y(dip, E, gamma, g_idx, e_idx, t2, t3, dev, a=0):
    """GSB's Y (B, T2, T3):
    mu_0b sum_{c,d} mu_bc mu_cd mu_d0 U_ac(t2) U_dc(t3)."""
    e, g = _idx(e_idx, dev), _idx(g_idx, dev)
    U_ac = _U(E, gamma, [a], g_idx, t2, dev)[0]      # (C, T2)
    U_dc = _U(E, gamma, e_idx, g_idx, t3, dev)       # (D, C, T3)
    d1, d2, d3, d4 = _cast(U_ac.dtype, dip[a, e], dip[e][:, g], dip[g][:, e],
                           dip[e, a])
    Z = torch.einsum("cd, dck -> ck", d3 * d4[None, :], U_dc)    # (C, T3)
    W = (d1[:, None] * d2)[:, :, None] * U_ac[None]               # (B, C, T2)
    return W.transpose(1, 2) @ Z                      # (B, T2, T3)


def _se_y(dip, E, gamma, g_idx, e_idx, t2, t3, dev, a=0):
    """SE's Y (B, T2, T3):
    mu_0b sum_{c,d} mu_c0 mu_dc mu_bd U_cb(t2) U_cd(t3)."""
    e, g = _idx(e_idx, dev), _idx(g_idx, dev)
    U_cb = _U(E, gamma, e_idx, e_idx, t2, dev)       # (C, B, T2)
    U_cd = _U(E, gamma, e_idx, g_idx, t3, dev)       # (C, D, T3)
    d1, d2, d3, d4 = _cast(U_cb.dtype, dip[a, e], dip[e, a], dip[g][:, e],
                           dip[e][:, g])
    P = (d1[:, None, None] * d2[None, :, None] * d3.T[None, :, :]
         * d4[:, None, :])                            # (B, C, D)
    Q = torch.einsum("bcd, cdk -> bck", P, U_cd)      # (B, C, T3)
    return U_cb.permute(1, 2, 0) @ Q                  # (B, T2, T3)


def _operands(evals, dip, gamma, dev):
    return _real(evals, dev), _real(dip, dev), _real(gamma, dev)


def ESA(evals, dip, g_idx, e_idx, f_idx, gamma, t1, t2, t3, device=None):
    """ESA pathway on the (t1, t2, t3) cube
    (reference: pyqed/signal/2DES.py:102). Returns (T1, T2, T3)."""
    dev = resolve_device(device)
    E, dip, gamma = _operands(evals, dip, gamma, dev)
    U_ab = _U(E, gamma, [0], e_idx, t1, dev)[0]      # (B, T1)
    return _finish(U_ab, _esa_y(dip, E, gamma, e_idx, f_idx, t2, t3, dev))


def GSB(evals, dip, g_idx, e_idx, gamma, t1, t2, t3, device=None):
    """GSB pathway (reference: pyqed/signal/2DES.py:156)."""
    dev = resolve_device(device)
    E, dip, gamma = _operands(evals, dip, gamma, dev)
    U_ab = _U(E, gamma, [0], e_idx, t1, dev)[0]
    return _finish(U_ab, _gsb_y(dip, E, gamma, g_idx, e_idx, t2, t3, dev))


def SE(evals, dip, g_idx, e_idx, gamma, t1, t2, t3, device=None):
    """SE pathway (reference: pyqed/signal/2DES.py:202)."""
    dev = resolve_device(device)
    E, dip, gamma = _operands(evals, dip, gamma, dev)
    U_ab = _U(E, gamma, [0], e_idx, t1, dev)[0]
    return _finish(U_ab, _se_y(dip, E, gamma, g_idx, e_idx, t2, t3, dev))


def twodes(mol, t1, t2, t3, g_idx=(0,), e_idx=None, f_idx=None, device=None):
    """Total rephasing signal R(t1, t2, t3) = GSB + SE + ESA and its 2D FFT
    S(w1, t2, w3). Returns (R, S, w1, w3)."""
    dev = resolve_device(device)
    E, dip, gamma = _operands(mol.eigvals(), mol.edip_rms, mol.gamma, dev)
    N = mol.nstates
    if e_idx is None:
        e_idx = list(range(1, N))
    if f_idx is None:
        f_idx = list(range(1, N))
    g_idx = list(g_idx)
    U_ab = _U(E, gamma, [0], e_idx, t1, dev)[0]
    Y = (_gsb_y(dip, E, gamma, g_idx, e_idx, t2, t3, dev)
         + _se_y(dip, E, gamma, g_idx, e_idx, t2, t3, dev)
         + _esa_y(dip, E, gamma, e_idx, f_idx, t2, t3, dev))
    R = _finish(U_ab, Y)
    S, w1, w3 = response_to_spectrum(R, t1, t3)
    return R, S, w1, w3


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def response_to_spectrum(R, t1, t3, rephasing=True):
    """FFT the (t1, ..., t3) response to (w1, ..., w3), on R's device.

    Rephasing signals oscillate as e^{+i w_ab t1} with w_ab < 0; the
    conventional plot uses S(-w1, w3), handled by conjugating the t1
    transform direction. Returns (F, w1, w3), the frequency grids as
    float64 tensors.
    """
    t1, t3 = _host(t1), _host(t3)
    dt1 = t1[1] - t1[0]
    dt3 = t3[1] - t3[0]
    n1, n3 = len(t1), len(t3)
    # FT: S(w1, w3) = int dt1 dt3 e^{-s sign i w1 t1} e^{i w3 t3} R
    ax1 = 0
    ax3 = R.ndim - 1
    F = torch.fft.ifft(R, dim=ax3) * n3 * dt3        # e^{+i w3 t3}
    if rephasing:
        F = torch.fft.ifft(F, dim=ax1) * n1 * dt1    # e^{+i w1 t1}
    else:
        F = torch.fft.fft(F, dim=ax1) * dt1
    F = torch.fft.fftshift(F, dim=(ax1, ax3))
    w1 = 2 * np.pi * np.fft.fftshift(np.fft.fftfreq(n1, dt1))
    w3 = 2 * np.pi * np.fft.fftshift(np.fft.fftfreq(n3, dt3))
    return (F, torch.as_tensor(w1, device=R.device),
            torch.as_tensor(w3, device=R.device))

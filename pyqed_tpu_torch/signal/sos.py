"""Sum-over-states nonlinear spectroscopy signals (PyTorch).

Counterpart of ``pyqed_tpu/signal/sos.py`` (reference: pyqed/signal/sos.py
— ``absorption:192``, ``linear_absorption:283``, ``TPA:349``,
``TPA2D:380``, ``TPA2D_time_order:408``, ``ESA:498``, ``_ESA:557``,
``GSB:624``, ``SE:731``, ``_SE:789``, ``_photon_echo:845``,
``photon_echo_t3:882``, ``photon_echo:962``, ``DQC_R1:1054``,
``DQC_R2:1147``, ``etpa:1289``, ``_etpa:1321``, ``cars:1392``,
``mcd:1434``, ``polarizability:1491``).

Where the JAX package writes each pathway as one many-operand einsum, the
port contracts pairwise: first the small coefficient tensors over the
state indices (at most (t2, state, state)), then one (batched) matrix
product into the (omega1, omega3) map. ``torch.einsum`` without
``opt_einsum`` contracts left to right and could otherwise build a
(t2, state, state, state, omega1, omega3) intermediate. The photon-echo
pathways are batched over t2 delays; the whole GSB + SE + ESA cube is one
batched product.

torch's ``matmul`` and ``einsum`` refuse real-by-complex operands, so real
dipoles are cast to the complex dtype of the Green's functions before
every product. Float64 inputs give complex128 results.

Orientation convention: returned 2D maps are indexed S[i, j] =
S(omega1[i], omega3[j]) (axis 0 = first frequency argument), as in the
JAX package.

Every function takes ``device``: where the computation runs, the card
(``cuda``) when None, which raises without one; pass ``device="cpu"`` to
run on the CPU. Inputs may be tensors on any device or array-likes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import complex_dtype_for, resolve_device
from ..parallel.mesh import check_mesh
from ..ops.math import heaviside, lorentzian
from ..units import au2angstrom, au2mev, au2ev


def _real(x, dev):
    """``x`` as a tensor on ``dev``: a float64 one for NumPy float64 or
    Python floats, keeping the dtype of a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def _idx(idx, dev):
    return torch.as_tensor(np.asarray(list(idx), dtype=np.int64), device=dev)


def _G_w(omega, dE, g2):
    """Frequency Green's function 1/(w - dE + i g2) broadcast over a grid:
    (states, W)."""
    return 1.0 / (omega[None, :] - dE[:, None] + 1j * g2[:, None])


def _cast(cdt, *ts):
    return [t.to(cdt) for t in ts]


def _gamma_vector(mol, linewidth, dev):
    if linewidth is not None:
        return _real([linewidth] * mol.nstates, dev)
    if mol.gamma is None:
        return _real([20 / au2mev] * mol.nstates, dev)
    return _real(mol.gamma, dev)


# -------------------------------------------------------------- absorption

def absorption(mol, omegas, linewidth=None, normalize=False, device=None,
               **kwargs):
    """Linear absorption: S(w) = sum_j |mu_j0|^2 L(w - w_j0)
    (reference: pyqed/signal/sos.py:192). Plot-free; returns the signal."""
    dev = resolve_device(device)
    omegas = _real(omegas, dev)
    edip = _real(mol.edip_rms, dev)
    gamma = _gamma_vector(mol, linewidth, dev)
    E = _real(mol.eigvals(), dev)
    E = E - E[0]
    shifts = omegas[None, :] - E[1:, None]
    lor = 1.0 / np.pi * gamma[1:, None] / (gamma[1:, None] ** 2 + shifts**2)
    signal = (edip[1:, 0].abs() ** 2) @ lor
    if normalize:
        signal = signal / signal.max()
    return signal


def linear_absorption(omegas, transition_energies, dip, gamma=1.0 / au2ev,
                      normalize=False, device=None, **kwargs):
    """(reference: pyqed/signal/sos.py:283)."""
    dev = resolve_device(device)
    omegas = _real(omegas, dev)
    E = _real(transition_energies, dev)
    d = _real(dip, dev)
    sig = (d**2) @ lorentzian(omegas[None, :] - E[:, None], gamma)
    if normalize:
        sig = sig / sig.max()
    return sig


# --------------------------------------------------------------------- TPA

def TPA(E, dip, omegap, g_idx=None, e_idx=None, f_idx=None, gamma=None,
        degenerate=True, device=None):
    """Two-photon absorption with classical light
    (reference: pyqed/signal/sos.py:349). omegap may be an array."""
    dev = resolve_device(device)
    E, dip, gamma = _real(E, dev), _real(dip, dev), _real(gamma, dev)
    omegap = torch.atleast_1d(_real(omegap, dev))
    e, f = _idx(e_idx, dev), _idx(f_idx, dev)
    i = 0
    omega1 = omegap * 0.5
    omega2 = omegap - omega1
    # amplitudes: (P, F) = sum_m dip[f,m] dip[m,i] (1/(w1 - E_mi + ig_m) + ...)
    Em = E[e] - E[i]
    dme = dip[f][:, e] * dip[e, i][None, :]                  # (F, M)
    den1 = omega1[:, None] - Em[None, :] + 1j * gamma[e][None, :]
    den2 = omega2[:, None] - Em[None, :] + 1j * gamma[e][None, :]
    resp = 1.0 / den1 + 1.0 / den2                            # (P, M)
    amp = resp @ dme.T.to(resp.dtype)                         # (P, F)
    lor = lorentzian(omegap[:, None] - (E[f] - E[i])[None, :],
                     gamma[f][None, :])
    return (amp.abs() ** 2 * lor).sum(-1)


def TPA2D(E, dip, omegaps, omega1s, g_idx=None, e_idx=None, f_idx=None,
          gamma=None, time_order=False, device=None):
    """2D TPA scanning (omegap, omega1)
    (reference: pyqed/signal/sos.py:380,408)."""
    dev = resolve_device(device)
    E, dip, gamma = _real(E, dev), _real(dip, dev), _real(gamma, dev)
    omegaps, omega1s = _real(omegaps, dev), _real(omega1s, dev)
    e, f = _idx(e_idx, dev), _idx(f_idx, dev)
    g = 0
    Em = E[e] - E[g]
    dme = dip[f][:, e] * dip[e, g][None, :]                   # (F, M)
    W1 = omega1s[None, :, None]
    WP = omegaps[:, None, None]
    den1 = W1 - Em[None, None, :] + 1j * gamma[e][None, None, :]
    if time_order:
        resp = 1.0 / den1
    else:
        den2 = (WP - W1) - Em[None, None, :] + 1j * gamma[e][None, None, :]
        resp = 1.0 / den1 + 1.0 / den2                        # (P, Q, M)
    amp = resp @ dme.T.to(resp.dtype)                         # (P, Q, F)
    lor = lorentzian(omegaps[:, None] - (E[f] - E[g])[None, :],
                     gamma[f][None, :])                       # (P, F)
    return (amp.abs() ** 2 * lor[:, None, :]).sum(-1)


def TPA2D_time_order(E, dip, omegaps, omega1s, g_idx=None, e_idx=None,
                     f_idx=None, gamma=None, device=None):
    return TPA2D(E, dip, omegaps, omega1s, g_idx, e_idx, f_idx, gamma,
                 time_order=True, device=device)


# --------------------------------------------------- photon echo pathways
#
# Every pathway is  S[t, i, j] = sum_b G_ab[b, i] rows[t, b, j]  with the
# pump-side Green's function G_ab (B, W1) and per-pathway rows (T, B, W3)
# built from small (t2, state, state) coefficients; GSB is rank one.

def _pe_operands(evals, dip, gamma, omega1, omega3, t2s, g_idx, e_idx,
                 f_idx, dev):
    E, dip, gamma = _real(evals, dev), _real(dip, dev), _real(gamma, dev)
    w1, w3 = _real(omega1, dev), _real(omega3, dev)
    t2s = torch.atleast_1d(_real(t2s, dev))
    e = _idx(e_idx, dev)
    g = _idx(g_idx, dev)
    f = _idx(f_idx, dev) if f_idx is not None else None
    return E, dip, gamma, w1, w3, t2s, g, e, f


def _G_ab(E, gamma, w1, e, a=0):
    return _G_w(w1, E[a] - E[e], (gamma[a] + gamma[e]) / 2.0)   # (B, W1)


def _U_t2(E, gamma, e, t2s):
    """Population-time propagators -i e^{-(i w_cb + g_cb) t2}: (T, C, B)."""
    dE_cb = E[e][:, None] - E[e][None, :]
    g_cb = (gamma[e][:, None] + gamma[e][None, :]) / 2.0
    return -1j * torch.exp(-(1j * dE_cb + g_cb)[None] * t2s[:, None, None])


def _esa_rows(E, dip, gamma, w3, t2s, e, f, a=0):
    """ESA rows (T, B, W3), sign included:
    -sum_{c,d} mu_b0 mu_c0 mu_dc mu_bd U_cb(t2) G_db(w3)."""
    U = _U_t2(E, gamma, e, t2s)                                 # (T, C, B)
    dE_db = E[f][:, None] - E[e][None, :]
    g_db = (gamma[f][:, None] + gamma[e][None, :]) / 2.0
    G_db = 1.0 / (w3[None, None, :] - dE_db[..., None]
                  + 1j * g_db[..., None])                       # (D, B, W3)
    d1, d2, d3, d4 = _cast(U.dtype, dip[e, a], dip[e, a], dip[f][:, e],
                           dip[e][:, f])
    s = torch.einsum("dc, tcb -> tbd", d3 * d2[None, :], U)     # (T, B, D)
    coef = -(d1[:, None] * d4)[None] * s
    return torch.einsum("tbd, dbj -> tbj", coef, G_db)


def _se_rows(E, dip, gamma, w3, t2s, g, e, a=0):
    """SE rows (T, B, W3):
    sum_{c,d} mu_0b mu_c0 mu_dc mu_bd U_cb(t2) G_cd(w3)."""
    U = _U_t2(E, gamma, e, t2s)                                 # (T, C, B)
    dE_cd = E[e][:, None] - E[g][None, :]
    g_cd = (gamma[e][:, None] + gamma[g][None, :]) / 2.0
    G_cd = 1.0 / (w3[None, None, :] - dE_cd[..., None]
                  + 1j * g_cd[..., None])                       # (C, D, W3)
    d1, d2, d3, d4 = _cast(U.dtype, dip[a, e], dip[e, a], dip[g][:, e],
                           dip[e][:, g])
    P = (d1[:, None, None] * d2[None, :, None] * d3.T[None, :, :]
         * d4[:, None, :])                                      # (B, C, D)
    coef = P[None] * U.transpose(1, 2)[..., None]               # (T, B, C, D)
    T, B, C, D = coef.shape
    return coef.reshape(T, B, C * D) @ G_cd.reshape(C * D, -1)


def _gsb_factors(E, dip, gamma, w1, w3, e, a=0, c=0):
    """The rank-one GSB map u(w1) v(w3)^T."""
    G_ab = _G_w(w1, E[a] - E[e], (gamma[a] + gamma[e]) / 2.0)
    G_dc = _G_w(w3, E[e] - E[c], (gamma[e] + gamma[c]) / 2.0)
    d1, d2, d3, d4 = _cast(G_ab.dtype, dip[a, e], dip[e, c], dip[c, e],
                           dip[e, a])
    return (d1 * d2) @ G_ab, (d3 * d4) @ G_dc


def ESA(evals, dip, omega1, omega3, tau2, g_idx=(0,), e_idx=None, f_idx=None,
        gamma=None, device=None):
    """Excited-state absorption pathway of the photon echo
    (reference: pyqed/signal/sos.py:498):

      S(w1, w3) = - sum_{b,c in e; d in f} mu_b0 mu_c0 mu_dc mu_bd
                  G_db(w3) U_cb(t2) G_0b(w1)
    """
    dev = resolve_device(device)
    E, dip, gamma, w1, w3, t2s, g, e, f = _pe_operands(
        evals, dip, gamma, omega1, omega3, tau2, g_idx, e_idx, f_idx, dev)
    return (_G_ab(E, gamma, w1, e).T
            @ _esa_rows(E, dip, gamma, w3, t2s, e, f))[0]


def GSB(evals, dip, omega1, omega3, tau2, g_idx=(0,), e_idx=None, gamma=None,
        device=None):
    """Ground-state bleach pathway (reference: pyqed/signal/sos.py:624)."""
    dev = resolve_device(device)
    E, dip, gamma, w1, w3, _, _, e, _ = _pe_operands(
        evals, dip, gamma, omega1, omega3, tau2, g_idx, e_idx, None, dev)
    u, v = _gsb_factors(E, dip, gamma, w1, w3, e)
    return u[:, None] * v[None, :]


def SE(evals, dip, omega1, omega3, tau2, g_idx=(0,), e_idx=None, gamma=None,
       device=None):
    """Stimulated emission pathway (reference: pyqed/signal/sos.py:731)."""
    dev = resolve_device(device)
    E, dip, gamma, w1, w3, t2s, g, e, _ = _pe_operands(
        evals, dip, gamma, omega1, omega3, tau2, g_idx, e_idx, None, dev)
    return (_G_ab(E, gamma, w1, e).T
            @ _se_rows(E, dip, gamma, w3, t2s, g, e))[0]


def _photon_echo_cube(evals, edip, omega1, omega3, t2s, g_idx, e_idx, f_idx,
                      gamma, dev):
    """GSB + SE + ESA over a t2 series, (T, W1, W3): one batched product
    of [G_ab^T, u] (W1, B+1) with [rows_SE + rows_ESA; v] (T, B+1, W3)."""
    E, dip, gamma, w1, w3, t2s, g, e, f = _pe_operands(
        evals, edip, gamma, omega1, omega3, t2s, g_idx, e_idx, f_idx, dev)
    G_ab = _G_ab(E, gamma, w1, e)
    u, v = _gsb_factors(E, dip, gamma, w1, w3, e)
    rows = (_se_rows(E, dip, gamma, w3, t2s, g, e)
            + _esa_rows(E, dip, gamma, w3, t2s, e, f))        # (T, B, W3)
    T = rows.shape[0]
    left = torch.cat([G_ab.T, u[:, None]], dim=1)             # (W1, B+1)
    right = torch.cat([rows, v[None, None, :].expand(T, 1, -1)], dim=1)
    return left @ right


def _photon_echo(evals, edip, omega1, omega3, t2, g_idx, e_idx, f_idx, gamma,
                 device=None):
    """GSB + SE + ESA at one t2 (reference: pyqed/signal/sos.py:845)."""
    dev = resolve_device(device)
    return _photon_echo_cube(evals, edip, omega1, omega3, t2, g_idx, e_idx,
                             f_idx, gamma, dev)[0]


def _mol_operands(mol):
    if mol.gamma is None:
        raise ValueError("Please set the decay constants gamma first.")
    return mol.eigvals(), mol.edip_rms, mol.gamma


def photon_echo(mol, pump, probe, t2=0.0, g_idx=(0,), e_idx=None, f_idx=None,
                device=None, **kwargs):
    """Photon-echo 2D map S(-Omega1, Omega3) at population time t2
    (reference: pyqed/signal/sos.py:962)."""
    dev = resolve_device(device)
    E, dip, gamma = _mol_operands(mol)
    N = mol.nstates
    if e_idx is None:
        e_idx = list(range(N))
    if f_idx is None:
        f_idx = list(range(N))
    return _photon_echo_cube(E, dip, -_real(pump, dev), _real(probe, dev),
                             t2, list(g_idx), list(e_idx), list(f_idx),
                             gamma, dev)[0]


def photon_echo_t2series(mol, pump, probe, t2list, g_idx=(0,), e_idx=None,
                         f_idx=None, mesh=None, device=None):
    """Photon-echo maps over population times t2, shape (len(t2list),
    len(pump), len(probe)): the pathway sum batched over t2 (the
    reference recomputes per delay in Python), one batched product for
    the whole cube. With ``mesh`` (a DeviceMesh) the pump axis (ω1) is
    cut over its first axis: each rank computes its rows of the cube and
    one all-gather joins them, so every rank returns the whole cube."""
    mesh = check_mesh(mesh)
    dev = resolve_device(device)
    E, dip, gamma = _mol_operands(mol)
    N = mol.nstates
    if e_idx is None:
        e_idx = list(range(N))
    if f_idx is None:
        f_idx = list(range(N))
    w1 = -_real(pump, dev)
    if mesh is None:
        return _photon_echo_cube(E, dip, w1, _real(probe, dev), t2list,
                                 list(g_idx), list(e_idx), list(f_idx),
                                 gamma, dev)
    from ..parallel.mesh import axis_group, gather_rows, local_range
    group, rank, d = axis_group(mesh)
    lo, hi, _ = local_range(w1.shape[0], rank, d)
    S = _photon_echo_cube(E, dip, w1[lo:hi], _real(probe, dev), t2list,
                          list(g_idx), list(e_idx), list(f_idx), gamma, dev)
    return gather_rows(S, group, d, n=w1.shape[0], dim=1)


def _ESA_t3(evals, dip, omega1, omega2, t3, g_idx, e_idx, f_idx, gamma,
            dephasing=10 / au2mev, device=None):
    """(w1, w2) ESA variant at detection time t3
    (reference: pyqed/signal/sos.py:557)."""
    dev = resolve_device(device)
    E, dip, gamma = _real(evals, dev), _real(dip, dev), _real(gamma, dev)
    e, f = _idx(e_idx, dev), _idx(f_idx, dev)
    w1, w2 = _real(omega1, dev), _real(omega2, dev)
    a = 0
    # pure dephasing added to every coherence (the reference fills gammaD
    # off-diagonal with `dephasing`)
    gD = dephasing
    nb = len(e_idx)
    eye = torch.eye(nb, dtype=E.dtype, device=dev)
    G_ab = 1.0 / (w1[None, :] - (E[a] - E[e])[:, None]
                  + 1j * ((gamma[a] + gamma[e]) / 2.0 + gD)[:, None])
    U_cb = 1.0 / (w2[None, None, :]
                  - (E[e][:, None] - E[e][None, :])[..., None]
                  + 1j * (((gamma[e][:, None] + gamma[e][None, :]) / 2.0
                           + gD * (1 - eye))[..., None]))      # (C, B, W2)
    G_db = -1j * torch.exp(
        -1j * (E[f][:, None] - E[e][None, :]) * t3
        - ((gamma[f][:, None] + gamma[e][None, :]) / 2.0 + gD) * t3)
    d1, d2, d3, d4 = _cast(G_ab.dtype, dip[e, a], dip[e, a], dip[f][:, e],
                           dip[e][:, f])
    coef = d1[:, None] * ((d4 * G_db.T) @ d3) * d2[None, :]    # (B, C)
    rows = torch.einsum("bc, cbj -> bj", coef, U_cb)
    return -(G_ab.T @ rows)


def _SE_t3(evals, dip, omega1, omega2, t3, g_idx, e_idx, gamma,
           dephasing=10 / au2mev, device=None):
    """(w1, w2) SE variant at detection time t3
    (reference: pyqed/signal/sos.py:789)."""
    dev = resolve_device(device)
    E, dip, gamma = _real(evals, dev), _real(dip, dev), _real(gamma, dev)
    e, g = _idx(e_idx, dev), _idx(g_idx, dev)
    w1, w2 = _real(omega1, dev), _real(omega2, dev)
    a = 0
    gD = dephasing
    nb = len(e_idx)
    eye = torch.eye(nb, dtype=E.dtype, device=dev)
    G_ab = 1.0 / (w1[None, :] - (E[a] - E[e])[:, None]
                  + 1j * ((gamma[a] + gamma[e]) / 2.0 + gD)[:, None])
    U_cb = 1.0 / (w2[None, None, :]
                  - (E[e][:, None] - E[e][None, :])[..., None]
                  + 1j * (((gamma[e][:, None] + gamma[e][None, :]) / 2.0
                           + gD * (1 - eye))[..., None]))      # (C, B, W2)
    G_cd = -1j * torch.exp(
        -1j * (E[e][:, None] - E[g][None, :]) * t3
        - ((gamma[e][:, None] + gamma[g][None, :]) / 2.0 + gD) * t3)
    d1, d2, d3, d4 = _cast(G_ab.dtype, dip[a, e], dip[e, a], dip[g][:, e],
                           dip[e][:, g])
    coef = d1[:, None] * (d4 @ (d3.T * G_cd).T) * d2[None, :]  # (B, C)
    rows = torch.einsum("bc, cbj -> bj", coef, U_cb)
    return G_ab.T @ rows


def photon_echo_t3(mol, omega1, omega2, t3, g_idx=(0,), e_idx=None,
                   f_idx=None, separate=False, device=None, **kwargs):
    """2D photon echo scanning (omega1, omega2) at detection time t3
    (reference: pyqed/signal/sos.py:882)."""
    dev = resolve_device(device)
    E, edip, gamma = _mol_operands(mol)
    dephasing = mol.dephasing
    N = mol.nstates
    if e_idx is None:
        e_idx = list(range(1, N))
    if f_idx is None:
        f_idx = list(range(1, N))
    w1, w2 = -_real(omega1, dev), _real(omega2, dev)
    se = _SE_t3(E, edip, w1, w2, t3, list(g_idx), list(e_idx), gamma,
                dephasing=dephasing, device=dev)
    esa = _ESA_t3(E, edip, w1, w2, t3, list(g_idx), list(e_idx), list(f_idx),
                  gamma, dephasing=dephasing, device=dev)
    if separate:
        return se, esa
    return se + esa


# --------------------------------------------------------------------- DQC

def _dqc_operands(evals, dip, gamma, e_idx, f_idx, dev):
    E, dip, gamma = _real(evals, dev), _real(dip, dev), _real(gamma, dev)
    return E, dip, gamma, _idx(e_idx, dev), _idx(f_idx, dev)


def DQC_R1(evals, dip, omega1=None, omega2=None, omega3=None, tau1=None,
           tau3=None, g_idx=(0,), e_idx=None, f_idx=None, gamma=None,
           device=None):
    """Double-quantum-coherence diagram 1 (reference: pyqed/signal/sos.py:1054).

    Either (omega1, omega2, tau3) or (omega2, omega3, tau1) mode.
    """
    dev = resolve_device(device)
    E, dip, gamma, e, f = _dqc_operands(evals, dip, gamma, e_idx, f_idx, dev)
    a = 0
    if omega3 is None and tau3 is not None:
        w1, w2 = _real(omega1, dev), _real(omega2, dev)
        # NOTE (reference quirk): in this branch the reference iterates
        # omega1 but uses only `probe`=omega2 in both G factors; the JAX
        # package keeps the physical reading — G_ba over omega1, G_ca over
        # omega2 — and so does the port.
        G_ba = _G_w(w1, E[e] - E[a], (gamma[e] + gamma[a]) / 2.0)  # (B, W1)
        G_ca = _G_w(w2, E[f] - E[a], (gamma[f] + gamma[a]) / 2.0)  # (C, W2)
        U_cd = -1j * torch.exp(
            -1j * (E[f][:, None] - E[e][None, :]) * tau3
            - (gamma[f][:, None] + gamma[e][None, :]) / 2.0 * tau3)  # (C, D)
        d1, d2, d3, d4 = _cast(G_ba.dtype, dip[e, a], dip[f][:, e],
                               dip[e, a], dip[e][:, f])
        # coef[b, c] = mu_b mu_cb sum_d mu_d mu_dc U_cd
        coef = (d1[:, None] * d2.T
                * ((U_cd * d4.T) @ d3)[None, :])               # (B, C)
        return -(G_ba.T @ coef @ G_ca)
    elif omega1 is None and tau1 is not None:
        w2, w3 = _real(omega2, dev), _real(omega3, dev)
        U_ba = -1j * torch.exp(-1j * (E[e] - E[a]) * tau1
                               - (gamma[e] + gamma[a]) / 2.0 * tau1)  # (B,)
        G_ca = _G_w(w2, E[f] - E[a], (gamma[f] + gamma[a]) / 2.0)     # (C, W2)
        dE_cd = E[f][:, None] - E[e][None, :]
        g_cd = (gamma[f][:, None] + gamma[e][None, :]) / 2.0
        G_cd = 1.0 / (w3[None, None, :] - dE_cd[..., None]
                      + 1j * g_cd[..., None])                  # (C, D, W3)
        d1, d2, d3, d4 = _cast(G_ca.dtype, dip[e, a], dip[f][:, e],
                               dip[e, a], dip[e][:, f])
        cb = d2 @ (d1 * U_ba)                                  # (C,)
        rows = torch.einsum("cd, cdj -> cj", d3[None, :] * d4.T, G_cd)
        return -(G_ca.T @ (cb[:, None] * rows))
    raise ValueError("specify either (omega1, omega2, tau3) or (omega2, omega3, tau1)")


def DQC_R2(evals, dip, omega1=None, omega2=None, omega3=None, tau1=None,
           tau3=None, g_idx=(0,), e_idx=None, f_idx=None, gamma=None,
           device=None):
    """DQC diagram 2 (reference: pyqed/signal/sos.py:1147)."""
    dev = resolve_device(device)
    E, dip, gamma, e, f = _dqc_operands(evals, dip, gamma, e_idx, f_idx, dev)
    a = 0
    if omega3 is None and tau3 is not None:
        w1, w2 = _real(omega1, dev), _real(omega2, dev)
        G_ba = _G_w(w1, E[e] - E[a], (gamma[e] + gamma[a]) / 2.0)
        G_ca = _G_w(w2, E[f] - E[a], (gamma[f] + gamma[a]) / 2.0)
        U_da = -1j * torch.exp(-1j * (E[e] - E[a]) * tau3
                               - (gamma[e] + gamma[a]) / 2.0 * tau3)   # (D,)
        # mu_dc indexed [c, d]: transpose of dip[e_d, f_c]
        x, y, mu_dc, z = _cast(G_ba.dtype, dip[e, a], dip[f][:, e],
                               dip[e][:, f].T, dip[a, e])
        coef = x[:, None] * y.T * (mu_dc @ (z * U_da))[None, :]   # (B, C)
        return G_ba.T @ coef @ G_ca
    elif omega1 is None and tau1 is not None:
        w2, w3 = _real(omega2, dev), _real(omega3, dev)
        U_ba = torch.exp(-1j * (E[e] - E[a]) * tau1
                         - (gamma[e] + gamma[a]) / 2.0 * tau1)
        G_ca = _G_w(w2, E[f] - E[a], (gamma[f] + gamma[a]) / 2.0)
        G_da = _G_w(w3, E[e] - E[a], (gamma[e] + gamma[a]) / 2.0)
        x, y, mu_dc, z = _cast(G_ca.dtype, dip[e, a], dip[f][:, e],
                               dip[e][:, f].T, dip[a, e])
        coef = (y @ (x * U_ba))[:, None] * mu_dc * z[None, :]     # (C, D)
        return G_ca.T @ coef @ G_da
    raise ValueError("specify either (omega1, omega2, tau3) or (omega2, omega3, tau1)")


# -------------------------------------------------------------------- ETPA

def etpa(omegaps, mol, epp, g_idx=0, e_idx=None, f_idx=None, device=None):
    """Entangled two-photon absorption with the joint temporal amplitude
    (reference: pyqed/signal/sos.py:1289). ``epp`` is any object whose
    ``get_jta()`` returns ``(t1, t2, jta)``."""
    t1, t2, jta = epp.get_jta()
    return _etpa(omegaps, mol.eigvals(), mol.edip, jta, t1, t2, g_idx, e_idx,
                 f_idx, device=device)


def _etpa(omegaps, Es, edip, jta, t1, t2, g_idx=0, e_idx=None, f_idx=None,
          device=None):
    """Vectorized double-time integral over the JTA
    (reference: pyqed/signal/sos.py:1321-1371 loops over (omegap, f, e)).

    For every (omegap, f, e) the (t2, t1) grid sum of the separable phases
    exp(i d2 t2) exp(i d1 t1) against the theta-masked JTA, both photon
    orderings at once: first the t1 sum, a (P, E, N1) x (N1, N2) product,
    then the t2 sum."""
    dev = resolve_device(device)
    Es, edip = _real(Es, dev), _real(edip, dev)
    jta, t1, t2 = _real(jta, dev), _real(t1, dev), _real(t2, dev)
    e, f = _idx(e_idx, dev), _idx(f_idx, dev)
    g = g_idx
    omegaps = torch.atleast_1d(_real(omegaps, dev))

    # meshgrid(t1, t2) 'xy' in the reference: T1[i, j] = t1[j],
    # T2[i, j] = t2[i]; theta is 0.5 on the diagonal
    theta = heaviside(t2[:, None] - t1[None, :])                  # (N2, N1)
    M = theta * jta + theta * jta.T    # both photon orderings

    w1 = omegaps[:, None] / 2.0
    det1 = (Es[e][None, :] - Es[g]) - w1                          # (P, E)
    det2 = (Es[f][None, :, None] - Es[e][None, None, :]) - w1[..., None]
    ph1 = torch.exp(1j * det1[..., None] * t1[None, None, :])     # (P, E, N1)
    ph2 = torch.exp(1j * det2[..., None] * t2)                    # (P, F, E, N2)
    X = ph1 @ M.T.to(ph1.dtype)                                   # (P, E, N2)
    term = (ph2 * X[:, None]).sum(-1)                             # (P, F, E)
    D = edip[e, g][None, :] * edip[f][:, e]                       # (F, E)
    return (D.to(term.dtype)[None] * term).sum((1, 2))


# ------------------------------------------------------------------- misc

def cars(E, edip, shift, omega1, t2=0.0, gamma=10 / au2mev, device=None):
    """Coherent anti-Stokes Raman (reference: pyqed/signal/sos.py:1392)."""
    dev = resolve_device(device)
    E, edip, shift = _real(E, dev), _real(edip, dev), _real(shift, dev)
    omega1 = torch.atleast_1d(_real(omega1, dev))
    N = E.shape[0]
    g = 0
    idx = torch.arange(1, N, device=dev)
    lor = lorentzian(shift[None, None, :]
                     - (E[idx][:, None] - E[idx][None, :])[..., None],
                     gamma)                                     # (B, A, S)
    disp = 1.0 / (omega1[None, :] - (E[idx] - E[g])[:, None]
                  + 1j * gamma)                                 # (A, W)
    alpha = 1.0 - torch.eye(N - 1, dtype=E.dtype, device=dev)
    pref = edip[idx, g][:, None] * edip[idx, g][None, :] * alpha  # (B, A)
    coef = torch.einsum("ba, bas -> sa", pref, lor)             # (S, A)
    return coef.to(disp.dtype) @ disp


def mcd(mol, omegas, device=None):
    """Magnetic circular dichroism (reference: pyqed/signal/sos.py:1434)."""
    dev = resolve_device(device)
    omegas = _real(omegas, dev)
    mu = _real(mol.edip, dev)[0, :, :]
    mu = mu.to(complex_dtype_for(mu))
    E = _real(mol.eigvals(), dev)
    gamma = _real(mol.gamma, dev)
    idx = torch.arange(1, mol.nstates, device=dev)
    weight = torch.imag(mu[idx, 0] * mu[idx, 1].conj()
                        - mu[idx, 1] * mu[idx, 0].conj())
    lor = lorentzian(omegas[None, :] - E[idx][:, None], gamma[idx][:, None])
    return weight @ lor


def polarizability(w, Er, Ev, d, use_rwa=True, device=None):
    """SOS polarizability (reference: pyqed/signal/sos.py:1491)."""
    dev = resolve_device(device)
    Er, Ev, d = _real(Er, dev), _real(Ev, dev), _real(d, dev)
    dE = Ev[:, None] - Er[None, :] - w
    q = d / dE
    return d.conj().T.to(q.dtype) @ q


def photon_echo_t2series_factored(mol, pump, probe, t2list, g_idx=(0,),
                                  e_idx=None, f_idx=None, device=None):
    """Low-rank photon-echo t2 series: the EXACT same GSB+SE+ESA signal
    as :func:`photon_echo_t2series`, reorganized as a sum of outer
    products over the two frequency axes,

        S(t2; w1, w3) = sum_k C_k(t2) A_k(w1) B_k(w3),

    with K = 1 + |e|^2 + |e||f| terms, the whole (nt2, nw1, nw3) map then
    one batched (nw1, K) x (K, nw3) product (reorganization of
    pyqed/signal/sos.py:498,624,731's triple loops)."""
    N = mol.nstates
    if e_idx is None:
        e_idx = list(range(N))
    if f_idx is None:
        f_idx = list(range(N))
    return _photon_echo_factored(mol.eigvals(), mol.edip_rms, mol.gamma,
                                 pump, probe, t2list, g_idx, e_idx, f_idx,
                                 device=device)


def _photon_echo_factors(evals, edip, gamma, pump, probe, t2list,
                         g_idx, e_idx, f_idx, device=None):
    """The exact low-rank factorization of the photon-echo cube:
    S[t2, w1, w3] = sum_k C[t2, k] A[k, w1] B[k, w3] with
    K = 1 + |e|^2 + |e||f| terms (GSB rank-1 + SE + ESA). Returns
    (C (T, K), A (K, W1), B (K, W3)), complex."""
    dev = resolve_device(device)
    E, dip, gamma, w1, w3, t2s, g, e, f = _pe_operands(
        evals, edip, gamma, -_real(pump, dev), probe, t2list, g_idx, e_idx,
        f_idx, dev)
    a = 0
    c0 = 0
    G_ab = _G_ab(E, gamma, w1, e)                               # (B, W1)
    U = _U_t2(E, gamma, e, t2s)                                 # (T, C, B)
    cdt = G_ab.dtype
    nb, nf, nt = len(e), len(f), len(t2s)
    W1, W3 = w1.shape[0], w3.shape[0]

    # ---- GSB: rank-1, t2-independent --------------------------------
    u_gsb, v_gsb = _gsb_factors(E, dip, gamma, w1, w3, e, a, c0)
    c_gsb = torch.ones((nt, 1), dtype=cdt, device=dev)

    # ---- SE: k = (b, c) ---------------------------------------------
    dE_cd = E[e][:, None] - E[g][None, :]
    g_cd = (gamma[e][:, None] + gamma[g][None, :]) / 2.0
    G_cd = 1.0 / (w3[None, None, :] - dE_cd[..., None]
                  + 1j * g_cd[..., None])                       # (C, Dg, W3)
    d3_se, d4_se, d1, d2 = _cast(cdt, dip[g][:, e], dip[e][:, g], dip[a, e],
                                 dip[e, a])
    A_se = G_ab[:, None, :].expand(nb, nb, W1)                  # (B, C, W1)
    B_se = torch.einsum("bcd, cdj -> bcj",
                        d3_se.T[None, :, :] * d4_se[:, None, :], G_cd)
    C_se = d1[None, :, None] * d2[None, None, :] * U.transpose(1, 2)

    # ---- ESA: k = (b, d) --------------------------------------------
    dE_db = E[f][:, None] - E[e][None, :]
    g_db = (gamma[f][:, None] + gamma[e][None, :]) / 2.0
    G_db = 1.0 / (w3[None, None, :] - dE_db[..., None]
                  + 1j * g_db[..., None])                       # (D, B, W3)
    A_esa = G_ab[:, None, :].expand(nb, nf, W1)
    B_esa = G_db.transpose(0, 1)                                # (B, D, W3)
    b_ea, d_ef, d_fe = _cast(cdt, dip[e, a], dip[e][:, f], dip[f][:, e])
    s = torch.einsum("dc, tcb -> tbd", d_fe * b_ea[None, :], U)  # (T, B, D)
    C_esa = -(b_ea[:, None] * d_ef)[None] * s

    A = torch.cat([u_gsb[None, :], A_se.reshape(-1, W1),
                   A_esa.reshape(-1, W1)], dim=0)               # (K, W1)
    B = torch.cat([v_gsb[None, :], B_se.reshape(-1, W3),
                   B_esa.reshape(-1, W3)], dim=0)               # (K, W3)
    C = torch.cat([c_gsb, C_se.reshape(nt, -1),
                   C_esa.reshape(nt, -1)], dim=1)               # (T, K)
    return C, A, B


def _photon_echo_factored(evals, edip, gamma, pump, probe, t2list,
                          g_idx, e_idx, f_idx, device=None):
    """Array-level core of :func:`photon_echo_t2series_factored`: the
    cube as one batched (W1, K) x (K, W3) product of the t2-weighted
    factors. Complex128 products are exact ZGEMMs (no reduced-precision
    tensor-core path exists for them)."""
    C, A, B = _photon_echo_factors(evals, edip, gamma, pump, probe, t2list,
                                   g_idx, e_idx, f_idx, device=device)
    return (A.T[None, :, :] * C[:, None, :]) @ B               # (T, W1, W3)


def vacuum_efield(omega, area=None, device=None):
    """Vacuum electric-field fluctuation prefactor sqrt(2 pi w / (c A))
    relating the E-operator to the annihilation operator (reference:
    pyqed/signal/ETPA.py vacuum_efield; quantization area defaults to
    the reference's ~1 um^2). NOTE the reference sets c = 1/137 — the
    fine-structure constant, not the atomic-unit speed of light 137 —
    so its prefactor is 137x too large; the physical value is used here,
    as in the JAX package."""
    dev = resolve_device(device)
    if area is None:
        area = (1e4 / au2angstrom) ** 2
    c = 137.035999
    return torch.sqrt(2.0 * np.pi * _real(omega, dev) / (c * area))


def _h_exp(z, a):
    """(exp(i z a) - 1)/(i z), the finite-window exponential integral
    (reference: pyqed/signal/ETPA.py h)."""
    return (torch.exp(1j * z * a) - 1.0) / (1j * z)


def etpa_amplitude(E, edip, Te, omegap, sigmap, g_idx=0, e_idx=None,
                   f_idx=None, decay=1e-4, device=None):
    """Closed-form entangled-TPA transition amplitudes A_f for SPDC
    type-II light (degenerate, Gaussian pump, sinc phase matching)
    through the SOS formula (reference: pyqed/signal/ETPA.py
    transition_amplitude — (f, m) double loop there; one product here).

    Returns A (nstates,) complex, nonzero on f_idx."""
    dev = resolve_device(device)
    E, edip = _real(E, dev), _real(edip, dev)
    N = E.shape[0]
    e, f = _idx(e_idx, dev), _idx(f_idx, dev)
    i = g_idx
    gamma = torch.zeros(N, dtype=E.dtype, device=dev)
    gamma[1:] = decay
    omega1 = omegap / 2.0
    omega2 = omegap - omega1

    det = (E[e] - E[i]) - 1j * gamma[e]                        # (E,)
    hsum = _h_exp(omega1 - det, Te) + _h_exp(omega2 - det, Te)
    D = edip[f][:, e] * edip[e, i][None, :]                    # (F, E)
    Af = D.to(hsum.dtype) @ hsum
    Af = Af * torch.exp(-(E[f] - E[i] - omegap) ** 2 / (4.0 * sigmap ** 2))
    pref = (np.sqrt(np.pi / (Te * sigmap))
            * vacuum_efield(omega1, device=dev)
            * vacuum_efield(omega2, device=dev) * (2.0 * np.pi) ** 0.75)
    out = torch.zeros(N, dtype=Af.dtype, device=dev)
    out[f] = pref * Af
    return out

"""The HEOM right-hand side and classical RK4, written from the
equation of motion (unscaled ADOs):

  d rho_n/dt = -i [H + E(t) mu, rho_n] - (n . nu) rho_n
               - i sum_m [Q_m, rho_{n+e_m}]
               - i sum_m n_m (c_m Q_m rho_{n-e_m} - c_m^* rho_{n-e_m} Q_m)

The state is a (nado, B, n, n) tensor: B independent hierarchies that
share H, the bath and mu, each with its own field E_b(t).
"""
from __future__ import annotations

import numpy as np
import torch

from .hierarchy import neighbours, occupations

# bytes of the gathered neighbour stack per block of destinations
GATHER_BYTES = 1 << 29
REAL = {torch.complex128: torch.float64, torch.complex64: torch.float32}


class PlainHEOM:
    """The hierarchy of ``H`` (n, n) under ``modes``, a list of
    (Q (n, n), c, nu) with C(t) = sum c exp(-nu t) for the bath that
    couples through Q, cut at ``lmax``, in ``dtype`` on ``device``."""

    def __init__(self, H, modes, lmax, dtype=torch.complex128,
                 device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        H = np.asarray(H, dtype=complex)
        self.n = H.shape[0]
        self.keys = occupations(len(modes), lmax)
        plus, minus = neighbours(self.keys)
        nado, M = self.keys.shape
        self.nado = nado
        # coupling operators, each kept once; modes that share one
        # operator are summed before it is applied
        ops, op_of = [], []
        for Q, _, _ in modes:
            Q = np.asarray(Q, dtype=complex)
            hit = [i for i, o in enumerate(ops) if np.array_equal(o, Q)]
            if not hit:
                ops.append(Q)
            op_of.append(hit[0] if hit else len(ops) - 1)
        S = len(ops)
        c = np.array([complex(m[1]) for m in modes])
        nu = np.array([complex(m[2]) for m in modes])
        occ = self.keys.astype(float)
        # weights of each (destination, neighbour) pair: plus neighbours
        # enter both sides with 1, minus neighbours with n_m c_m on the
        # left and n_m c_m^* on the right
        wl = np.concatenate([np.ones((nado, M)), occ * c], axis=1)
        wr = np.concatenate([np.ones((nado, M)), occ * np.conj(c)], axis=1)
        onehot = np.zeros((2 * M, S))
        onehot[np.arange(2 * M), np.concatenate([op_of, op_of])] = 1.0
        W = np.concatenate([wl[:, :, None] * onehot,
                            wr[:, :, None] * onehot], axis=2)
        idx = np.concatenate([plus, minus], axis=1)
        idx[idx < 0] = nado
        t = lambda a, dt=dtype: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=dt, device=self.device)
        self.W = t(W.transpose(0, 2, 1))                 # (nado, 2S, 2M)
        self.idx = t(idx, torch.long)                    # (nado, 2M)
        self.Q = t(np.stack(ops))                        # (S, n, n)
        self.H = t(H)
        damp = occ @ nu
        self.damp = (t(damp) if np.any(damp.imag)
                     else t(damp.real, REAL[dtype]))
        self.S = S

    def rhs(self, y, drive=None):
        """d y / dt for y (nado, B, n, n); ``drive`` = (mu (n, n), E (B,))
        adds -i E_b [mu, rho] to member b."""
        nado, B, n = y.shape[0], y.shape[1], self.n
        out = -1j * (self.H @ y - y @ self.H)
        out -= self.damp.view(-1, 1, 1, 1) * y
        if drive is not None:
            mu, E = drive
            out -= 1j * E.view(1, -1, 1, 1) * (mu @ y - y @ mu)
        ypad = torch.cat([y, y.new_zeros((1,) + y.shape[1:])])
        per_dest = self.idx.shape[1] * B * n * n * y.element_size()
        blk = max(1, GATHER_BYTES // per_dest)
        S = self.S
        for lo in range(0, nado, blk):
            hi = min(nado, lo + blk)
            g = ypad[self.idx[lo:hi]].reshape(hi - lo, -1, B * n * n)
            lr = torch.bmm(self.W[lo:hi], g).view(hi - lo, 2, S, B, n, n)
            out[lo:hi] -= 1j * (
                torch.einsum("sab, dsxbc -> dxac", self.Q, lr[:, 0])
                - torch.einsum("dsxab, sbc -> dxac", lr[:, 1], self.Q))
        return out

    def rk4(self, y, dt, fields=None, mu=None):
        """One classical RK4 step; ``fields`` = (E(t), E(t + dt/2),
        E(t + dt)), each (B,), when driven by ``mu``."""
        d = ((lambda i: None) if fields is None
             else (lambda i: (mu, fields[i])))
        k1 = self.rhs(y, d(0))
        k2 = self.rhs(y + (dt / 2) * k1, d(1))
        k3 = self.rhs(y + (dt / 2) * k2, d(1))
        k4 = self.rhs(y + dt * k3, d(2))
        return y + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)

    def start(self, rho0):
        """The hierarchy of the states rho0 (B, n, n): each in its root
        ADO, every other ADO zero."""
        rho0 = torch.as_tensor(rho0).to(self.device, self.dtype)
        y = torch.zeros((self.nado,) + tuple(rho0.shape), dtype=self.dtype,
                        device=self.device)
        y[0] = rho0
        return y

    def trajectory(self, rho0, dt, nt, nout, e_ops, efield=None, mu=None):
        """<E_k>(t) = tr(E_k rho(t)) at t = 0, nout dt, ... from rho0
        (n, n): a (nt // nout + 1, K) complex tensor. ``efield`` (a
        function of t) drives the system through ``mu``."""
        y = self.start(np.asarray(rho0)[None])
        E = torch.as_tensor(np.stack([np.asarray(e) for e in e_ops])).to(
            self.device, self.dtype)
        mu_t = (None if mu is None else
                torch.as_tensor(np.asarray(mu)).to(self.device, self.dtype))
        rdt = REAL[self.dtype]

        def fields(t):
            return tuple(torch.tensor([efield(s)], dtype=rdt,
                                      device=self.device)
                         for s in (t, t + dt / 2, t + dt))

        obs = [torch.einsum("kij, ji -> k", E, y[0, 0])]
        for k in range(nt):
            f = None if efield is None else fields(k * dt)
            y = self.rk4(y, dt, f, mu_t)
            if (k + 1) % nout == 0:
                obs.append(torch.einsum("kij, ji -> k", E, y[0, 0]))
        return torch.stack(obs)

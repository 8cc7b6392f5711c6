"""Approximate joint diagonalization of a set of symmetric matrices.

Counterpart of ``pyqed_tpu/ops/jointdiag.py``: the Jacobi-rotation scheme
of Cardoso and Souloumiac, sweeps of 2x2 rotations minimizing the sum of
squared off-diagonal elements, each rotation vectorized over the matrix
stack. The sweeps are sequential scalar work and stay host NumPy, as in
the JAX package; the results come back as tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def joint_diagonalize(Ms, max_sweeps=50, tol=1e-12):
    """Orthogonal V minimizing Σ_k offdiag(Vᵀ M_k V)².

    Ms : (K, n, n) stack of real symmetric matrices (array or tensor).
    Returns (V, Ds) with Ds the rotated stack, float64 tensors on the
    input's device (the CPU for an array).
    """
    device = Ms.device if isinstance(Ms, torch.Tensor) else "cpu"
    if isinstance(Ms, torch.Tensor):
        Ms = Ms.detach().cpu().numpy()
    Ms = np.array(Ms, dtype=float, copy=True)
    K, n, _ = Ms.shape
    V = np.eye(n)

    def off(M):
        return np.sum(M ** 2) - np.sum(np.diagonal(M, axis1=-2,
                                                   axis2=-1) ** 2)

    prev = sum(off(M) for M in Ms)
    for sweep in range(max_sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                # Cardoso-Souloumiac closed-form optimal angle
                h_pp = Ms[:, p, p]
                h_qq = Ms[:, q, q]
                h_pq = Ms[:, p, q]
                ton = h_pp - h_qq
                toff = 2.0 * h_pq
                theta = 0.5 * np.arctan2(
                    np.sum(toff * ton),
                    np.sum(ton ** 2 - toff ** 2)
                    + np.sqrt(np.sum(ton ** 2 - toff ** 2) ** 2
                              + np.sum(toff * ton) ** 2 * 4) + 1e-300)
                c, s = np.cos(theta), np.sin(theta)
                if abs(s) < 1e-15:
                    continue
                # rotate rows/cols p, q of every matrix
                Mp = Ms[:, :, p].copy()
                Mq = Ms[:, :, q].copy()
                Ms[:, :, p] = c * Mp + s * Mq
                Ms[:, :, q] = -s * Mp + c * Mq
                Mp = Ms[:, p, :].copy()
                Mq = Ms[:, q, :].copy()
                Ms[:, p, :] = c * Mp + s * Mq
                Ms[:, q, :] = -s * Mp + c * Mq
                Vp = V[:, p].copy()
                V[:, p] = c * Vp + s * V[:, q]
                V[:, q] = -s * Vp + c * V[:, q]
        cur = sum(off(M) for M in Ms)
        if prev - cur < tol * max(cur, 1.0):
            break
        prev = cur
    return (torch.as_tensor(V, device=device),
            torch.as_tensor(Ms, device=device))


qndiag = joint_diagonalize

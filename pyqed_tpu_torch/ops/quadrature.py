"""Quadrature rules and combinatorics utilities.

Counterpart of ``pyqed_tpu/ops/quadrature.py``: Gauss-Hermite and
Gauss-Legendre nodes and weights (NumPy, as in the JAX package), Fock
space enumeration, ``dagger`` and ``delta``.

The name ``quadrature`` on ``pyqed_tpu_torch.ops`` is the quadrature
operator of ``ops/operators``, as on ``pyqed_tpu.ops``: the package binds
that function first, so ``from . import quadrature`` leaves it in place,
and this module is reached as ``pyqed_tpu_torch.ops.quadrature`` only
where it is imported by that path.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .linalg import as_tensor


# -------------------------------------------------------------- quadrature

def gauss_hermite(n, x0=0.0, alpha=1.0):
    """Nodes/weights for int f(x) e^{-alpha (x-x0)^2} dx."""
    x, w = np.polynomial.hermite.hermgauss(n)
    s = 1.0 / np.sqrt(alpha)
    return x0 + s * x, s * w


def gauss_hermite_normalized(n, x0=0.0, alpha=1.0):
    """Nodes/weights absorbing the Gaussian weight, for plain sums
    sum w_i f(x_i) ~ int f(x) dx with f sharply peaked at x0."""
    x, w = gauss_hermite(n, x0, alpha)
    return x, w * np.exp(alpha * (x - x0) ** 2)


def gauss_legendre(n, a=-1.0, b=1.0):
    x, w = np.polynomial.legendre.leggauss(n)
    mid, half = 0.5 * (a + b), 0.5 * (b - a)
    return mid + half * x, half * w


# ------------------------------------------------------------ combinatorics

def multichoose(n, k):
    """Number of weak compositions of k into n parts."""
    return math.comb(n + k - 1, k)


def fock_enumerate(nmodes, nmax, truncation="total"):
    """Enumerate boson occupation vectors.

    truncation='total': all n with sum(n) <= nmax (graded by level, the
    HEOM/Fock hierarchy order); truncation='local': the direct-product
    grid 0..nmax per mode.
    """
    if truncation == "local":
        return np.array(list(itertools.product(range(nmax + 1),
                                               repeat=nmodes)),
                        dtype=np.int32)
    keys = []
    for level in range(nmax + 1):
        for comb in itertools.combinations_with_replacement(
                range(nmodes), level):
            n = [0] * nmodes
            for c in comb:
                n[c] += 1
            keys.append(n)
    return np.array(keys, dtype=np.int32)


def fock_index(keys):
    """Occupation-vector -> linear index lookup dict."""
    return {tuple(k): i for i, k in enumerate(np.asarray(keys))}


# ------------------------------------------------------------------ common

def dagger(a):
    """Conjugate transpose of the last two axes (a tensor; a NumPy input
    becomes a CPU tensor)."""
    return torch.conj(torch.swapaxes(as_tensor(a), -1, -2)).resolve_conj()


def delta(i, j):
    return 1.0 if i == j else 0.0

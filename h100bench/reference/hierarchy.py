"""The HEOM hierarchy as plain index arrays.

An auxiliary density operator (ADO) is labelled by occupations
(n_1 .. n_M) of the M bath modes with sum n <= lmax. Its plus neighbour
along mode m is n + e_m (absent at sum n = lmax), its minus neighbour
n - e_m (absent where n_m = 0).
"""
from __future__ import annotations

import numpy as np


def occupations(nmodes, lmax):
    """(nado, nmodes) int array of every occupation vector with sum <=
    lmax, the lowest total first."""
    rows = []

    def fill(prefix, left, depth):
        if depth == nmodes:
            rows.append(prefix)
            return
        for k in range(left, -1, -1):
            fill(prefix + [k], left - k, depth + 1)

    fill([], lmax, 0)
    keys = np.array(rows, dtype=np.int64).reshape(-1, nmodes)
    return keys[np.argsort(keys.sum(axis=1), kind="stable")]


def neighbours(keys):
    """(plus, minus): (nado, nmodes) int arrays of the rows of n + e_m and
    n - e_m, -1 where that ADO is not in the hierarchy."""
    nado, nmodes = keys.shape
    where = {tuple(k): i for i, k in enumerate(keys.tolist())}
    plus = np.full((nado, nmodes), -1, dtype=np.int64)
    minus = np.full((nado, nmodes), -1, dtype=np.int64)
    for i, k in enumerate(keys.tolist()):
        for m in range(nmodes):
            k[m] += 1
            plus[i, m] = where.get(tuple(k), -1)
            k[m] -= 2
            if k[m] >= 0:
                minus[i, m] = where[tuple(k)]
            k[m] += 1
    return plus, minus

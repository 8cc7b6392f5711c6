"""Operations and bytes of one HEOM coupling call: for every existing
edge (destination n, mode m, direction), the term -i [Q_m, rho_{n+e_m}]
or -i n_m (c_m Q_m rho_{n-e_m} - c_m^* rho_{n-e_m} Q_m) for every batch
member.

Operations are counted from the structure of the operators: the edge's
superoperator a (Q ⊗ 1) + b (1 ⊗ Q^T) acting on vec(rho) has nnz nonzero
entries, each one complex multiply-add (8 flops); a site projector gives
2n - 2 (2n - 1 where Im c_m != 0), not the n^4 of a dense product. Bytes
are the source rows read once and the destination rows written once; the
neighbour tables and the operators are left out, since a program can
compute the one from the occupations and needs only Q of the other."""
from __future__ import annotations

import numpy as np

from reference.hierarchy import neighbours, occupations

_cache = {}


def superop_nnz(Q, a, b):
    n = Q.shape[0]
    op = a * np.kron(Q, np.eye(n)) + b * np.kron(np.eye(n), Q.T)
    return int(np.count_nonzero(op))


def structure(model):
    """Per mode: plus and minus edge counts and their superoperators'
    nonzeros; the ADO count and the source rows read, of a plain model
    ({"modes": [(Q, c, nu)], "lmax": ...})."""
    key = id(model)
    if key not in _cache:
        modes = model["modes"]
        keys = occupations(len(modes), model["lmax"])
        plus, minus = neighbours(keys)
        rows = []
        for m, (Q, c, _) in enumerate(modes):
            Q = np.asarray(Q, dtype=complex)
            c = complex(c)
            rows.append((int((plus[:, m] >= 0).sum()),
                         superop_nnz(Q, -1j, 1j),
                         int((minus[:, m] >= 0).sum()),
                         superop_nnz(Q, -1j * c, 1j * np.conj(c))))
        sources = np.unique(np.concatenate([plus[plus >= 0],
                                            minus[minus >= 0]]))
        _cache[key] = {"nado": keys.shape[0], "edges": rows,
                       "sources": int(sources.size),
                       "occupied": keys, "model": model}
    return _cache[key]


def count(model, batch=1, itemsize=16):
    """(flops, bytes) of one call on ``batch`` members of ``itemsize``
    bytes per complex element."""
    s = structure(model)
    n = np.asarray(model["H"]).shape[0]
    V = n * n
    flops = 8 * batch * sum(pe * pn + me * mn for pe, pn, me, mn in
                            s["edges"])
    nbytes = itemsize * batch * V * (s["sources"] + s["nado"])
    return float(flops), float(nbytes)

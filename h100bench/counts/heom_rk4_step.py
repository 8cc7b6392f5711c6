"""Operations and bytes of one classical RK4 step of the HEOM, the work
the algorithm needs whatever implements it: four right-hand sides and
the combination of the stages, with the state read once and written
once.

A right-hand side is, for each ADO and batch member, -i [H, rho]
(2 nnz(H) n complex multiply-adds), the damping -(n . nu) rho (4 flops
an element, where the rate is not 0), the coupling (``heom_coupling``),
and with a drive -i E(t) [mu, rho] (2 nnz(mu) n multiply-adds and 4
flops an element). The combination is three stage inputs y + a k and the
update y + dt/6 (k1 + 2 k2 + 2 k3 + k4): 7 real-times-complex
multiply-adds, 28 flops an element. Bytes: the state once each way and,
for a driven step, two new field values per member (``field_bytes``)
plus whatever the caller adds (``extra_bytes``, e.g. a recorded
signal)."""
from __future__ import annotations

import numpy as np

from harness import registry


def count(model, batch=1, itemsize=16, mu=None, extra_bytes=0.0):
    """(flops, bytes) of one step of ``batch`` members; ``mu`` the
    dipole of a drive."""
    coupling = registry.module("counts", "heom_coupling")
    s = coupling.structure(model)
    H = np.asarray(model["H"])
    n = H.shape[0]
    V = n * n
    nado = s["nado"]
    rates = np.asarray([complex(m[2]) for m in model["modes"]])
    damped = int(np.count_nonzero(s["occupied"] @ rates))
    per_member = (16 * np.count_nonzero(H) * n * nado + 4 * V * damped)
    if mu is not None:
        per_member += (16 * np.count_nonzero(mu) * n + 4 * V) * nado
    rhs = batch * per_member + coupling.count(model, batch, itemsize)[0]
    flops = 4 * rhs + 28 * V * nado * batch
    nbytes = 2 * itemsize * batch * V * nado + extra_bytes
    if mu is not None:
        nbytes += 2 * (itemsize // 2) * batch
    return float(flops), float(nbytes)

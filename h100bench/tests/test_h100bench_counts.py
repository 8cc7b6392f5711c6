"""The count functions against hand counts at tiny shapes."""
import numpy as np
import pytest

from harness import peaks, registry
from reference.bath import drude_pade
from reference.hierarchy import neighbours, occupations

coupling = registry.module("counts", "heom_coupling")
step = registry.module("counts", "heom_rk4_step")


def two_level(c=0.3 - 0.2j, lmax=1):
    Q = np.diag([0.0, 1.0]).astype(complex)
    return {"H": np.array([[0.0, 0.1], [0.1, 1.0]], dtype=complex),
            "modes": [(Q, c, 0.5)], "lmax": lmax}


def test_two_level_coupling_by_hand():
    # one mode, lmax 1: ADOs (0) and (1); one plus edge 0 <- 1 and one
    # minus edge 1 <- 0. The projector's superoperators: -i(Q x 1) +
    # i(1 x Q^T) has 2n - 2 = 2 nonzeros, with a complex c 2n - 1 = 3.
    flops, nbytes = coupling.count(two_level(), batch=1, itemsize=16)
    assert flops == 8 * (1 * 2 + 1 * 3)
    assert nbytes == 16 * 4 * (2 + 2)
    flops_b, nbytes_b = coupling.count(two_level(), batch=5, itemsize=8)
    assert flops_b == 5 * flops and nbytes_b == 5 * nbytes / 2
    # a real c cancels on the diagonal as the plus side does
    assert coupling.count(two_level(c=0.3), 1, 16)[0] == 8 * (2 + 2)


def test_two_level_step_by_hand():
    m = two_level()
    V, nado = 4, 2
    fl_c, _ = coupling.count(m, 1, 16)
    # H has 3 nonzeros: 2 nnz(H) n = 12 multiply-adds an ADO; the root's
    # rate is 0, the other ADO's 0.5
    rhs = 2 * (16 * 3 * 2) + 1 * 4 * V + fl_c
    flops, nbytes = step.count(m, batch=1, itemsize=16)
    assert flops == 4 * rhs + 28 * V * nado
    assert nbytes == 2 * 16 * V * nado
    mu = np.array([[0.0, 1.0], [1.0, 0.0]])
    flops_d, nbytes_d = step.count(m, 1, 16, mu=mu, extra_bytes=3.0)
    assert flops_d == flops + 4 * nado * (16 * 2 * 2 + 4 * V)
    assert nbytes_d == nbytes + 3.0 + 2 * 8


def test_fmo_hierarchy_sizes():
    cfg = registry.config(registry.benchmark(), "fmo_77k")
    model = registry.module("systems", "fmo").plain(cfg)
    s = coupling.structure(model)
    assert s["nado"] == cfg["nado"] == 12650
    # every plus edge n <- n + e_m has a minus edge n + e_m <- n
    plus = sum(r[0] for r in s["edges"])
    minus = sum(r[2] for r in s["edges"])
    assert plus == minus == 21 * 2024      # ADOs below lmax x modes


def test_structure_count_is_below_the_dense_count():
    # chip_smoke.py counts every edge as a dense V x V product (8 V^2
    # flops) and every operand's bytes: the structure count never
    # exceeds it, so a share on it reads no higher than on that one
    cfg = registry.config(registry.benchmark(), "chain8_f2des")
    model = registry.module("systems", "exciton_chain").plain(cfg)
    keys = occupations(len(model["modes"]), model["lmax"])
    plus, minus = neighbours(keys)
    edges = int((plus >= 0).sum() + (minus >= 0).sum())
    V = 64
    flops, nbytes = coupling.count(model, batch=256, itemsize=16)
    assert flops < 8 * V * V * edges * 256
    assert nbytes == 16 * 256 * V * 2 * 680
    assert peaks.least_seconds(flops, nbytes) == pytest.approx(
        nbytes / peaks.BYTES_PER_S)


def test_pade_terms_of_the_configs():
    c, nu = drude_pade(0.02, 0.25, 0.25, 1)
    assert c.shape == nu.shape == (2,)
    assert nu[0] == 0.25 and nu[1] > 2 * np.pi * 0.25

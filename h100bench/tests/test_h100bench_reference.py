"""The plain reference against pyqed_tpu_torch on the CPU at tiny sizes
(the test imports both; the reference imports nothing of the program)."""
import numpy as np
import pytest
import torch

from harness import registry
from reference.bath import drude_pade, pade_bose
from reference.field2des import rephasing_rows
from reference.heom import PlainHEOM
from reference.hierarchy import neighbours, occupations


def test_pade_approximates_coth():
    # coth(x / 2) ~ 2 / x + sum 4 eta x / (x^2 + xi^2), better with
    # every term
    x = np.linspace(0.1, 4.0, 40)
    errs = []
    for N in (1, 2, 3, 4):
        xi, eta = pade_bose(N)
        approx = 2 / x + np.sum(4 * eta * x[:, None]
                                / (x[:, None] ** 2 + xi ** 2), axis=1)
        errs.append(np.max(np.abs(approx * np.tanh(x / 2) - 1)))
    assert errs == sorted(errs, reverse=True) and errs[-1] < 1e-6


@pytest.mark.parametrize("nexp", [0, 1, 2, 3])
def test_pade_against_the_program(nexp):
    from pyqed_tpu_torch import DrudeBath
    args = (0.02, 0.25, 0.3)
    c, nu = drude_pade(*args, nexp)
    c2, nu2 = DrudeBath(temperature=args[2], cutoff=args[1],
                        reorg=args[0]).pade(nexp)
    assert np.allclose(c, c2, rtol=1e-13, atol=0)
    assert np.allclose(nu, nu2, rtol=1e-13, atol=0)


def test_hierarchy_against_the_program():
    from pyqed_tpu_torch.open.heom import enumerate_hierarchy
    keys = occupations(5, 3)
    theirs = enumerate_hierarchy(5, 3)[0]
    assert sorted(map(tuple, keys)) == sorted(map(tuple, theirs))
    plus, minus = neighbours(keys)
    for i, k in enumerate(keys):
        for m in range(5):
            if plus[i, m] >= 0:
                assert (keys[plus[i, m]] - k).tolist() == np.eye(
                    5, dtype=int)[m].tolist()
            assert (minus[i, m] >= 0) == (k[m] > 0)


def fmo_small(lmax=2, nexp=1):
    cfg = registry.config(registry.benchmark(), "fmo_77k")
    cfg.update(lmax=lmax, nexp=nexp)
    return cfg, registry.module("systems", "fmo")


@pytest.mark.parametrize("driven", [False, True])
def test_fmo_trajectory_against_the_program(driven):
    from pyqed_tpu_torch import GaussianPulse
    cfg, fmo = fmo_small()
    drv = registry.module("drivers", "heom_trajectories")
    traffic = registry.data("traffic", "driven" if driven else "pop")
    sol, e_ops = fmo.program(cfg, None, "cpu", torch.complex128)
    rng = np.random.default_rng(3)
    psi = rng.standard_normal(7) + 1j * rng.standard_normal(7)
    psi /= np.linalg.norm(psi)
    rho0 = np.outer(psi, psi.conj())
    kw, ref_kw = {}, {}
    if driven:
        X, p = drv.drive_of(cfg, traffic)
        # a pulse centred in the short run, so the drive matters
        p = dict(p, tc=200.0)
        kw = {"edip": X, "pulse": GaussianPulse(
            omegac=p["omega"], tau=p["tau"], tc=p["tc"],
            amplitude=p["amplitude"]).efield}
        ref_kw = {"mu": X, "efield": drv.gaussian(p)}
    res = sol.run(torch.as_tensor(rho0), dt=10.0, nt=60, nout=6,
                  e_ops=e_ops, kernel="einsum", **kw)
    model = fmo.plain(cfg)
    ref = PlainHEOM(model["H"], model["modes"], model["lmax"]).trajectory(
        rho0, 10.0, 60, 6, model["e_ops"], **ref_kw)
    assert (res.observables - ref).abs().max().item() < 1e-13
    moved = (ref[-1] - ref[0]).abs().max().item()
    assert moved > 1e-4
    if driven:
        undriven = PlainHEOM(model["H"], model["modes"],
                             model["lmax"]).trajectory(
            rho0, 10.0, 60, 6, model["e_ops"])
        assert (undriven - ref).abs().max().item() > 1e-6


def test_field2des_rows_against_the_program():
    from pyqed_tpu_torch.signal.field2des import field_2des_rephasing
    cfg = registry.config(registry.benchmark(), "chain8_f2des")
    cfg.update(n_sites=2, lmax=2)
    chain = registry.module("systems", "exciton_chain")
    job = {"site_energies": np.array([1.02, 0.97])}
    sol = chain.program(cfg, job, "cpu", torch.complex128)
    _, _, mu, rho0 = chain.operators(cfg, job)
    t1s = 0.2 * np.arange(4)
    kw = dict(t2=0.2, nt3=10, dt=0.05)
    P3, _, _ = field_2des_rephasing(sol, rho0, mu, t1s, pulse_width=0.3,
                                    e_amps=(0.05,) * 3, omega_c=1.0,
                                    n_phase=(3, 2), kernel="einsum", **kw)
    model = chain.plain(cfg, job)
    heom = PlainHEOM(model["H"], model["modes"], model["lmax"])
    rows = [0, 2, 3]
    ref = rephasing_rows(heom, model["rho0"], model["mu"], t1s, rows,
                         width=0.3, amps=(0.05,) * 3, omega=1.0,
                         n_phase=(3, 2), **kw)
    gap = (P3[rows] - ref).abs().max() / ref.abs().max()
    assert gap.item() < 1e-12
    assert ref.abs().max().item() > 1e-8


def test_reference_in_blocks_equals_whole(monkeypatch):
    import reference.heom as rh
    model = fmo_small()[1].plain(fmo_small()[0])
    heom = PlainHEOM(model["H"], model["modes"], model["lmax"])
    y = torch.randn((heom.nado, 3, 7, 7), dtype=torch.complex128)
    whole = heom.rhs(y)
    monkeypatch.setattr(rh, "GATHER_BYTES", 1)
    assert torch.allclose(heom.rhs(y), whole, rtol=1e-14, atol=1e-14)

"""Parity of the PyTorch port's md/ (pyqed_tpu_torch.md: LJMD with its
molecular dynamics, minimisation and Monte Carlo; RPMD with the PILE-L
thermostat) with the JAX package, on the CPU in float64.

The random inputs are the JAX package's own draws, regenerated here from
the ``jax.random`` chains its methods walk (the module fixture ``jref``
computes every JAX reference once): LJMD's initial velocities and Monte
Carlo moves, RPMD's thermal samples and PILE normals. The port must follow
JAX's trajectories within 1e-10 relative, and JAX's Monte Carlo
acceptances exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.md import md as jmd
from pyqed_tpu.md import rpmd as jrpmd

import pyqed_tpu_torch as pt
from pyqed_tpu_torch.md import md as tmd
from pyqed_tpu_torch.md import rpmd as trpmd

TOL = 1e-10
LJ = dict(ncell=2, density=0.8, temperature=1.0)
LJ_RUN = dict(dt=0.005, nt=60, thermostat_steps=20)
MC_RUN = dict(nmoves=300, delta=0.15, sample_every=10)
RP = dict(beta=4.0, nbeads=8)
RP_NTRAJ = 12
RP_THERM = dict(dt=0.05, nsteps=30)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def t(a):
    return torch.as_tensor(np.array(a))


def _anharmonic_j(x):
    return 0.5 * jnp.sum(x ** 2) + 0.1 * jnp.sum(x ** 4)


def _anharmonic_t(x):
    return 0.5 * torch.sum(x ** 2) + 0.1 * torch.sum(x ** 4)


def _mc_draws(key, nmoves, n, delta):
    def one(k):
        ki, kd, ka = jax.random.split(k, 3)
        return (jax.random.randint(ki, (), 0, n),
                jax.random.uniform(kd, (3,), minval=-delta, maxval=delta),
                jax.random.uniform(ka))
    return jax.vmap(one)(jax.random.split(key, nmoves))


def _pile_draws(key, ntraj, nsteps, n, nd):
    def one(k):
        def step(kk):
            k1, k2 = jax.random.split(kk)
            return (jax.random.normal(k1, (n, nd)),
                    jax.random.normal(k2, (n, nd)))
        return jax.vmap(step)(jax.random.split(k, nsteps))
    a, b = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(key), ntraj))
    # (ntraj, nsteps, n, nd) each -> (nsteps, 2, ntraj, n, nd)
    return jnp.stack([jnp.swapaxes(a, 0, 1), jnp.swapaxes(b, 0, 1)], axis=1)


@pytest.fixture(scope="module")
def jref():
    out = {}
    lj = jmd.LJMD(**LJ)
    key = jax.random.PRNGKey(3)
    out["run"] = lj.run(key, **LJ_RUN)
    out["v0"] = jax.random.normal(key, (lj.n, 3))
    out["min"] = lj.minimize(nsteps=30, step0=1e-3)
    mkey = jax.random.PRNGKey(4)
    x0 = np.asarray(out["run"]["x"])
    out["mc"] = lj.monte_carlo(mkey, x0=x0, **MC_RUN)
    out["mc_draws"] = jax.jit(_mc_draws, static_argnums=(1, 2, 3))(
        mkey, MC_RUN["nmoves"], lj.n, MC_RUN["delta"])
    out["rdf"] = lj.rdf(x0, nbins=40)
    rp = jrpmd.RPMD(_anharmonic_j, ndim=2, **RP)
    out["harm"] = rp.sample_harmonic(5, RP_NTRAJ, 1.0, x_center=0.2)
    out["free"] = rp.sample_free(6, RP_NTRAJ, x_center=-0.1)
    kx, kp = jax.random.split(jax.random.PRNGKey(5))
    shape = (RP_NTRAJ, RP["nbeads"], 2)
    out["harm_draws"] = (jax.random.normal(kx, shape),
                         jax.random.normal(kp, shape))
    kx, kp = jax.random.split(jax.random.PRNGKey(6))
    out["free_draws"] = (jax.random.normal(kx, shape),
                         jax.random.normal(kp, shape))
    x0, p0 = out["harm"]
    out["therm"] = rp.thermalize(x0, p0, 7, **RP_THERM)
    out["therm_tau"] = rp.thermalize(x0, p0, 7, tau0=3.0, **RP_THERM)
    out["pile_draws"] = jax.jit(_pile_draws, static_argnums=range(5))(
        7, RP_NTRAJ, RP_THERM["nsteps"], RP["nbeads"], 2)
    res = rp.run(x0, p0, dt=0.02, nt=40, nout=8)
    out["res"] = {k: np.asarray(getattr(res, k))
                  for k in ("x", "p", "centroid", "energy", "times")}
    out["tcf"] = rp.position_tcf(x0, p0, dt=0.02, nt=40, nout=4)
    return out


# ---------------------------------------------------------------- LJMD
def test_lj_forces_match_jax():
    x, L = jmd.fcc_lattice(3, 0.8)
    xt, Lt = tmd.fcc_lattice(3, 0.8)
    np.testing.assert_array_equal(xt, x)
    assert Lt == L
    x = x + 0.05 * np.random.default_rng(0).normal(size=x.shape)
    for a, b in zip(tmd.lj_forces(t(x), L), jmd.lj_forces(jnp.asarray(x),
                                                            L)):
        assert rel(a, b) < 1e-12


def test_ljmd_run_fed_jax_velocities_matches_jax(jref):
    ref = jref["run"]
    lj = tmd.LJMD(device="cpu", **LJ)
    out = lj.run(0, v0_draws=t(jref["v0"]), **LJ_RUN)
    for k in ("x", "v", "U", "T", "P"):
        assert rel(out[k], ref[k]) < TOL, k


def test_ljmd_minimize_matches_jax(jref):
    x, U = tmd.LJMD(device="cpu", **LJ).minimize(nsteps=30, step0=1e-3)
    assert rel(x, jref["min"][0]) < TOL and rel(U, jref["min"][1]) < TOL


def test_ljmd_monte_carlo_fed_jax_draws_matches_jax(jref):
    ref = jref["mc"]
    lj = tmd.LJMD(device="cpu", **LJ)
    out = lj.monte_carlo(0, x0=np.asarray(jref["run"]["x"]),
                         draws=[t(d) for d in jref["mc_draws"]], **MC_RUN)
    assert out["acceptance"] == ref["acceptance"]
    assert rel(out["x"], ref["x"]) < TOL
    assert abs(out["U"] - ref["U"]) < TOL * abs(ref["U"])
    assert rel(out["samples"], ref["samples"]) < TOL
    r, g = lj.rdf(out["x"], nbins=40)
    np.testing.assert_allclose(r, jref["rdf"][0], rtol=1e-14)


def test_ljmd_own_draws_thermostat_and_mc():
    lj = tmd.LJMD(device="cpu", **LJ)
    out = lj.run(1, dt=0.005, nt=40, thermostat_steps=40)
    # the rescaled velocities sit at the set temperature (T is measured
    # before the rescale, as in the JAX package)
    T_end = float(torch.sum(out["v"] ** 2)) / (3.0 * lj.n)
    assert abs(T_end - 1.0) < 1e-12 and out["T"].shape == (40,)
    mc = lj.monte_carlo(2, nmoves=200, delta=0.1, sample_every=50)
    assert 0.0 < mc["acceptance"] <= 1.0 and mc["samples"].shape == (4,)
    assert pt.md.MonteCarlo is tmd.LJMD


# ---------------------------------------------------------------- RPMD
def test_normal_modes_and_kubo_match_jax():
    for n in (1, 2, 7, 32):
        for a, b in zip(trpmd.normal_mode_matrix(n),
                        jrpmd.normal_mode_matrix(n)):
            np.testing.assert_array_equal(a, b)
    ts = np.linspace(0, 5, 11)
    np.testing.assert_array_equal(trpmd.kubo_harmonic_xx(ts, 1.3, 2.0),
                                  jrpmd.kubo_harmonic_xx(ts, 1.3, 2.0))


def test_rpmd_samples_fed_jax_draws_match_jax(jref):
    rp = trpmd.RPMD(_anharmonic_t, ndim=2, device="cpu", **RP)
    for name, call in (("harm", lambda d: rp.sample_harmonic(
            0, RP_NTRAJ, 1.0, x_center=0.2, draws=d)),
                       ("free", lambda d: rp.sample_free(
                           0, RP_NTRAJ, x_center=-0.1, draws=d))):
        x, p = call([t(d) for d in jref[name + "_draws"]])
        assert rel(x, jref[name][0]) < 1e-13
        assert rel(p, jref[name][1]) < 1e-13


@pytest.mark.parametrize("tau0", [None, 3.0])
def test_rpmd_pile_thermalize_fed_jax_draws_matches_jax(jref, tau0):
    ref = jref["therm" if tau0 is None else "therm_tau"]
    rp = trpmd.RPMD(_anharmonic_t, ndim=2, device="cpu", **RP)
    x0, p0 = jref["harm"]
    x, p = rp.thermalize(t(x0), t(p0), 0, tau0=tau0,
                         draws=t(jref["pile_draws"]), **RP_THERM)
    assert rel(x, ref[0]) < TOL and rel(p, ref[1]) < TOL


def test_rpmd_run_and_tcf_match_jax(jref):
    rp = trpmd.RPMD(_anharmonic_t, ndim=2, device="cpu", **RP)
    x0, p0 = jref["harm"]
    res = rp.run(t(x0), t(p0), dt=0.02, nt=40, nout=8)
    for k in ("x", "p", "centroid", "energy"):
        assert rel(getattr(res, k), jref["res"][k]) < TOL, k
    np.testing.assert_allclose(res.times, jref["res"]["times"], rtol=1e-15)
    tt, C = rp.position_tcf(t(x0), t(p0), dt=0.02, nt=40, nout=4)
    np.testing.assert_allclose(tt, jref["tcf"][0], rtol=1e-15)
    assert rel(C, jref["tcf"][1]) < TOL


def test_rpmd_harmonic_tcf_and_energy_conservation():
    rp = trpmd.RPMD(lambda x: 0.5 * torch.sum(x ** 2), beta=8.0, nbeads=32,
                    device="cpu")
    x0, p0 = rp.sample_harmonic(0, 2000, 1.0)
    tt, C = rp.position_tcf(x0, p0, dt=0.05, nt=100, nout=4)
    Cex = trpmd.kubo_harmonic_xx(tt, 1.0, 8.0)
    assert np.max(np.abs(C - Cex)) < 0.05 * Cex[0]
    res = rp.run(x0[:8], p0[:8], dt=0.02, nt=200, nout=50)
    e = res.energy.numpy()
    assert np.max(np.abs(e - e[0:1])) / np.mean(np.abs(e[0])) < 1e-3

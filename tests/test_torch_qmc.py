"""Parity of the PyTorch port's qmc/ (pyqed_tpu_torch.qmc: DMC, VMC, PIMC,
BosonPIMC, QSATS, Sobol, the C++ walker engine) with the JAX package, on
the CPU in float64.

The samplers are fed the JAX package's own draws, regenerated here from
the same ``jax.random.split`` chains its ``run`` methods walk (one jit per
sampler, shared through the module fixture ``jref``), and must follow
JAX's chain step for step: energies, walkers and paths within 1e-10
relative, acceptance and resampling decisions exactly. The two C++
engines are built from the same source with the same flags and run in
one process, so they agree exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.qmc import dmc as jdmc
from pyqed_tpu.qmc import engine as jengine
from pyqed_tpu.qmc import pimc as jpimc
from pyqed_tpu.qmc import qsats as jqs
from pyqed_tpu.qmc import sobol as jsobol

import pyqed_tpu_torch as pt
from pyqed_tpu_torch import _native
from pyqed_tpu_torch.qmc import dmc as tdmc
from pyqed_tpu_torch.qmc import engine as tengine
from pyqed_tpu_torch.qmc import pimc as tpimc
from pyqed_tpu_torch.qmc import qsats as tqs
from pyqed_tpu_torch.qmc import sobol as tsobol

TOL = 1e-10
DENSITY = 4.0 / 7.5 ** 3


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


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _small_solid(pkg, lattice="fcc", device="cpu"):
    if lattice == "fcc":
        sites, box = pkg.fcc_lattice((2, 2, 2), DENSITY)
    else:
        sites, box = pkg.hcp_lattice((2, 2, 1), DENSITY)
    kw = dict(device=device) if pkg is tqs else {}
    return pkg.QSATS(sites, box, a=0.06, b=5.0, **kw)


# ------------------------------------------------------ JAX references
DMC_RUN = dict(nwalkers=256, nsteps=24, dt=0.01, eref=1.5, nequil=4)
VMC_RUN = dict(nwalkers=128, nsteps=20, step_size=0.5, nequil=5)
PIMC_RUN = dict(npaths=48, nsweeps=5, ntherm=3, step=0.5)
PIMC_M = 16
BOSON = dict(N=3, M=8, R=16, nd=2)
BOSON_RUN = dict(nreplicas=16, nsweeps=4, ntherm=3, step=0.4)
QS_RUN = dict(nwalkers=6, nsweeps=6, nequil=2, step=0.5)


def _dmc_draws(seed, nw, nd, ns):
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    x0 = jax.random.normal(k0, (nw, nd)) * 0.5

    def one(k):
        k1, k2 = jax.random.split(k)
        return jax.random.normal(k1, (nw, nd)), jax.random.uniform(k2)

    xi, u = jax.vmap(one)(jax.random.split(key, ns))
    return x0, xi, u


def _vmc_draws(seed, nw, nd, ns):
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    x0 = jax.random.normal(k0, (nw, nd))

    def one(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.normal(k1, (nw, nd)),
                jax.random.uniform(k2, (nw,)))

    z, a = jax.vmap(one)(jax.random.split(key, ns))
    return x0, z, a


def _pimc_draws(seed, P, M, nd, ns):
    key, k0 = jax.random.split(jax.random.PRNGKey(seed))
    paths0 = 0.5 * jax.random.normal(k0, (P, M, nd))

    def sweep(key, _):
        out = []
        for shp, shp_a in (((P, M, nd), (P, M)), ((P, M, nd), (P, M)),
                           ((P, 1, nd), (P,))):
            key, k1, k2 = jax.random.split(key, 3)
            out += [jax.random.uniform(k1, shp, minval=-1.0, maxval=1.0),
                    jax.random.uniform(k2, shp_a)]
        return key, tuple(out)

    return paths0, jax.lax.scan(sweep, key, None, length=ns)[1]


def _boson_draws(seed, R, N, M, nd, ns, exchange):
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    x0 = 0.5 * jax.random.normal(k0, (R, N, M, nd))

    def sweep(key, _):
        out = []
        for shp, shp_a in (((R, N, M, nd), (R, N, M)),
                           ((R, N, M, nd), (R, N, M)),
                           ((R, N, 1, nd), (R,))):
            key, k1, k2 = jax.random.split(key, 3)
            out += [jax.random.uniform(k1, shp, minval=-1.0, maxval=1.0),
                    jax.random.uniform(k2, shp_a)]
        if exchange:
            key, k1, k2, k3 = jax.random.split(key, 4)
            out += [jax.random.randint(k1, (R,), 0, N),
                    jax.random.randint(k2, (R,), 0, N),
                    jax.random.uniform(k3, (R,))]
        return key, tuple(out)

    return x0, jax.lax.scan(sweep, key, None, length=ns)[1]


def _qsats_draws(seed, nw, N, P, a, flags, mode):
    key, k0 = jax.random.split(jax.random.PRNGKey(seed))
    q0 = 0.3 * jax.random.normal(k0, (nw, N, 3)) / np.sqrt(4.0 * a)

    def walker(key):
        def body(key, f):
            if mode == "peratom":
                key, kd, ku, _ = jax.random.split(key, 4)
                z = jax.random.normal(kd, (N, 3))
                u = jax.random.uniform(ku, (N,))
            else:
                key, k1, k2 = jax.random.split(key, 3)
                z = jax.random.normal(k1, (N, 3))
                u = jax.random.uniform(k2)
            key2, kp, ku = jax.random.split(key, 3)
            n = jax.random.randint(kp, (), 0, P)
            ue = jax.random.uniform(ku)
            return jnp.where(f, key2, key), (z, u, n, ue)
        return jax.lax.scan(body, key, flags)[1]

    draws = jax.vmap(walker)(jax.random.split(key, nw))
    return q0, tuple(jnp.swapaxes(d, 0, 1) for d in draws)


@pytest.fixture(scope="module")
def jref():
    """Every JAX reference of this file, computed once."""
    out = {}
    pot = lambda x: 0.5 * jnp.sum(x ** 2)                   # noqa: E731
    nd = 3
    out["dmc"] = jdmc.DMC(ndim=nd, potential=pot).run(
        jax.random.PRNGKey(5), **DMC_RUN)
    out["dmc_draws"] = jax.jit(_dmc_draws, static_argnums=(0, 1, 2, 3))(
        5, DMC_RUN["nwalkers"], nd, DMC_RUN["nsteps"])
    imp = jdmc.DMC(ndim=2, local_energy=lambda x: jnp.sum(
        0.5 + 0.1 * x ** 2), drift=lambda x: -x)
    out["dmc_is"] = imp.run(jax.random.PRNGKey(6), **dict(DMC_RUN,
                                                           eref=1.0))
    out["dmc_is_draws"] = _dmc_draws(6, DMC_RUN["nwalkers"], 2,
                                     DMC_RUN["nsteps"])
    lp = lambda a, x: -a * jnp.sum(x ** 2)                  # noqa: E731
    le = lambda a, x: jnp.sum(a - 2 * a ** 2 * x ** 2 + 0.5 * x ** 2)  # noqa
    out["vmc"] = jdmc.VMC(lp, le, ndim=2).run(jax.random.PRNGKey(4), 0.3,
                                              **VMC_RUN)
    out["vmc_draws"] = _vmc_draws(4, VMC_RUN["nwalkers"], 2,
                                  VMC_RUN["nsteps"])
    pimc = jpimc.PIMC(lambda q: 0.5 * jnp.sum(q ** 2) + 0.1 * jnp.sum(
        q ** 4), beta=2.0, nbeads=PIMC_M, ndim=2)
    out["pimc"] = pimc.run(3, **PIMC_RUN)
    out["pimc_draws"] = jax.jit(_pimc_draws, static_argnums=range(5))(
        3, PIMC_RUN["npaths"], PIMC_M, 2,
        PIMC_RUN["ntherm"] + PIMC_RUN["nsweeps"])
    b = BOSON
    for ex in (True, False):
        bos = jpimc.BosonPIMC(lambda q: 0.5 * jnp.sum(q ** 2), b["N"],
                              beta=2.0, nbeads=b["M"], ndim=b["nd"])
        out["boson", ex] = bos.run(7, exchange=ex, **BOSON_RUN)
        out["boson_draws", ex] = jax.jit(
            _boson_draws, static_argnums=range(7))(
            7, b["R"], b["N"], b["M"], b["nd"],
            BOSON_RUN["ntherm"] + BOSON_RUN["nsweeps"], ex)
    sol = _small_solid(jqs)
    P = sol.ipairs.shape[0]
    flags = np.random.default_rng(0).random(QS_RUN["nsweeps"]) < 0.5
    out["qsats_flags"] = flags
    for mode in ("peratom", "allatom"):
        out["qsats", mode] = sol.run(8, mode=mode, exchange_prob=0.5,
                                     **QS_RUN)
        out["qsats_draws", mode] = jax.jit(
            _qsats_draws, static_argnums=(0, 1, 2, 3, 4, 6))(
            8, QS_RUN["nwalkers"], sol.natoms, P, sol.a, jnp.asarray(flags),
            mode)
    return out


# ------------------------------------------------------------ engine
def test_engine_builds_into_the_port_and_equals_jax_engine():
    so = tengine.build()
    assert so.parent == _native.BUILD and so == tengine.library_path()
    assert not (tengine.SRC.parent / "libqmc_engine.so").exists()
    kw = dict(potential="quartic", ndim=2, nwalkers=1024, nsteps=200,
              nequil=50, dt=0.005, p0=0.3, eref0=0.4, seed=99)
    Ej, trj, wj = jengine.dmc_native(**kw)
    Et, trt, wt = tengine.dmc_native(**kw)
    assert Et == Ej
    np.testing.assert_array_equal(trt, trj)
    np.testing.assert_array_equal(wt, wj)
    sol = _small_solid(jqs)
    q = 0.3 * np.random.default_rng(1).normal(size=(5, sol.natoms, 3))
    args = (sol.ipairs, sol.vpvec, sol.a, sol.b, sol.mass)
    for x, y in zip(tengine.qsats_eloc_native(q, *args),
                    jengine.qsats_eloc_native(q, *args)):
        np.testing.assert_array_equal(x, y)
    vkw = dict(nsweeps=12, nequil=4, step=0.5, seed=3)
    for x, y in zip(tengine.qsats_vmc_native(q[0], *args, **vkw),
                    jengine.qsats_vmc_native(q[0], *args, **vkw)):
        np.testing.assert_array_equal(x, y)


def test_engine_build_failure_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native.build(bad, tengine.CXX_FLAGS)


# ---------------------------------------------------------------- DMC
def test_comb_resampling_exact_on_jax_cum_and_pos():
    rng = np.random.default_rng(2)
    for n in (7, 256, 1000):
        w = np.exp(rng.normal(size=n))
        u = float(rng.random())
        cum = jnp.cumsum(jnp.asarray(w) / jnp.sum(jnp.asarray(w)))
        pos = (u + jnp.arange(n)) / n
        ref = np.clip(np.asarray(jnp.searchsorted(cum, pos)), 0, n - 1)
        idx, tpos = tdmc.comb_resample(
            t(cum), torch.tensor(u, dtype=torch.float64), n)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
        np.testing.assert_array_equal(idx.numpy(), ref)


@pytest.mark.parametrize("kind", ["pure", "importance"])
def test_dmc_fed_jax_draws_matches_jax(jref, kind):
    if kind == "pure":
        E, Etr, xf = jref["dmc"]
        x0, xi, u = jref["dmc_draws"]
        sol = tdmc.DMC(ndim=3, potential=lambda x: 0.5 * torch.sum(x ** 2))
        kw = dict(dt=DMC_RUN["dt"], eref=DMC_RUN["eref"])
    else:
        E, Etr, xf = jref["dmc_is"]
        x0, xi, u = jref["dmc_is_draws"]
        sol = tdmc.DMC(ndim=2, local_energy=lambda x: torch.sum(
            0.5 + 0.1 * x ** 2), drift=lambda x: -x)
        kw = dict(dt=DMC_RUN["dt"], eref=1.0)
    Et, xt = sol.walk(t(x0), t(xi), t(u), **kw)
    assert rel(Et, Etr) < TOL
    assert rel(xt, xf) < TOL
    assert abs(float(Et[DMC_RUN["nequil"]:].mean()) - float(E)) \
        < TOL * abs(float(E))


def test_dmc_run_harmonic_ground_state_and_device():
    sol = tdmc.DMC(ndim=3, potential=lambda x: 0.5 * torch.sum(x ** 2))
    E, tr, xf = sol.run(2, nwalkers=2048, nsteps=600, dt=0.01, eref=1.5,
                        nequil=200, device="cpu")
    assert abs(float(E) - 1.5) < 0.05 and tr.shape == (600,)
    assert xf.shape == (2048, 3) and xf.device.type == "cpu"
    # mesh= takes a DeviceMesh (sharded runs: tests/test_torch_distributed.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sol.run(0, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        sol.run_sharded(0, None)


def test_vmc_fed_jax_draws_matches_jax(jref):
    E, Etr, xf = jref["vmc"]
    x0, z, a = jref["vmc_draws"]
    vmc = tdmc.VMC(lambda p, x: -p * torch.sum(x ** 2),
                   lambda p, x: torch.sum(p - 2 * p ** 2 * x ** 2
                                          + 0.5 * x ** 2), ndim=2)
    Et, xt = vmc.walk(0.3, t(x0), t(z), t(a), step_size=0.5)
    assert rel(Et, Etr) < TOL and rel(xt, xf) < TOL
    Er, tr, _ = vmc.run(1, 0.5, nwalkers=256, nsteps=50, nequil=10,
                        device="cpu")
    assert abs(float(Er) - 1.0) < 1e-12      # zero variance at the exact a


# --------------------------------------------------------------- PIMC
def test_pimc_fed_jax_draws_matches_jax(jref):
    ev, et, acc, paths = jref["pimc"]
    paths0, draws = jref["pimc_draws"]
    sol = tpimc.PIMC(lambda q: 0.5 * torch.sum(q ** 2) + 0.1 * torch.sum(
        q ** 4), beta=2.0, nbeads=PIMC_M, ndim=2)
    pf, (evs, ets, accs) = sol.sweeps(t(paths0), [t(d) for d in draws],
                                      step=PIMC_RUN["step"])
    nth = PIMC_RUN["ntherm"]
    assert rel(pf, paths) < TOL
    assert abs(float(evs[nth:].mean()) - ev) < TOL * abs(ev)
    assert abs(float(ets[nth:].mean()) - et) < TOL * abs(et)
    assert float(accs[nth:].mean()) == pytest.approx(acc, abs=1e-15)


def test_pimc_run_thermal_energy():
    beta = 2.0
    sol = tpimc.PIMC(lambda q: 0.5 * q ** 2, beta=beta, nbeads=32)
    ev, et, acc, paths = sol.run(0, npaths=512, nsweeps=300, ntherm=100,
                                 step=0.4, device="cpu")
    exact = 0.5 / np.tanh(beta / 2)
    assert abs(ev - exact) < 0.05 * exact and 0.2 < acc < 0.95
    assert paths.shape == (512, 32, 1)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sol.run(0, mesh=object(), device="cpu")


@pytest.mark.parametrize("exchange", [True, False])
def test_boson_pimc_fed_jax_draws_matches_jax(jref, exchange):
    E, ab, ap, frac = jref["boson", exchange]
    x0, draws = jref["boson_draws", exchange]
    b = BOSON
    sol = tpimc.BosonPIMC(lambda q: 0.5 * torch.sum(q ** 2), b["N"],
                          beta=2.0, nbeads=b["M"], ndim=b["nd"])
    perm0 = torch.arange(b["N"]).repeat(b["R"], 1)
    (x, perm), (Es, abs_, aps) = sol.sweeps(
        t(x0), perm0, [t(d) for d in draws], step=BOSON_RUN["step"],
        exchange=exchange)
    nth = BOSON_RUN["ntherm"]
    assert abs(float(Es[nth:].mean()) - E) < TOL * abs(E)
    assert float(abs_[nth:].mean()) == pytest.approx(ab, abs=1e-15)
    assert float(aps[nth:].mean()) == pytest.approx(ap, abs=1e-15)
    got = float(torch.any(perm != torch.arange(b["N"]), dim=1).double()
                .mean())
    assert got == frac
    Er, abr, apr, fr = sol.run(1, nreplicas=16, nsweeps=5, ntherm=2,
                               exchange=exchange, device="cpu")
    assert np.isfinite(Er) and 0 < abr < 1


# -------------------------------------------------------------- QSATS
def test_qsats_lattices_pairs_and_potential_equal_jax():
    for lat in ("fcc", "hcp"):
        js, ts = _small_solid(jqs, lat), _small_solid(tqs, lat)
        np.testing.assert_array_equal(ts.sites, js.sites)
        np.testing.assert_array_equal(ts.ipairs, js.ipairs)
        np.testing.assert_array_equal(ts.vpvec, js.vpvec)
        assert ts.rnn == js.rnn
    r2 = np.linspace(9.0, 150.0, 301)
    assert rel(tqs.hfdbhe(t(r2)), jqs.hfdbhe(jnp.asarray(r2))) < 1e-13


def test_qsats_local_energy_and_log_psi_match_jax_and_autodiff():
    js, ts = _small_solid(jqs), _small_solid(tqs)
    q = 0.4 * np.random.default_rng(7).normal(size=(4, js.natoms, 3))
    tt, vt = ts.local_energy(t(q))
    for w in range(4):
        tj, vj = js.local_energy(jnp.asarray(q[w]))
        assert abs(float(tt[w]) - float(tj)) <= 1e-12 * abs(float(tj))
        assert abs(float(vt[w]) - float(vj)) <= 1e-12 * abs(float(vj))
        lj = float(js.log_psi(jnp.asarray(q[w])))
        assert abs(float(ts.log_psi(t(q[w]))) - lj) <= 1e-13 * abs(lj)
    # the closed form against torch.func autodiff of log_psi
    x = t(q[0]).reshape(-1)
    lp = lambda y: ts.log_psi(y.reshape(-1, 3))             # noqa: E731
    g = torch.func.grad(lp)(x)
    lap = torch.trace(torch.func.hessian(lp)(x))
    t_ad = -0.5 / ts.mass * (lap + torch.sum(g * g))
    assert abs(float(tt[0] - t_ad)) < 1e-10 * abs(float(t_ad))


@pytest.mark.parametrize("mode", ["peratom", "allatom"])
def test_qsats_fed_jax_draws_matches_jax(jref, mode):
    out = jref["qsats", mode]
    q0, draws = jref["qsats_draws", mode]
    ts = _small_solid(tqs)
    (q, _), e, acc, eacc = ts.sweeps(t(q0), [t(d) for d in draws],
                                     jref["qsats_flags"],
                                     step=QS_RUN["step"], mode=mode)
    assert rel(e, out["e_trace"]) < TOL
    assert rel(q, out["walkers"]) < TOL
    assert float(acc.mean()) == pytest.approx(out["acceptance"], abs=1e-15)
    assert float(eacc.mean(dim=1).sum()) == pytest.approx(
        out["exchange_acceptance"], abs=1e-15)
    # JAX's final walkers carry over as a restart
    r = ts.run(1, nsweeps=3, nequil=1, step=0.1, mode=mode,
               q0=out["walkers"])
    assert r["walkers"].shape == out["walkers"].shape
    assert np.all(np.isfinite(r["e_trace"]))


def test_qsats_run_energy_and_errors():
    ts = _small_solid(tqs)
    out = ts.run(2, nwalkers=16, nsweeps=40, nequil=10, step=0.5,
                 exchange_prob=0.3)
    assert out["e_trace"].shape == (40,) and out["error"] >= 0.0
    assert 0.2 < out["acceptance"] < 0.95
    with pytest.raises(TypeError, match="DeviceMesh"):
        ts.run(0, mesh=object())


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    sites, box = tqs.fcc_lattice((1, 1, 1), DENSITY)
    with pytest.raises(RuntimeError, match="cuda"):
        tqs.QSATS(sites, box)
    with pytest.raises(RuntimeError, match="cuda"):
        tdmc.DMC(ndim=1, potential=lambda x: x.sum()).run(0)
    with pytest.raises(RuntimeError, match="cuda"):
        tpimc.PIMC(lambda q: q.sum(), beta=1.0).run(0)
    with pytest.raises(RuntimeError, match="cuda"):
        tsobol.qmc_integrate(lambda x: x.sum(), [(0, 1)])


# -------------------------------------------------------------- Sobol
def test_sobol_matches_jax():
    np.testing.assert_array_equal(tsobol.sobol_sequence(100, 3, seed=4),
                                  jsobol.sobol_sequence(100, 3, seed=4))
    bounds = [(0.0, 1.0), (-1.0, 2.0)]
    fj = lambda x: jnp.exp(-jnp.sum(x ** 2))                # noqa: E731
    ft = lambda x: torch.exp(-torch.sum(x ** 2))            # noqa: E731
    a = tsobol.qmc_integrate(ft, bounds, n=1024, device="cpu")
    b = jsobol.qmc_integrate(fj, bounds, n=1024)
    assert abs(a - b) < 1e-13 * abs(b)
    assert pt.qmc.build_native_engine is tengine.build

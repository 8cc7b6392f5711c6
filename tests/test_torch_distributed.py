"""The port's distributed runtime and its sharded runs without a
hand-written kernel (pyqed_tpu_torch: ensure_distributed, LDRN and
LDR2Jacobi, FSSH, photon_echo_t2series, DMC, PIMC and QSATS with
``mesh=``) against the JAX package, on the CPU in float64.

Four spawned ranks (``tests/torch_parallel_ranks.py``) form their gloo
group through ``ensure_distributed`` from the ``PYQED_*`` variables, as
``tests/test_distributed.py`` does for JAX, and run every case in one
launch. The samplers are fed the JAX package's own draws, regenerated in
the parent from its ``jax.random`` chains (as ``tests/test_torch_qmc.py``
and ``tests/test_torch_nonadiabatic.py`` do), so their sharded runs are
held to JAX's sharded runs at 1e-10; every sharded run is held to the
port's unsharded one at 1e-12 (its own draws: every rank draws the whole
tensors and keeps its rows). PIMC's independent chains, whose streams
differ from JAX's by construction, are held to JAX's estimators within
five standard errors. JAX is imported inside the fixture only.
"""
import numpy as np
import pytest

import torch_parallel_ranks as R

RESULT_TOL = 1e-10
SELF_TOL = 1e-12

FSSH_RUN = dict(dt=2.0, nt=60, nout=20)
DMC_RUN = dict(nwalkers=256, nsteps=24, dt=0.01, eref=1.5, nequil=4)
PIMC_RUN = dict(npaths=48, nsweeps=5, ntherm=3, step=0.5)
QS_RUN = dict(nwalkers=8, nsweeps=6, nequil=2, step=0.5)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _dmc_sharded_draws(key, nw, nd, ns):
    """The draws JAX's ``DMC.run_sharded(key)`` walks: it splits the key,
    sets a start its ``run`` never reads, and runs ``run`` on the other
    half, whose chain is ``tests/test_torch_qmc.py::_dmc_draws``."""
    import jax
    key, _ = jax.random.split(key)
    key, k0 = jax.random.split(key)
    x0 = jax.random.normal(k0, (nw, nd)) * 0.5

    def one(k):
        k1, k2 = jax.random.split(k)
        return jax.random.normal(k1, (nw, nd)), jax.random.uniform(k2)

    xi, u = jax.vmap(one)(jax.random.split(key, ns))
    return x0, xi, u


def _inputs():
    """The JAX package's draws and the models' arrays, for the ranks."""
    import jax
    import jax.numpy as jnp
    import test_torch_nonadiabatic as tna
    import test_torch_qmc as tq
    from pyqed_tpu.qmc import qsats as jqs
    host = lambda t: tuple(np.asarray(a) for a in t)          # noqa: E731
    x0, p0 = tna.ensemble()
    out = dict(fssh_x0=x0, fssh_p0=p0, fssh_run=FSSH_RUN,
               fssh_draws=tna.jax_uniforms(7, tna.NTRAJ, FSSH_RUN["nt"]),
               dmc_run=DMC_RUN, pimc_run=PIMC_RUN, qsats_run=QS_RUN)
    out["dmc_draws"] = host(jax.jit(_dmc_sharded_draws, static_argnums=(
        1, 2, 3))(jax.random.PRNGKey(5), DMC_RUN["nwalkers"], 3,
                  DMC_RUN["nsteps"]))
    p0_, draws = jax.jit(tq._pimc_draws, static_argnums=range(5))(
        3, PIMC_RUN["npaths"], 16, 2, PIMC_RUN["ntherm"]
        + PIMC_RUN["nsweeps"])
    out["pimc_draws"] = (np.asarray(p0_), host(draws))
    sol = tq._small_solid(jqs)
    flags = np.random.default_rng(0).random(QS_RUN["nsweeps"]) < 0.5
    out["qsats_flags"] = flags
    for mode in ("peratom",):
        q0, d = jax.jit(tq._qsats_draws, static_argnums=(0, 1, 2, 3, 4, 6))(
            8, QS_RUN["nwalkers"], sol.natoms, sol.ipairs.shape[0], sol.a,
            jnp.asarray(flags), mode)
        out["qsats_draws", mode] = (np.asarray(q0), host(d))
    return out


def _jax_references(inputs):
    import jax
    import jax.numpy as jnp
    import test_torch_qmc as tq
    from pyqed_tpu.grid import fssh as jfs
    from pyqed_tpu.grid.ldr import LDR2Jacobi, LDRN
    from pyqed_tpu.models.mol import Mol
    from pyqed_tpu.parallel import make_mesh
    from pyqed_tpu.qmc import dmc as jdmc
    from pyqed_tpu.qmc import pimc as jpimc
    from pyqed_tpu.qmc import qsats as jqs
    from pyqed_tpu.signal.sos import photon_echo_t2series
    ref = {}
    mesh = make_mesh({"row": 8})
    sol, states, psi0 = R.ldr_model(LDRN)
    sol.build_ovlp(jnp.asarray(states))
    for method in ("dense", "factored"):
        ref["ldr", method] = np.asarray(sol.run(
            psi0, mesh=mesh, method=method, **R.LDR_RUN).states)
    j = R.JACOBI_LDR
    t = LDR2Jacobi(j["dom"], [3, 3], nstates=2, mass=j["mass"])
    t.apes, psi0 = R.jacobi_ldr_psi0([np.asarray(x) for x in t.x])
    t.build_ovlp(None)
    ref["ldr", "jacobi"] = np.asarray(t.run(psi0, dt=0.005, nt=20, nout=10,
                                            mesh=mesh).states)
    r = jfs.FSSH(jfs.tully_i(), mass=2000.0).run(
        inputs["fssh_x0"], inputs["fssh_p0"], key=7, mesh=make_mesh(
            {"walker": 8}), **FSSH_RUN)
    ref["fssh"] = {f: np.asarray(getattr(r, f)) for f in (
        "x", "p", "c", "active", "energy", "population", "population_wf")}
    E, dip, t2 = R.sos_model()
    mol = Mol(np.diag(E), dip)
    mol.gamma = np.full(4, 0.02)
    w = np.linspace(0.8, 1.3, 16)
    ref["sos"] = np.asarray(photon_echo_t2series(
        mol, w, w, t2, e_idx=[1, 2], f_idx=[3], mesh=make_mesh({"w": 8})))
    walker = make_mesh({"walker": 8})
    ref["dmc"] = jdmc.DMC(ndim=3, potential=lambda x: 0.5 * jnp.sum(
        x ** 2)).run_sharded(jax.random.PRNGKey(5), walker, **DMC_RUN)
    pot = lambda q: 0.5 * jnp.sum(q ** 2) + 0.1 * jnp.sum(q ** 4)  # noqa
    pimc = jpimc.PIMC(pot, beta=2.0, nbeads=16, ndim=2)
    ref["pimc"] = pimc.run(3, mesh=walker, **PIMC_RUN)
    ref["pimc_chains"] = pimc.run(4, mesh=walker, use_shard_map=True,
                                  **R.PIMC_CHAIN)
    qs = tq._small_solid(jqs)
    for mode in ("peratom",):
        ref["qsats", mode] = qs.run(8, mode=mode, exchange_prob=0.5,
                                    mesh=walker, **QS_RUN)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks start on the cases that need no draws while the parent
    makes JAX's draws, then on the rest while it runs JAX's references."""
    launch = R.Launch("distributed", tmp_path_factory.mktemp("distributed"))
    try:
        inputs = _inputs()
        launch.provide(inputs)
        ref = _jax_references(inputs)
    finally:
        results = launch.wait()
    return results, ref


def case(runs, name):
    return R.case_result(runs[0], name)


# --------------------------------------------------------------- runtime
def test_ensure_distributed_from_environment(runs):
    """Each rank joined through the PYQED_* variables; an all_reduce sees
    all four, a second call is a no-op and global_mesh spans them."""
    for rank, o in enumerate(case(runs, "runtime")):
        assert runs[0][rank]["started"] is True and o["again"] is True
        assert o["info"] == (rank, 4, 1, 4)
        assert o["sum"] == 10.0
        assert o["mesh"] == ((4,), ("data",))
        assert o["env"] == ("4", str(rank))


def test_ensure_distributed_without_configuration_is_a_noop(monkeypatch):
    import torch.distributed as dist
    from pyqed_tpu_torch.parallel import ensure_distributed, process_info
    for var in ("PYQED_COORDINATOR", "PYQED_NUM_PROCS", "PYQED_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert ensure_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert process_info() == (0, 1, 1, 1)
    with pytest.raises(ValueError, match="PYQED_NUM_PROCS"):
        ensure_distributed(coordinator_address="127.0.0.1:1", device="cpu")


# ------------------------------------------------------------------- LDR
@pytest.mark.parametrize("method", ["dense", "factored", "jacobi"])
def test_ldr_sharded_matches_jax_and_unsharded(runs, method):
    """Rows of the 450-row state over 4 ranks (dense: ψ and U by rows, a
    ZGEMV after one all-gather a step); the diabatic Jacobi rows of x."""
    jr = runs[1]["ldr", method]
    for o in case(runs, "ldr"):
        r = o[method]
        assert rel(r["sharded"], jr) < RESULT_TOL
        assert rel(r["sharded"], r["unsharded"]) < SELF_TOL
        if method == "dense":
            nt = R.LDR_RUN["nt"]
            assert r["counts"]["all_gather"] == nt + nt   # steps + windows


# ------------------------------------------------------------------ FSSH
def test_fssh_sharded_fed_jax_draws_matches_jax(runs):
    jr = runs[1]["fssh"]
    for o in case(runs, "fssh"):
        for f, v in o["fed"].items():
            assert rel(v, jr[f]) < RESULT_TOL, f


@pytest.mark.parametrize("ntraj", [32, 30])
def test_fssh_sharded_run_equals_unsharded(runs, ntraj):
    """Own draws (the whole table on every rank, columns kept): the
    sharded run is the unsharded one; 30 trajectories cut 8, 8, 8, 6."""
    for o in case(runs, "fssh"):
        for f, (s, u) in o[ntraj].items():
            assert s.shape[1 if s.ndim > 1 and f not in (
                "population", "population_wf") else 0] == (
                ntraj if f not in ("population", "population_wf")
                else s.shape[0])
            assert rel(s, u) < SELF_TOL, f


# ------------------------------------------------------------------- SOS
@pytest.mark.parametrize("npump", [16, 15])
def test_photon_echo_t2series_sharded(runs, npump):
    for o in case(runs, "sos"):
        s, u = o[npump]
        assert rel(s, u) < SELF_TOL
        if npump == 16:
            assert rel(s, runs[1]["sos"]) < RESULT_TOL


# ------------------------------------------------------------------- DMC
def test_dmc_sharded_fed_jax_draws_matches_jax_run_sharded(runs):
    E, Etr, xf = runs[1]["dmc"]
    for o in case(runs, "dmc"):
        Es, xs, Eu, xu = o["fed"]
        assert rel(Es, np.asarray(Etr)) < RESULT_TOL
        assert rel(xs, np.asarray(xf)) < RESULT_TOL
        assert rel(Es, Eu) < SELF_TOL and rel(xs, xu) < SELF_TOL


def test_dmc_uneven_walkers_and_run_sharded_start(runs):
    """250 walkers cut 63, 63, 63, 61 walk as unsharded; run_sharded
    starts from the walkers it draws (JAX's drops them) and equals the
    unsharded run from that start."""
    for o in case(runs, "dmc"):
        for a, b in zip(o["uneven"][:2], o["uneven"][2:]):
            assert rel(a, b) < SELF_TOL
        trs, xs, trr, xr = o["run_sharded"]
        assert rel(trs, trr) < SELF_TOL and rel(xs, xr) < SELF_TOL


# ------------------------------------------------------------------ PIMC
def test_pimc_sharded_fed_jax_draws_matches_jax(runs):
    ev, et, acc, paths = runs[1]["pimc"]
    nth = PIMC_RUN["ntherm"]
    for o in case(runs, "pimc"):
        pf, (evs, ets, accs), pu, (evu, etu, accu) = o["fed"]
        assert rel(pf, np.asarray(paths)) < RESULT_TOL
        assert abs(evs[nth:].mean() - ev) < RESULT_TOL * abs(ev)
        assert abs(ets[nth:].mean() - et) < RESULT_TOL * abs(et)
        assert accs[nth:].mean() == pytest.approx(acc, abs=1e-15)
        assert rel(pf, pu) < SELF_TOL
        for a, b in ((evs, evu), (ets, etu), (accs, accu)):
            assert rel(a, b) < SELF_TOL


def test_pimc_independent_chains(runs):
    """use_shard_map=True: each rank's chain is the unsharded sweeps of its
    shard on its own generator's draws, exactly; the averaged estimators
    agree with JAX's (other streams) within five standard errors."""
    jev, jet, jacc, _ = runs[1]["pimc_chains"]
    ch = case(runs, "pimc")
    for o in ch:
        c = o["chains"]
        np.testing.assert_array_equal(c["paths"], c["own"])
    ev, et, acc = ch[0]["chains"]["est"]
    trace = ch[0]["chains"]["trace"]
    nth = R.PIMC_CHAIN["ntherm"]
    for mine, theirs, t in ((ev, jev, trace[0]), (et, jet, trace[1])):
        blocks = np.array([b.mean() for b in np.array_split(t, 10)])
        err = blocks.std(ddof=1) / np.sqrt(len(blocks))
        assert abs(mine - float(theirs)) < 5 * np.sqrt(2) * err
    # the rank-averaged trace is the mean of the ranks' own traces
    own = np.mean([o["chains"]["own_trace"][0] for o in ch], axis=0)
    assert rel(trace[0][nth:] if len(trace[0]) > len(own) else trace[0],
               own) < SELF_TOL


# ----------------------------------------------------------------- QSATS
@pytest.mark.parametrize("mode", ["peratom"])
def test_qsats_sharded_fed_jax_draws_matches_jax(runs, mode):
    out = runs[1]["qsats", mode]
    for o in case(runs, "qsats"):
        (q, e, acc, eacc), (qu, eu, accu, eaccu) = o[mode]
        assert rel(e, out["e_trace"]) < RESULT_TOL
        assert rel(q, out["walkers"]) < RESULT_TOL
        assert float(acc.mean()) == pytest.approx(out["acceptance"],
                                                  abs=1e-15)
        assert float(eacc.mean(axis=1).sum()) == pytest.approx(
            out["exchange_acceptance"], abs=1e-15)
        for a, b in ((q, qu), (e, eu), (acc, accu), (eacc, eaccu)):
            assert rel(a, b) < SELF_TOL


def test_qsats_run_sharded_equals_unsharded(runs):
    for o in case(runs, "qsats"):
        rs, ru = o["run"]
        for k in ("e_trace", "walkers"):
            assert rel(rs[k], ru[k]) < SELF_TOL, k
        assert rs["acceptance"] == pytest.approx(ru["acceptance"],
                                                 abs=1e-15)

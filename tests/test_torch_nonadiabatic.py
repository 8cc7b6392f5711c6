"""Parity of the PyTorch port's trajectory and adiabatic-representation
methods (pyqed_tpu_torch: grid/fssh, grid/ehrenfest, grid/namd,
grid/adt, utils/wigner) with the JAX package, on the CPU at complex128.

The same numpy inputs go through both packages. FSSH is fed JAX's own
hop uniforms, regenerated here from the same ``jax.random.split`` chain,
so the ensembles take the same hops: ``active`` must agree exactly and
x, p, |c|^2, the energies and populations within 1e-10 (c itself only up
to a per-column sign: the first eigenvectors' signs are the closed form's
in the port and LAPACK's in JAX). Ehrenfest, NAMD and the ADT are
deterministic: rel 1e-12 (Ehrenfest's chaotic-free short ensemble 1e-10).
The port's own draws cannot reproduce JAX's: ``wigner_sample_harmonic``
is held to its moments. JAX references are computed once per module
(``jref``).
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.grid import adt as jadt
from pyqed_tpu.grid import ehrenfest as jeh
from pyqed_tpu.grid import fssh as jfs
from pyqed_tpu.grid import namd as jnamd

from pyqed_tpu_torch.grid import adt as tadt
from pyqed_tpu_torch.grid import ehrenfest as teh
from pyqed_tpu_torch.grid import fssh as tfs
from pyqed_tpu_torch.grid import namd as tnamd

# the packages export the function ``wigner`` under the module's name
jwig = importlib.import_module("pyqed_tpu.utils.wigner")
twig = importlib.import_module("pyqed_tpu_torch.utils.wigner")

FSSH_RUN = dict(dt=2.0, nt=150, nout=50)
NTRAJ = 32
EH_RUN = dict(dt=4.0, nt=50, nout=25)
NAMD_MODEL = dict(nx=128, mass=1000.0, dt=0.25, nt=200, nout=50)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def rel_err(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def jax_uniforms(key, ntraj, nt):
    """The hop uniforms of pyqed_tpu's FSSH.run(key=key): per-trajectory
    keys split from PRNGKey(key), one split and one uniform per step;
    returned as (nt, ntraj)."""
    keys = jax.random.split(jax.random.PRNGKey(key), ntraj)

    def one(k):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub)
        return jax.lax.scan(body, k, None, length=nt)[1]

    return np.asarray(jax.jit(jax.vmap(one))(keys)).T


def ensemble(ntraj=NTRAJ, seed=3, x0=-1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(x0, 0.5, (ntraj, 1)),
            rng.normal(20.0, 0.5, (ntraj, 1)))


def namd_model(nx):
    """tests/test_namd_adiabatic.py's avoided crossing with its analytic
    diabatic gradient, and a Gaussian on the lower adiabat."""
    x = np.linspace(-12, 12, nx, endpoint=False)
    e1 = 0.01 * np.tanh(x / 2.0)
    c = 0.005 * np.exp(-(x ** 2) / 8.0)
    dpes = np.zeros((nx, 2, 2))
    dpes[:, 0, 0], dpes[:, 1, 1] = e1, -e1
    dpes[:, 0, 1] = dpes[:, 1, 0] = c
    ddpes = np.zeros((nx, 2, 2))
    ddpes[:, 0, 0] = 0.01 / 2.0 / np.cosh(x / 2.0) ** 2
    ddpes[:, 1, 1] = -ddpes[:, 0, 0]
    ddpes[:, 0, 1] = ddpes[:, 1, 0] = -x / 4.0 * c
    psi0 = np.zeros((nx, 2), complex)
    psi0[:, 0] = (1 / np.pi) ** 0.25 * np.exp(-(x + 5.0) ** 2 / 2
                                              + 12j * (x + 5.0))
    return x, dpes, ddpes, psi0


@pytest.fixture(scope="module")
def jref():
    out = {}
    x0, p0 = ensemble()
    for deco in (None, "edc"):
        out["fssh", deco] = jfs.FSSH(jfs.tully_i(), mass=2000.0,
                                     decoherence=deco).run(
            x0, p0, key=7, **FSSH_RUN)
    out["draws"] = jax_uniforms(7, NTRAJ, FSSH_RUN["nt"])
    xe, pe = ensemble(8, seed=5, x0=-1.0)
    ce = np.tile(np.array([1.0, 0.0], complex), (8, 1))
    out["eh"] = jeh.Ehrenfest(jfs.tully_i(), mass=2000.0).run(
        xe, pe, ce, **EH_RUN)
    m = NAMD_MODEL
    x, dpes, ddpes, psi0 = namd_model(m["nx"])
    v, U, nac = jnamd.diabatic_to_adiabatic_1d(x, dpes, ddpes=ddpes)
    out["d2a"] = (v, U, nac)
    for order in (1, 2):
        sol = jnamd.NAMD(x, v, nac, mass=m["mass"], order=order)
        r = sol.run(jnp.asarray(psi0), dt=m["dt"], nt=m["nt"],
                    nout=m["nout"], e_ops=[np.diag([1.0, 0.0]),
                                           np.asarray(nac)])
        out["namd", order] = (sol, r, sol.energy(r.psi))
    return out


# ------------------------------------------------------------------ FSSH
@pytest.mark.parametrize("deco", [None, "edc"])
def test_fssh_fed_jax_draws_matches_jax(jref, deco):
    ref = jref["fssh", deco]
    sol = tfs.FSSH(tfs.tully_i(), mass=2000.0, decoherence=deco,
                   device="cpu")
    state = sol.initial_state(*ensemble())
    r = sol.trajectories(state, torch.as_tensor(jref["draws"]),
                         FSSH_RUN["dt"], FSSH_RUN["nt"], FSSH_RUN["nout"])
    act = np.asarray(ref.active)
    assert np.array_equal(host(r.active), act)
    assert 0 < act[-1].sum() < NTRAJ            # some trajectories hopped
    for name in ("x", "p", "energy", "population", "population_wf"):
        assert np.max(np.abs(host(getattr(r, name))
                             - np.asarray(getattr(ref, name)))) < 1e-10, name
    assert np.max(np.abs(np.abs(host(r.c)) ** 2
                         - np.abs(np.asarray(ref.c)) ** 2)) < 1e-10
    # c up to one sign per trajectory and adiabatic state
    cj, ct = np.asarray(ref.c), host(r.c)
    sgn = np.sign(np.real(np.sum(np.conj(cj) * ct, axis=0)))
    assert np.max(np.abs(ct - sgn[None] * cj)) < 1e-10
    np.testing.assert_allclose(host(r.times), np.asarray(ref.times),
                               rtol=1e-15)


def test_fssh_three_states_two_modes_matches_jax():
    # the batched-eigh branch (three states, sign alignment per column)
    # on the pyrazine model's dpes, evaluated under torch.func
    from pyqed_tpu.models.vibronic import Pyrazine as JPyrazine
    from pyqed_tpu_torch.models.vibronic import Pyrazine
    jm, tm = JPyrazine(), Pyrazine(device="cpu")
    mass = [1.0 / jm.freq_vc, 1.0 / jm.freq_vt]
    rng = np.random.default_rng(4)
    x0 = rng.normal(0.0, 0.7, (8, 2))
    p0 = rng.normal(0.0, 0.7, (8, 2))
    run = dict(dt=10.0, nt=20, nout=10)
    ref = jfs.FSSH(lambda x: jm.dpes(x[0], x[1]), mass=mass, nstates=3,
                   ndim=2).run(x0, p0, active0=2, key=4, **run)
    sol = tfs.FSSH(lambda x: tm.dpes(x[0], x[1]), mass=mass, nstates=3,
                   ndim=2, device="cpu")
    r = sol.trajectories(sol.initial_state(x0, p0, active0=2),
                         torch.as_tensor(jax_uniforms(4, 8, run["nt"])),
                         run["dt"], run["nt"], run["nout"])
    assert np.array_equal(host(r.active), np.asarray(ref.active))
    for name in ("x", "p", "energy", "population_wf"):
        assert rel_err(getattr(r, name), getattr(ref, name)) < 1e-10, name
    assert np.max(np.abs(np.abs(host(r.c)) ** 2
                         - np.abs(np.asarray(ref.c)) ** 2)) < 1e-10


def test_fssh_run_own_draws_conserves():
    sol = tfs.FSSH(tfs.tully_i(), mass=2000.0, device="cpu")
    x0, p0 = ensemble(16)
    kw = dict(dt=2.0, nt=40, nout=20, key=11)
    r = sol.run(x0, p0, **kw)
    e = host(r.energy)
    assert np.max(np.abs(e - e[0:1])) < 1e-4
    assert ((r.c.abs() ** 2).sum(-1) - 1).abs().max() < 1e-10
    draws = sol.draws(11, kw["nt"], 16)
    assert draws.shape == (kw["nt"], 16) and draws.dtype == torch.float64
    assert torch.equal(draws, sol.draws(11, kw["nt"], 16))
    # run() is trajectories() with those draws
    again = sol.trajectories(sol.initial_state(x0, p0), draws, 2.0, 40, 20)
    assert torch.equal(again.active, r.active)


def test_fssh_user_gradient_and_energy_method():
    # the analytic gradient passed as dv gives jacfwd's V and dV
    v = tfs.tully_i()

    def dv(x):
        d = x[0]
        A, B, C, D = 0.01, 1.6, 0.005, 1.0
        d11 = torch.where(d >= 0, A * B * torch.exp(-B * d),
                          A * B * torch.exp(B * d))
        d12 = -2 * C * D * d * torch.exp(-D * d ** 2)
        return torch.stack([torch.stack([d11, d12]),
                            torch.stack([d12, -d11])])[None]

    x0, p0 = ensemble(8)
    X = torch.as_tensor(x0)
    Va, dVa = tfs.batched_potential(v)(X)
    Vb, dVb = tfs.batched_potential(v, dv)(X)
    assert torch.equal(Va, Vb) and (dVa - dVb).abs().max() < 1e-16
    assert dVa.shape == (8, 1, 2, 2)
    sol = tfs.FSSH(v, dv=dv, mass=2000.0, device="cpu")
    E = sol.energy(X, torch.as_tensor(p0), torch.zeros(8, dtype=torch.int64))
    ej = jax.vmap(jfs.FSSH(jfs.tully_i(), mass=2000.0).energy)(
        jnp.asarray(x0), jnp.asarray(p0), jnp.zeros(8, dtype=jnp.int32))
    assert rel_err(E, ej) < 1e-12


def test_fssh_closed_forms_match_eigh_and_expm():
    rng = np.random.default_rng(0)
    V = rng.standard_normal((50, 2, 2))
    V = torch.as_tensor(V + V.transpose(0, 2, 1))
    E, U = tfs.eigh_sym2(V)
    w, _ = torch.linalg.eigh(V)
    assert (E - w).abs().max() < 1e-14
    assert (U @ torch.diag_embed(E) @ U.mT - V).abs().max() < 1e-13
    Hd = torch.as_tensor(rng.standard_normal((50, 2)))
    T = torch.as_tensor(rng.standard_normal((50, 2, 2)))
    T = T - T.mT
    H = torch.diag_embed(Hd).to(torch.complex128) - 1j * T
    ref = torch.linalg.matrix_exp(-0.7j * H)
    assert (tfs.expm_herm_step(Hd, T, 0.7) - ref).abs().max() < 1e-13
    # three states: the eigh branch
    Hd3 = torch.as_tensor(rng.standard_normal((5, 3)))
    T3 = torch.as_tensor(rng.standard_normal((5, 3, 3)))
    T3 = T3 - T3.mT
    H3 = torch.diag_embed(Hd3).to(torch.complex128) - 1j * T3
    assert (tfs.expm_herm_step(Hd3, T3, 0.7)
            - torch.linalg.matrix_exp(-0.7j * H3)).abs().max() < 1e-13


def test_tully_models_match_jax():
    xs = np.array([[-1.3], [0.0], [0.7]])
    for jm, tm in ((jfs.tully_i, tfs.tully_i), (jfs.tully_ii, tfs.tully_ii),
                   (jfs.tully_iii, tfs.tully_iii)):
        a = np.asarray(jax.jit(jax.vmap(jm()))(xs))
        b = host(torch.func.vmap(tm())(torch.as_tensor(xs)))
        assert np.max(np.abs(a - b)) < 1e-15


def test_mesh_and_device_raise():
    sol = tfs.FSSH(tfs.tully_i(), device="cpu")
    # mesh= takes a DeviceMesh (sharded runs: tests/test_torch_distributed.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sol.run(np.zeros((2, 1)), np.ones((2, 1)), mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tfs.FSSH(tfs.tully_i())
        with pytest.raises(RuntimeError):
            tnamd.NAMD(np.arange(4.0), np.zeros((4, 1)), np.zeros((4, 1, 1)))


# ------------------------------------------------------------- Ehrenfest
def test_ehrenfest_matches_jax(jref):
    ref = jref["eh"]
    xe, pe = ensemble(8, seed=5, x0=-1.0)
    ce = np.tile(np.array([1.0, 0.0], complex), (8, 1))
    r = teh.Ehrenfest(tfs.tully_i(), mass=2000.0, device="cpu").run(
        xe, pe, ce, **EH_RUN)
    for name in ("x", "p", "c", "population", "energy"):
        assert rel_err(getattr(r, name), getattr(ref, name)) < 1e-10, name
    e = host(r.energy)
    assert np.max(np.abs(e - e[0:1])) < 1e-5


# ------------------------------------------------------------------ NAMD
def test_diabatic_to_adiabatic_matches_jax(jref):
    x, dpes, ddpes, _ = namd_model(NAMD_MODEL["nx"])
    for got, ref in zip(tnamd.diabatic_to_adiabatic_1d(x, dpes, ddpes=ddpes),
                        jref["d2a"]):
        assert np.max(np.abs(got - ref)) < 1e-13
    got = tnamd.diabatic_to_adiabatic_1d(x, dpes)
    ref = jnamd.diabatic_to_adiabatic_1d(x, dpes)
    assert max(np.max(np.abs(a - b)) for a, b in zip(got, ref)) < 1e-13


@pytest.mark.parametrize("order", [1, 2])
def test_namd_matches_jax(jref, order):
    jsol, ref, e_ref = jref["namd", order]
    m = NAMD_MODEL
    _, _, _, psi0 = namd_model(m["nx"])
    sol = tnamd.NAMD.from_reference(jsol, device="cpu")
    v, _, nac = jref["d2a"]
    r = sol.run(psi0, dt=m["dt"], nt=m["nt"], nout=m["nout"],
                e_ops=[np.diag([1.0, 0.0]), nac])
    assert rel_err(r.states, ref.states) < 1e-12
    assert rel_err(r.observables, ref.observables) < 1e-12
    assert rel_err(sol.population(r.states), jsol.population(ref.states)) \
        < 1e-12
    assert abs(float(sol.energy(r.psi)) - float(e_ref)) < 1e-12 * abs(
        float(e_ref))
    assert rel_err(sol.norm(r.psi), jsol.norm(ref.psi)) < 1e-12
    np.testing.assert_allclose(host(r.times), np.asarray(ref.times))
    own = tnamd.NAMD(jsol.x, v, nac, mass=m["mass"], order=order,
                     device="cpu")
    assert rel_err(own.hpsi(torch.as_tensor(psi0)),
                   jsol.hpsi(jnp.asarray(psi0))) < 1e-12


# ------------------------------------------------------------------- ADT
def test_adt_matches_jax():
    x = np.linspace(-3, 3, 41)
    nac = 0.4 / np.cosh(x) ** 2
    apes = np.stack([-0.1 - 0.02 * x ** 2, 0.1 + 0.03 * x ** 2], -1)
    V, th = tadt.adt_1d(x, apes, nac, theta0=0.2, device="cpu")
    Vj, thj = jax.jit(jadt.adt_1d)(x, apes, nac, 0.2)
    assert rel_err(V, Vj) < 1e-14 and rel_err(th, thj) < 1e-14
    assert torch.equal(tadt.adt_angle(x, nac, 0.2, device="cpu"), th)
    assert tadt.ADT is tadt.adt_1d


# ---------------------------------------------------------------- Wigner
def test_wigner_sample_harmonic_moments():
    x, p = twig.wigner_sample_harmonic(0, 40000, omega=2.0, mass=3.0,
                                       device="cpu")
    assert x.shape == (40000, 1) and x.dtype == torch.float64
    assert abs(float(x.var()) - 1 / 12.0) < 3e-3
    assert abs(float(p.var()) - 3.0) < 0.05
    assert abs(float(x.mean())) < 5e-3 and abs(float(p.mean())) < 0.03
    xT, _ = twig.wigner_sample_harmonic(1, 40000, omega=2.0, mass=3.0,
                                        beta=0.5, x0=1.0, device="cpu")
    assert abs(float(xT.var()) - 1 / np.tanh(0.5) / 12.0) < 5e-3
    assert abs(float(xT.mean()) - 1.0) < 5e-3
    x2, p2 = twig.wigner_sample_harmonic(2, 10, omega=np.array([1.0, 2.0]),
                                         device="cpu")
    assert x2.shape == (10, 2) and p2.shape == (10, 2)
    again = twig.wigner_sample_harmonic(2, 10, omega=np.array([1.0, 2.0]),
                                        device="cpu")
    assert torch.equal(again[0], x2)


def test_wigner_distribution_matches_jax():
    t = np.linspace(0, 20, 64)
    sig = np.exp(-((t - 10) ** 2) / 8) * np.exp(1j * (1.5 * t + 0.05 * t ** 2))
    d = float(t[1] - t[0])
    W, f = twig.wigner(sig, d=d, device="cpu")
    Wj, fj = jax.jit(jwig.wigner, static_argnums=1)(sig, d)
    assert rel_err(W, Wj) < 1e-12
    assert np.allclose(f, np.asarray(fj))
    for alias in (twig.spectrogram, twig.wvd):
        assert torch.equal(alias(sig, d, device="cpu")[0], W)

"""Parity of the PyTorch port's DEOM solver (pyqed_tpu_torch.open.deom)
with the JAX package, on the CPU at complex128: the bath decomposition,
the scaled right-hand side and its transpose, RK4 runs (undriven, driven
system, driven coupling), the dense hierarchy Liouvillian, the resolvent
response map by host eig, and the port's own batched GMRES route against
it.

Inputs are made with numpy from a seed and handed to both packages. The
right-hand side and the dense Liouvillian are held to rel 1e-12, runs to
1e-10, the eig map to rel 1e-8 and the GMRES map to rel 1e-6 of the eig
map (the JAX package's own gate, tests/test_deom.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.open.deom import DEOMBath as JDEOMBath
from pyqed_tpu.open.deom import DEOMSolver as JDEOMSolver

from pyqed_tpu_torch.open.bath import DrudeBath
from pyqed_tpu_torch.open.deom import (Bath, DEOMBath, DEOMSolver,
                                       _apply_action, _gmres)
from pyqed_tpu_torch.open.heom import HEOMSolver

CPU = dict(device="cpu")
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SZ = np.diag([1.0, -1.0])
H_SB = 0.5 * SZ + 0.5 * SX
RHO0 = np.diag([1.0, 0.0]).astype(complex)
BATH = dict(temperature=0.5, cutoff=0.5, reorg=0.05)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def rel_err(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def solvers(lmax=2, npsd=1, coupling=SZ, nmod=1, H=H_SB, **kw):
    """The same spin-boson (or two-bath) DEOM problem in both packages."""
    tb = DEOMBath.drude(**BATH, npsd=npsd, nmod=nmod)
    jb = JDEOMBath.drude(**BATH, npsd=npsd, nmod=nmod)
    return (DEOMSolver(system=H, bath=tb, coupling=coupling, lmax=lmax,
                       **CPU, **kw),
            JDEOMSolver(system=H, bath=jb, coupling=coupling, lmax=lmax,
                        **kw))


def crand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# ----------------------------------------------------------------- bath
@pytest.mark.parametrize("nmod", [1, 2])
@pytest.mark.parametrize("decomposition", ["pade", "matsubara"])
def test_drude_bath_matches_jax(decomposition, nmod):
    kw = dict(BATH, npsd=2, decomposition=decomposition, nmod=nmod)
    b, jb = DEOMBath.drude(**kw), JDEOMBath.drude(**kw)
    for name in ("etal", "etar", "etaa", "expn"):
        a, ja = getattr(b, name), getattr(jb, name)
        assert a.dtype == ja.dtype and a.shape == ja.shape
        assert np.max(np.abs(a - ja)) <= 1e-15 * np.max(np.abs(ja))
    np.testing.assert_array_equal(b.mode, jb.mode)
    assert Bath is DEOMBath


# ---------------------------------------------------------- right-hand side
def _two_bath():
    """Two coupling operators on a 3-level system, nmod = 2."""
    rng = np.random.default_rng(3)
    A = crand(rng, 3, 3)
    H = A + A.conj().T
    Q = np.stack([np.diag([1.0, 0.0, -1.0]), np.diag([0.0, 1.0, 0.5])])
    return dict(H=H, coupling=Q, nmod=2)


@pytest.mark.parametrize("case", ["spin_boson", "two_bath", "driven"])
def test_rhs_matches_jax(case):
    kw = {"spin_boson": {}, "two_bath": _two_bath(),
          "driven": dict(system_dipole=SX, coupling_dipole=0.3 * SX)}[case]
    sol, jsol = solvers(lmax=2, **kw)
    t = 0.0
    if case == "driven":
        t = 0.7
        sol.set_pulse_system_func(lambda t: 0.2 * np.cos(t))
        jsol.set_pulse_system_func(lambda t: 0.2 * jnp.cos(t))
        sol.set_pulse_coupling_func(lambda t: 0.1 * np.sin(t))
        jsol.set_pulse_coupling_func(lambda t: 0.1 * jnp.sin(t))
    rhs, nado, n = sol.rhs_fn()
    jrhs, jnado, jn = jsol.rhs_fn()
    assert (nado, n) == (jnado, jn)
    rng = np.random.default_rng(0)
    ados = crand(rng, nado, n, n)
    out = rhs(torch.as_tensor(ados), t)
    assert rel_err(out, jax.jit(jrhs)(jnp.asarray(ados), t)) <= 1e-12
    # a leading batch dimension advances every hierarchy at once
    batch = np.stack([ados, 2.0 * ados.conj(), crand(rng, nado, n, n)])
    outb = rhs(torch.as_tensor(batch), t)
    for k in range(3):
        assert rel_err(outb[k], rhs(torch.as_tensor(batch[k]), t)) <= 1e-15


def test_transposed_rhs_is_the_plain_transpose():
    """The transposed right-hand side applies Delta^T (no conjugation): on
    a random vector it equals gen_propagator().T @ v, and the forward one
    M @ v."""
    sol, _ = solvers(lmax=3, **_two_bath())
    M = sol.gen_propagator()
    rhs, nado, n = sol.rhs_fn()
    rhs_T, _, _ = sol._rhs(torch.complex128, transpose=True)
    v = crand(np.random.default_rng(1), nado * n * n)
    vt = torch.as_tensor(v).reshape(nado, n, n)
    assert rel_err(rhs_T(vt).reshape(-1), M.T @ torch.as_tensor(v)) <= 1e-12
    assert rel_err(rhs(vt).reshape(-1), M @ torch.as_tensor(v)) <= 1e-12


def test_gen_propagator_matches_jax():
    sol, jsol = solvers(lmax=3, **_two_bath())
    M, jM = sol.gen_propagator(), jsol.gen_propagator()
    assert isinstance(M, torch.Tensor)
    assert rel_err(M, jM) <= 1e-12
    assert (sol._nado, sol._n) == (jsol._nado, jsol._n)


# ------------------------------------------------------------------ run
def _pulse_np(t):
    return 0.2 * np.exp(-((t - 2.0) ** 2) / 0.5) * np.cos(t)


def _pulse_jnp(t):
    return 0.2 * jnp.exp(-((t - 2.0) ** 2) / 0.5) * jnp.cos(t)


@pytest.mark.parametrize("case", ["undriven", "driven_system",
                                  "driven_coupling"])
def test_run_matches_jax(case):
    sol, jsol = solvers(lmax=3, npsd=1)
    if case == "driven_system":
        for s, f in ((sol, _pulse_np), (jsol, _pulse_jnp)):
            s.set_system(0.5 * SZ)
            s.set_system_dipole(-SX)
            s.set_pulse_system_func(f)
    elif case == "driven_coupling":
        sol.set_coupling_dipole(SX)
        jsol.set_coupling_dipole(SX)
        sol.set_pulse_coupling_func(lambda t: 0.3 * np.sin(t))
        jsol.set_pulse_coupling_func(lambda t: 0.3 * jnp.sin(t))
    kw = dict(dt=0.01, nt=300, nout=30)
    res = sol.run(RHO0, p1=SZ, **kw)
    jres = jsol.run(jnp.asarray(RHO0), p1=jnp.asarray(SZ, dtype=complex),
                    **kw)
    for name in ("times", "observables", "states", "rho0", "rho", "ado"):
        a, b = getattr(res, name), np.asarray(getattr(jres, name))
        assert a.shape == b.shape, name
        assert np.max(np.abs(a.numpy() - b)) <= 1e-10, name
    assert (res.dt, res.nt, res.nout) == (jres.dt, jres.nt, jres.nout)
    if case == "undriven":
        # without p1 the observable is the trace
        tr = sol.run(RHO0, **kw).observables[:, 0]
        assert torch.max(torch.abs(tr - 1.0)) <= 1e-12


def test_rho0_matches_unscaled_heom():
    """The scaled (DEOM) and unscaled (HEOM) hierarchies are related by an
    invertible ADO rescaling, and RK4 commutes with it: rho_0(t) agrees
    (the identity of tests/test_deom.py, port against port)."""
    sol, _ = solvers(lmax=4, npsd=2)
    res = sol.run(RHO0, dt=0.01, nt=300, nout=30, p1=SZ)
    bath = DrudeBath(**BATH)
    bath.set_bath_ops([SZ])
    heom = HEOMSolver(H_SB.astype(complex), bath=bath, lmax=4,
                      decomposition="pade", nexp=2, **CPU)
    res2 = heom.run(RHO0, dt=0.01, nt=300, nout=30,
                    e_ops=[SZ.astype(complex)])
    assert torch.max(torch.abs(res.observables - res2.observables)) <= 1e-12
    assert torch.max(torch.abs(res.states - res2.states)) <= 1e-12


# --------------------------------------------------------- response maps
WX = np.linspace(-2, 2, 5) + 0.13
WY = np.linspace(-2, 2, 4) + 0.07


MAP_OPS = (SX, SZ + 0.3 * SX, SX, SX)
MAP_LCR = ("llll", "crll")


@pytest.fixture(scope="module")
def jax_maps():
    """The JAX eig maps of both lcr cases, traced once (the host eig runs
    while tracing)."""
    _, jsol = solvers(lmax=2)

    def maps(wx, wy):
        return [jsol.correlation_4op_3t(*MAP_OPS, jnp.asarray(RHO0), 0.7, wx,
                                        wy, lcr=lcr) for lcr in MAP_LCR]
    return [np.asarray(S) for S in jax.jit(maps)(jnp.asarray(WX),
                                                  jnp.asarray(WY))]


@pytest.mark.parametrize("k", range(len(MAP_LCR)))
def test_correlation_4op_3t_matches_jax(k, jax_maps):
    sol, _ = solvers(lmax=2)
    S = sol.correlation_4op_3t(*MAP_OPS, RHO0, 0.7, WX, WY, lcr=MAP_LCR[k])
    assert S.shape == (len(WX), len(WY))
    assert rel_err(S, jax_maps[k]) <= 1e-8


def _gmres_problem():
    bath = DEOMBath.drude(temperature=1.0, cutoff=0.5, reorg=0.05, npsd=1)
    H = np.array([[0.5, 0.1], [0.1, -0.5]])
    Q = np.array([[[1.0, 0], [0, -1.0]]])
    return DEOMSolver(system=H, bath=bath, coupling=Q, lmax=3, **CPU)


@pytest.mark.parametrize("lcr", ["llll", "rcll"])
def test_gmres_map_matches_eig_map(lcr):
    """The spin-boson of tests/test_deom.py (TestDEOMGmres): the
    matrix-free map against the host-eig map."""
    sol = _gmres_problem()
    ops = (SX, SX, SX + 0.2 * SZ, SX)
    wx = np.linspace(0.6, 1.5, 4)
    wy = np.linspace(-1.5, -0.6, 3)
    S_eig = sol.correlation_4op_3t(*ops, RHO0.real, 2.0, wx, wy, lcr=lcr)
    S_gm = sol.correlation_4op_3t_gmres(*ops, RHO0.real, 2.0, wx, wy,
                                        lcr=lcr, nt_T=400)
    assert rel_err(S_gm, S_eig) <= 1e-6
    st = sol.gmres_stats
    for side, w in (("y", wy), ("x", wx)):
        assert st[f"restarts_{side}"].shape == (len(w),)
        assert bool((st[f"restarts_{side}"] >= 1).all())
        assert bool((st[f"residual_{side}"] <= 1e-8).all())


def test_gmres_raises_without_convergence():
    sol = _gmres_problem()
    with pytest.raises(RuntimeError, match="did not converge"):
        sol.correlation_4op_3t_gmres(SX, SX, SX, SX, RHO0, 2.0, [0.7],
                                     [-0.7], tol=1e-15, maxiter=1)


def test_gmres_helper_solves_each_system():
    rng = np.random.default_rng(7)
    N, B = 60, 3
    A = np.eye(N) * 4.0 + crand(rng, N, N) / np.sqrt(N)
    shifts = np.array([0.0, 0.5, -1.0j])
    b = crand(rng, B, N)
    At = torch.as_tensor(A)
    st = torch.as_tensor(shifts)

    def op(v):
        return v @ At.T + st[:, None] * v

    x, restarts, rel = _gmres(op, torch.as_tensor(b), 1e-12, 50)
    for i in range(B):
        ref = np.linalg.solve(A + shifts[i] * np.eye(N), b[i])
        assert rel_err(x[i], ref) <= 1e-10
    assert bool((rel <= 1e-12).all()) and bool((restarts >= 1).all())
    # a zero right-hand side is solved by x = 0 without a restart
    x0, r0, _ = _gmres(op, torch.zeros((1, N), dtype=torch.complex128),
                       1e-12, 5)
    assert int(r0[0]) == 0 and bool((x0 == 0).all())


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("lcr", ["l", "r", "c"])
def test_block_actions_match_dense(lcr, transpose):
    rng = np.random.default_rng(4)
    nado, n = 5, 3
    op = torch.as_tensor(crand(rng, n, n))
    X = torch.as_tensor(crand(rng, 2, nado, n, n))
    dense = DEOMSolver._action(op, nado, lcr)
    assert dense.shape == (nado * n * n,) * 2
    if transpose:
        dense = dense.T
    out = _apply_action(op, X, lcr, transpose=transpose).reshape(2, -1)
    ref = X.reshape(2, -1) @ dense.T
    assert rel_err(out, ref) <= 1e-15


def test_deom_device_none_without_card_raises():
    if torch.cuda.is_available():
        return          # device=None runs on the card there
    with pytest.raises(RuntimeError, match="is_available"):
        DEOMSolver(system=H_SB, bath=DEOMBath.drude(**BATH), coupling=SZ,
                   lmax=1)

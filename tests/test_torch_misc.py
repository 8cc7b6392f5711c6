"""Parity of the PyTorch port's small modules with the JAX package, on the
CPU in float64: ml/nn (MLP), ops/ode (RKF45), ops/fft, ops/jointdiag,
ops/quadrature, utils/noise, utils/qip, utils/nonherm, the rest of
core/diagnostics and units.AtomicUnits.

Inputs are NumPy arrays from seeds, handed to both packages. ``cnoise``
and ``init_params`` are fed the JAX package's own draws, regenerated from
its ``jax.random`` chains. Tolerances: closed forms and one-shot products
1e-12 relative; the MLP forward pass 1e-12 and its 50-epoch Adam fit
1e-10; RKF45's final t and y 1e-12 with its accepted and rejected step
counts equal; cnoise 1e-12.
"""
import importlib
import json
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu import units as junits
from pyqed_tpu.ml import nn as jnn
from pyqed_tpu.ops import fft as jfft
from pyqed_tpu.ops import jointdiag as jjd
from pyqed_tpu.ops import ode as jode
from pyqed_tpu.utils import noise as jnoise
from pyqed_tpu.utils import nonherm as jnh
from pyqed_tpu.utils import qip as jqip

import pyqed_tpu_torch as pt
from pyqed_tpu_torch.core import diagnostics as tdiag
from pyqed_tpu_torch.ml import nn as tnn
from pyqed_tpu_torch.ops import fft as tfft
from pyqed_tpu_torch.ops import jointdiag as tjd
from pyqed_tpu_torch.ops import ode as tode
from pyqed_tpu_torch.utils import noise as tnoise
from pyqed_tpu_torch.utils import nonherm as tnh
from pyqed_tpu_torch.utils import qip as tqip

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _quadrature_modules():
    """Both ``ops/quadrature.py`` modules. On either package the name
    ``ops.quadrature`` is the quadrature operator; importing the module by
    its path rebinds it, so the operators are put back."""
    ops = {p: importlib.import_module(p + ".ops")
           for p in ("pyqed_tpu", "pyqed_tpu_torch")}
    keep = {p: m.quadrature for p, m in ops.items()}
    mods = [importlib.import_module(p + ".ops.quadrature") for p in ops]
    for p, m in ops.items():
        m.quadrature = keep[p]
    return mods


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def rel(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def t(a):
    return torch.as_tensor(np.array(a))


# ------------------------------------------------------------------ ml
DIMS = [2, 16, 16, 1]


def _pes_data():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, size=(64, 2))
    y = (np.sin(x[:, :1]) * np.cos(x[:, 1:]) + 0.1 * x[:, :1] ** 2)
    return x, y


@pytest.fixture(scope="module")
def mlp_ref():
    x, y = _pes_data()
    m = jnn.MLP(DIMS, key=jax.random.PRNGKey(1))
    p0 = [tuple(np.asarray(a) for a in layer) for layer in m.params]
    pred0 = np.asarray(m.predict(x))
    m.fit(x, y, lr=5e-3, epochs=50)
    return dict(p0=p0, pred0=pred0, loss=m.loss_,
                p=[tuple(np.asarray(a) for a in layer) for layer in m.params],
                pred=np.asarray(m.predict(x)))


def test_mlp_forward_and_fit_match_jax(mlp_ref):
    x, y = _pes_data()
    m = tnn.MLP(DIMS, device="cpu")
    m.params = tnn.params_from_numpy(mlp_ref["p0"], "cpu")
    assert rel(m.predict(x), mlp_ref["pred0"]) < RTOL
    m.fit(x, y, lr=5e-3, epochs=50)
    assert abs(m.loss_ - mlp_ref["loss"]) < 1e-10 * mlp_ref["loss"]
    for lt, lj in zip(m.params, mlp_ref["p"]):
        for a, b in zip(lt, lj):
            assert rel(a, b) < 1e-10
    assert rel(m.predict(x), mlp_ref["pred"]) < 1e-10
    assert pt.ml.MLP is tnn.NeuralNetwork


def test_init_params_fed_jax_draws_and_mse():
    key = jax.random.PRNGKey(3)
    ref = jnn.init_params(key, DIMS)
    normals = [np.asarray(jax.random.normal(k, (a, b))) for k, (a, b) in
               zip(jax.random.split(key, len(DIMS) - 1),
                   zip(DIMS[:-1], DIMS[1:]))]
    got = tnn.init_params(0, DIMS, device="cpu", normals=normals)
    for lt, lj in zip(got, ref):
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(host(a), np.asarray(b))
    x, y = _pes_data()
    assert abs(float(tnn.mse(got, t(x), t(y)))
               - float(jnn.mse(ref, jnp.asarray(x), jnp.asarray(y)))) \
        < RTOL * float(jnn.mse(ref, jnp.asarray(x), jnp.asarray(y)))
    own = tnn.init_params(5, DIMS, device="cpu")
    assert [tuple(a.shape) for a, _ in own] == [(2, 16), (16, 16), (16, 1)]


# ---------------------------------------------------------------- ode
def _vdp_j(t_, y):
    return jnp.array([y[1], 2.0 * (1 - y[0] ** 2) * y[1] - y[0]])


def _vdp_t(t_, y):
    return torch.stack([y[1], 2.0 * (1 - y[0] ** 2) * y[1] - y[0]])


@pytest.mark.parametrize("case", ["vdp", "complex"])
def test_rkf45_matches_jax_steps_and_solution(case):
    if case == "vdp":
        fj, ft, y0, span = _vdp_j, _vdp_t, np.array([2.0, 0.0]), (0.0, 3.0)
    else:
        A = np.array([[-0.1 + 1.0j, 0.3], [0.2j, -0.5 - 0.4j]])
        Aj, At = jnp.asarray(A), t(A)
        fj = lambda s, y: Aj @ y * (1.0 + 0.5 * jnp.sin(s))   # noqa: E731
        ft = lambda s, y: At @ y * (1.0 + 0.5 * math.sin(s))  # noqa: E731
        y0, span = np.array([1.0 + 0j, 0.5j]), (0.0, 4.0)
    yj, sj = jode.rkf45(fj, jnp.asarray(y0), *span, rtol=1e-8, atol=1e-10)
    yt, st = tode.rkf45(ft, t(y0), *span, rtol=1e-8, atol=1e-10)
    assert st["naccept"] == int(sj["naccept"]) > 5
    assert st["nreject"] == int(sj["nreject"])
    assert abs(st["t"] - span[1]) <= 1e-12 * span[1]
    # the last step size follows the error estimate y5 - y4, a difference
    # of nearly equal numbers that carries their rounding: 1e-6
    assert abs(st["h_final"] - float(sj["h_final"])) \
        <= 1e-6 * abs(float(sj["h_final"]))
    assert rel(yt, yj) < RTOL


def test_rkf45_sample_matches_jax():
    ts = np.linspace(0.0, 2.0, 5)
    yj = jode.rkf45_sample(_vdp_j, jnp.array([2.0, 0.0]), ts, rtol=1e-8)
    yt = tode.rkf45_sample(_vdp_t, t([2.0, 0.0]), ts, rtol=1e-8)
    assert rel(yt, yj) < RTOL


# ---------------------------------------------------------------- fft
def test_fft_family_matches_jax():
    rng = np.random.default_rng(2)
    x = np.linspace(-5.0, 5.0, 64, endpoint=False)
    f = np.exp(-x ** 2) * (1 + 0.3j * np.sin(x))
    for fn in ("fft", "ifft"):
        gj, wj = getattr(jfft, fn)(jnp.asarray(f), jnp.asarray(x))
        gt, wt = getattr(tfft, fn)(t(f), t(x))
        assert rel(gt, gj) < RTOL and rel(wt, wj) < RTOL
    a = rng.normal(size=(3, 16)) + 1j * rng.normal(size=(3, 16))
    gj, _ = jfft.fft(jnp.asarray(a), axis=0)
    gt, _ = tfft.fft(t(a), axis=0)
    assert rel(gt, gj) < RTOL
    F = rng.normal(size=(12, 10))
    for a, b in zip(tfft.fft2(t(F), 0.1, 0.2), jfft.fft2(jnp.asarray(F),
                                                         0.1, 0.2)):
        assert rel(a, b) < RTOL
    k = np.linspace(-2, 2, 7)
    assert rel(tfft.dft(t(x), t(f), t(k)),
               jfft.dft(jnp.asarray(x), jnp.asarray(f), jnp.asarray(k))) \
        < RTOL
    y = np.linspace(-3, 3, 10)
    G = rng.normal(size=(10, 64)) + 0j
    assert rel(tfft.dft2(t(x), t(y), t(G), t(k), t(k[:3])),
               jfft.dft2(jnp.asarray(x), jnp.asarray(y), jnp.asarray(G),
                         jnp.asarray(k), jnp.asarray(k[:3]))) < RTOL


# ---------------------------------------------------------- jointdiag
def test_joint_diagonalize_matches_jax():
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    Ms = np.stack([Q @ np.diag(rng.normal(size=6)) @ Q.T
                   + 1e-3 * (lambda B: B + B.T)(rng.normal(size=(6, 6)))
                   for _ in range(3)])
    Vj, Dj = jjd.joint_diagonalize(Ms)
    Vt, Dt = tjd.joint_diagonalize(t(Ms))
    assert isinstance(Vt, torch.Tensor)
    np.testing.assert_array_equal(host(Vt), np.asarray(Vj))
    np.testing.assert_array_equal(host(Dt), np.asarray(Dj))
    assert pt.qndiag is tjd.joint_diagonalize


# --------------------------------------------------------- quadrature
def test_quadrature_module_matches_jax():
    jquad, tquad = _quadrature_modules()
    for fn, args in (("gauss_hermite", (7, 0.3, 2.0)),
                     ("gauss_hermite_normalized", (5, -0.2, 1.5)),
                     ("gauss_legendre", (6, 0.0, 3.0))):
        for a, b in zip(getattr(tquad, fn)(*args), getattr(jquad, fn)(*args)):
            np.testing.assert_array_equal(a, b)
    assert tquad.multichoose(4, 3) == jquad.multichoose(4, 3)
    for tr in ("total", "local"):
        np.testing.assert_array_equal(tquad.fock_enumerate(3, 2, tr),
                                      jquad.fock_enumerate(3, 2, tr))
    assert tquad.fock_index(tquad.fock_enumerate(2, 2)) == \
        jquad.fock_index(jquad.fock_enumerate(2, 2))
    a = np.random.default_rng(5).normal(size=(2, 3, 3)) * (1 + 1j)
    np.testing.assert_array_equal(host(tquad.dagger(t(a))),
                                  np.asarray(jquad.dagger(jnp.asarray(a))))
    assert tquad.delta(2, 2) == 1.0 and tquad.delta(1, 2) == 0.0
    # ops.quadrature is the quadrature operator, as in the JAX package
    np.testing.assert_array_equal(host(pt.ops.quadrature(4)),
                                  host(pt.ops.operators.quadrature(4)))


# -------------------------------------------------------------- noise
def test_cnoise_fed_jax_draws_matches_jax():
    key = jax.random.PRNGKey(9)
    nstep, nsample = 40, 16
    ref = jnoise.cnoise(key, nstep, nsample, dt=0.001, tau=0.003, ave=0.1)
    k, k0 = jax.random.split(key)
    z0 = jax.random.normal(k0, (nsample,))
    a = jax.vmap(lambda kk: jax.random.uniform(
        kk, (2, nsample), minval=1e-12, maxval=1.0))(
        jax.random.split(k, nstep - 1))
    got = tnoise.cnoise(0, nstep, nsample, dt=0.001, tau=0.003, ave=0.1,
                        device="cpu", draws=(z0, a))
    assert rel(got, ref) < RTOL
    for lag in (None, 5):
        assert rel(tnoise.autocorrelation(got, lag),
                   jnoise.autocorrelation(ref, lag)) < RTOL
        assert rel(tnoise.cross_correlation(got, got.flip(1), lag),
                   jnoise.cross_correlation(ref, ref[:, ::-1], lag)) < RTOL
    own = tnoise.cnoise(1, 400, 256, device="cpu")
    c = tnoise.autocorrelation(own, 4)
    assert abs(float(c[0]) / (0.0025 / 0.0025) - 1.0) < 0.05
    assert pt.utils.cnoise is tnoise.cnoise


# ---------------------------------------------------------------- qip
def _states():
    rng = np.random.default_rng(6)
    psi = rng.normal(size=8) + 1j * rng.normal(size=8)
    psi /= np.linalg.norm(psi)
    A = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    rho = A @ A.conj().T
    rho /= np.trace(rho)
    B = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    sig = B @ B.conj().T
    sig /= np.trace(sig)
    return psi, rho, sig


def test_qip_matches_jax():
    psi, rho, sig = _states()
    pairs = [
        (lambda m, s: m.reduce_dm(s, [0, 2]), psi),
        (lambda m, s: m.reduce_dm(s, [1], dims=[2, 2]), rho),
        (lambda m, s: m.vn_entropy(s, [1]), psi),
        (lambda m, s: m.vn_entropy(s, base=2), rho),
        (lambda m, s: m.mutual_info(s, [0], [2]), psi),
        (lambda m, s: m.purity(s), rho),
        (lambda m, s: m.concurrence(s), rho),
    ]
    for f, s in pairs:
        assert rel(f(tqip, t(s)), f(jqip, jnp.asarray(s))) < RTOL
    for fn in ("tracedist", "hilbert_dist", "fidelity"):
        a = getattr(tqip, fn)(t(rho), t(sig))
        b = getattr(jqip, fn)(jnp.asarray(rho), jnp.asarray(sig))
        assert rel(a, b) < 1e-10
    np.testing.assert_array_equal(host(tqip.hadamard()),
                                  np.asarray(jqip.hadamard()))


# ------------------------------------------------------------ nonherm
def test_nonherm_matches_jax():
    rng = np.random.default_rng(7)
    H = np.diag([0.0, 1.0, 1.3]) + 0.1 * rng.normal(size=(3, 3)) \
        - 0.05j * np.diag([0.0, 1.0, 2.0])
    for a, b in zip(tnh.eig(t(H), norm=True), jnh.eig(H, norm=True)):
        np.testing.assert_array_equal(host(a), np.asarray(b))
    V = rng.normal(size=(5, 3, 3))
    Vh = V + np.swapaxes(V, -1, -2)
    wt, ut = tnh.diabatic_to_adiabatic(t(Vh))
    wj, uj = jnh.diabatic_to_adiabatic(Vh)
    assert rel(wt, wj) < RTOL
    # eigenvectors up to a sign per column
    assert rel(torch.abs(torch.einsum("pij, pik -> pjk", ut, t(np.asarray(
        uj)))).diagonal(dim1=-2, dim2=-1), np.ones((5, 3))) < 1e-12
    Vc = Vh + 0.1j * rng.normal(size=(5, 3, 3))
    for a, b in zip(tnh.diabatic_to_adiabatic(Vc),
                    jnh.diabatic_to_adiabatic(Vc)):
        np.testing.assert_array_equal(host(a), np.asarray(b))
    ev, U1, U2 = jnh.eig(H)
    dip = np.asarray(ev).real * 0.0 + np.array([0.1, 0.7, 0.2])
    om = np.linspace(-0.5, 2.5, 50)
    assert rel(tnh.linear_absorption(om, evals=t(ev), dip=t(dip)),
               jnh.linear_absorption(om, evals=ev, dip=dip)) < RTOL


# -------------------------------------------------------- diagnostics
def test_diagnostics(tmp_path):
    logdir = tmp_path / "trace"
    with tdiag.trace(str(logdir)) as prof:
        torch.ones(8) @ torch.ones(8)
    with open(logdir / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert any("aten::dot" in e.key for e in prof.key_averages())
    sol = pt.HEOMSolver(np.diag([0.0, 0.2]), bath=[
        (np.diag([1.0, 0.0]), 0.02, 0.5)], lmax=1, kernel="cuda",
        device="cpu")
    with tdiag.trace(str(logdir)):
        sol.run(np.diag([1.0, 0.0]), dt=0.05, nt=2, nout=1)
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (run,) = [e for e in events if e.get("name") == "heom.run"]
    assert run["ph"] == "X" and run["dur"] > 0 and run["args"]["nado"] == 2
    # the span lies on the profiler's clock: it covers the run's aten ops
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("name", "").startswith("aten::einsum")]
    assert ops and all(run["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= run["ts"] + run["dur"] for e in ops)
    # each counter rises from 0 to its change over the block: one plan;
    # on CPU tensors the coupling's plain version launches nothing
    counts = {}
    for e in events:
        if e.get("ph") == "C":
            counts.setdefault(e["name"], []).append(e["args"]["value"])
    assert counts["heom_coupling_plan.builds"] == [0, 1]
    assert counts["heom_coupling.launches"] == [0, 0]
    assert counts["heom_coupling.launch_arg_builds"] == [0, 0]
    assert not tdiag.spans_enabled()
    good = {"a": torch.ones(3), "b": [np.zeros(2), (torch.zeros(1),)]}
    assert tdiag.check_finite(good) is good
    with pytest.raises(FloatingPointError, match="non-finite"):
        tdiag.check_finite([torch.ones(2), torch.tensor([1.0, np.inf])])
    with pytest.raises(FloatingPointError, match="aten.log"):
        with tdiag.debug_nans():
            torch.log(torch.tensor([-1.0, 2.0]))
    with tdiag.debug_nans(False):
        torch.log(torch.tensor([-1.0]))
    with tdiag.debug_nans():
        torch.sqrt(torch.tensor([4.0]))
    assert os.path.isdir(logdir)


def test_atomic_units_match_jax():
    a, b = pt.AtomicUnits(), junits.AtomicUnits()
    assert vars(a) == vars(b)

"""Parity of the PyTorch port's split-operator slice (pyqed_tpu_torch.grid,
ops/kernels.py SPO wrappers, ops/wavepacket, ops/math, core/diagnostics)
with the JAX package (pyqed_tpu), on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
results are compared as numpy arrays. The kernel-level gate is 1e-12 at
complex128 and rel 1e-5 at complex64 (the JAX Pallas kernels run in
interpret mode); propagations are held to 1e-10 on every compared field.
The CUDA kernels run only on a GPU (chip_smoke.py); here their wrappers
take the plain versions because the tensors lie on the CPU.
"""
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyqed_tpu.grid.spo as J
from pyqed_tpu.core import diagnostics as j_diag
from pyqed_tpu.ops import math as j_math
from pyqed_tpu.ops import pallas_kernels as pk
from pyqed_tpu.ops import wavepacket as j_wp

import pyqed_tpu_torch as pt
from pyqed_tpu_torch.core import diagnostics as t_diag
from pyqed_tpu_torch.grid import spo as T
from pyqed_tpu_torch.ops import _cuda_lib
from pyqed_tpu_torch.ops import kernels as kn
from pyqed_tpu_torch.ops import math as t_math
from pyqed_tpu_torch.ops import wavepacket as t_wp

KTOL = {torch.complex128: 1e-12, torch.complex64: 1e-5}
TOL = 1e-10          # propagated fields


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def crand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def maxdiff(a, b):
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ---------------------------------------------------------- kernel level
NPDT = {torch.complex128: np.complex128, torch.complex64: np.complex64}
# shapes of tests/test_pallas.py:274-292
SHAPES = {"phase": (33, 17), "potential": (21, 13)}


def kernel_inputs(kind, ns, dtype, seed=7):
    rng = np.random.default_rng(seed)
    shape = SHAPES[kind]
    psi = crand(rng, *shape, ns).astype(NPDT[dtype])
    if kind == "phase":
        op = np.exp(-1j * rng.standard_normal(shape)).astype(NPDT[dtype])
    else:
        op = crand(rng, *shape, ns, ns).astype(NPDT[dtype])
    return op, psi


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("ns", [2, 3])
@pytest.mark.parametrize("kind", ["phase", "potential"])
def test_kernel_wrappers_match_pallas_interpret(kind, ns, dtype):
    op, psi = kernel_inputs(kind, ns, dtype)
    jfn = pk.spo_phase_multiply if kind == "phase" else pk.spo_potential_apply
    tfn = kn.spo_phase_multiply if kind == "phase" else kn.spo_potential_apply
    ref = np.asarray(jfn(jnp.asarray(op), jnp.asarray(psi), interpret=True))
    kn.spo_phase_multiply.launches = kn.spo_potential_apply.launches = 0
    out = tfn(torch.as_tensor(op), torch.as_tensor(psi))
    assert out.dtype == dtype
    assert rel_err(out.numpy(), ref) < KTOL[dtype]
    assert kn.spo_phase_multiply.launches == 0
    assert kn.spo_potential_apply.launches == 0


@pytest.mark.parametrize("kind", ["phase", "potential"])
def test_kernel_wrappers_take_the_fft_layout(kind):
    """A states-first tensor (what a batched FFT over the grid axes
    returns) gives the values of the states-last one (to rounding: the
    CPU vectorizes the two layouts differently)."""
    op, psi = kernel_inputs(kind, 2, torch.complex128)
    tfn = kn.spo_phase_multiply if kind == "phase" else kn.spo_potential_apply
    last = torch.as_tensor(psi)
    first = last.movedim(-1, 0).contiguous().movedim(0, -1)
    assert not first.is_contiguous()
    assert kn._spo_layout("t", last)[2:] == (2, 1)
    npts = int(np.prod(psi.shape[:-1]))
    assert kn._spo_layout("t", first)[2:] == (1, npts)
    fft = torch.fft.fftn(last, dim=(0, 1))
    kn._spo_layout("t", fft)            # the FFT's layout is accepted
    a = tfn(torch.as_tensor(op), last)
    b = tfn(torch.as_tensor(op), first)
    assert maxdiff(a, b.numpy()) < 1e-14


def _bad_args(case):
    op, psi = (torch.as_tensor(a) for a in kernel_inputs("potential", 2,
                                                          torch.complex128))
    if case == "real psi":
        return op.real.contiguous(), psi.real.contiguous(), TypeError
    if case == "dtype mismatch":
        return op.to(torch.complex64), psi, TypeError
    if case == "shape":
        return op[:-1].contiguous(), psi, ValueError
    if case == "noncontiguous op":
        return op.transpose(-1, -2), psi, ValueError
    if case == "strided psi":
        return op[::2].contiguous(), psi[::2], ValueError
    if case == "meta device":
        return op.to("meta"), psi.to("meta"), ValueError
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["real psi", "dtype mismatch", "shape",
                                  "noncontiguous op", "strided psi",
                                  "meta device"])
def test_kernel_wrapper_rejects_bad_arguments(case):
    op, psi, exc = _bad_args(case)
    with pytest.raises(exc):
        kn.spo_potential_apply(op, psi)


def test_spo_entry_points_match_ctypes_signatures():
    src = (Path(_cuda_lib.CSRC) / "spo.cu").read_text()
    found = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        found[name] = [p.strip() for p in params.split(",") if p.strip()]
    sigs = _cuda_lib.SIGNATURES["spo"]
    assert set(found) == set(sigs)
    import ctypes
    for name, params in found.items():
        assert len(sigs[name]) == len(params)
        for p, ct in zip(params, sigs[name]):
            want = (ctypes.c_void_p if "*" in p else ctypes.c_longlong
                    if p.startswith("long long") else ctypes.c_int)
            assert ct is want, (name, p)


# ------------------------------------------------------ helper modules
def test_wavepackets_and_math_match_jax():
    x = np.linspace(-5, 5, 41)
    for a, b in [(t_wp.gwp(x, a=1.3, x0=0.4, p0=0.7),
                  j_wp.gwp(jnp.asarray(x), a=1.3, x0=0.4, p0=0.7)),
                 (t_wp.rgwp(x, x0=0.2, sigma=0.8),
                  j_wp.rgwp(jnp.asarray(x), x0=0.2, sigma=0.8)),
                 (t_wp.gwp_k(x, 0.9, 0.3, 1.1),
                  j_wp.gwp_k(jnp.asarray(x), 0.9, 0.3, 1.1)),
                 (t_math.morse(x, 2.0, 0.5, 1.0),
                  j_math.morse(jnp.asarray(x), 2.0, 0.5, 1.0))]:
        assert rel_err(a.numpy(), b) < 1e-14
    A = np.array([[1.2, 0.3], [0.3, 0.8]])
    pnt = np.array([0.3, -0.2])
    assert maxdiff(t_wp.gwp(pnt, a=A, x0=[0.1, 0.0], p0=[0.5, 0.2], ndim=2),
                   j_wp.gwp(jnp.asarray(pnt), a=jnp.asarray(A), x0=[0.1, 0.0],
                            p0=[0.5, 0.2], ndim=2)) < 1e-14
    X, Y = np.meshgrid(x, x, indexing="ij")
    sig = np.array([[1.0, 0.2], [0.2, 0.7]])
    assert maxdiff(t_wp.gwp2(X, Y, sig, (0.1, 0.2), (0.3, 0.4)),
                   j_wp.gwp2(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(sig),
                             (0.1, 0.2), (0.3, 0.4))) < 1e-14
    assert t_math.interval(x) == j_math.interval(x)
    assert pt.gwp is t_wp.gwp


def test_checkpoint_format_is_shared(tmp_path):
    rng = np.random.default_rng(1)
    a, b = crand(rng, 5, 2), rng.standard_normal(3)
    t_diag.save_checkpoint(str(tmp_path / "t.npz"), 7,
                           [torch.as_tensor(a), torch.as_tensor(b)],
                           dt=0.1, nout=4)
    step, leaves, meta = j_diag.load_checkpoint(str(tmp_path / "t.npz"))
    assert step == 7 and float(meta["dt"]) == 0.1 and int(meta["nout"]) == 4
    np.testing.assert_array_equal(np.asarray(leaves[0]), a)
    j_diag.save_checkpoint(str(tmp_path / "j.npz"), 3,
                           (jnp.asarray(a), jnp.asarray(b)), dt=0.2)
    step, leaves, meta = t_diag.load_checkpoint(str(tmp_path / "j"))
    assert step == 3 and float(meta["dt"]) == 0.2
    np.testing.assert_array_equal(leaves[1].numpy(), b)


# ----------------------------------------------------------- slice level
def _two_state(X, Y=None):
    R2 = X ** 2 + (0 if Y is None else Y ** 2)
    v1 = 0.5 * R2
    v2 = 0.5 * ((X - 1.0) ** 2 + (0 if Y is None else Y ** 2)) + 1.0
    return v1, v2, 0.2 * np.exp(-0.5 * R2)


def _packet(g, dvol, ns, state=0):
    psi = np.zeros(g.shape + (ns,), complex)
    psi[..., state] = g / np.sqrt(np.sum(np.abs(g) ** 2) * dvol)
    return psi


def jax_case(case, jkernel="xla"):
    """(JAX solver, psi0, run kwargs) of one slice case."""
    if case == "harmonic":
        x = np.linspace(-8, 8, 64, endpoint=False)
        s = J.SPO(x, mass=1.0, nstates=1, kernel=jkernel)
        s.set_potential(lambda xx: 0.5 * xx ** 2)
        psi0 = (np.exp(-(x - 1.0) ** 2 / 2) / np.pi ** 0.25)[:, None]
        return s, psi0.astype(complex), dict(dt=0.02, nt=50, nout=5)
    if case == "morse":
        x = np.linspace(-3, 12, 64, endpoint=False)
        D, a, m = 2.0, 0.5, 20.0
        s = J.SPO(x, mass=m, kernel=jkernel)
        s.set_potential(D * (1 - np.exp(-a * (x - 1.0))) ** 2)
        psi0 = np.asarray(j_wp.gwp(jnp.asarray(x), a=np.sqrt(2 * D * a * a * m),
                                   x0=0.3))
        return s, psi0, dict(dt=0.02, nt=50, nout=10)
    if case in ("spo2", "spo2_jacobi"):
        if case == "spo2":
            x = y = np.linspace(-6, 6, 24, endpoint=False)
            s = J.SPO2(x, y, masses=[1.0, 1.0], nstates=2, kernel=jkernel)
            X, Y = s.X, s.Y
            v1, v2, c = _two_state(X, Y)
            g = np.exp(-0.5 * ((X - 0.5) ** 2 + Y ** 2))
        else:
            x = np.linspace(0.5, 6, 24, endpoint=False)
            y = np.linspace(-np.pi, np.pi, 24, endpoint=False)
            s = J.SPO2(x, y, masses=[2.0, lambda xx: 2.0 * xx ** 2],
                       nstates=2, coords="jacobi", kernel=jkernel)
            X, Y = s.X, s.Y
            v1 = 0.5 * (X - 2.0) ** 2 + 0.2 * (1 - np.cos(Y))
            v2, c = v1 + 0.5, 0.05 * np.ones_like(X)
            g = np.exp(-2 * (X - 2.0) ** 2 - Y ** 2)
        s.set_DPES([v1, v2], [[(0, 1), c]])
        return s, _packet(g, s.dvol, 2), dict(dt=0.02, nt=20, nout=5)
    if case == "spo3":
        x = np.linspace(-4, 4, 12, endpoint=False)
        s = J.SPO3(x, x, x, masses=[1.0, 1.0, 1.0], nstates=2, kernel=jkernel)
        v1 = 0.5 * (s.X ** 2 + s.Y ** 2 + s.Z ** 2)
        v2 = 0.5 * ((s.X - 1.0) ** 2 + s.Y ** 2 + s.Z ** 2) + 1.0
        c = 0.2 * np.exp(-v1)
        s.set_DPES([v1, v2], [[(0, 1), c]])
        g = np.exp(-((s.X + 1.0) ** 2 + s.Y ** 2 + s.Z ** 2) / 2.0)
        return s, _packet(g, s.dvol, 2), dict(dt=0.01, nt=10, nout=5)
    if case == "spo3_jacobi":
        x = np.linspace(1.2, 3.2, 8, endpoint=False)
        y = np.linspace(1.5, 3.5, 8, endpoint=False)
        z = np.linspace(-np.pi, np.pi, 8, endpoint=False)
        s = J.SPO3(x, y, z, masses=(1.5, 2.0), nstates=1, coords="jacobi",
                   kernel=jkernel)
        s.set_dpes(0.5 * (s.X - 2.0) ** 2 + 0.4 * (s.Y - 2.4) ** 2
                   + 0.2 * (1 - np.cos(s.Z)))
        g = np.exp(-2 * (s.X - 2.0) ** 2 - 2 * (s.Y - 2.4) ** 2 - s.Z ** 2)
        return s, _packet(g, s.dvol, 1), dict(dt=0.01, nt=10, nout=5)
    if case == "spo2nh":
        x = y = np.linspace(-6, 6, 24, endpoint=False)
        s = J.SPO2NH(x, y, masses=[1.0, 1.0], nstates=2, kernel=jkernel)
        v = np.zeros(s.shape + (2, 2), complex)
        v[..., 0, 0] = 0.5 * (s.X ** 2 + s.Y ** 2)
        v[..., 1, 1] = 0.5 * ((s.X - 0.5) ** 2 + s.Y ** 2) + 1.0 - 0.4j
        v[..., 0, 1] = v[..., 1, 0] = 0.2 * np.exp(-(s.X ** 2 + s.Y ** 2))
        s.set_dpes(v)
        g = np.exp(-(s.X - 0.5) ** 2 - s.Y ** 2)
        return s, _packet(g, s.dvol, 2, state=1), dict(dt=0.02, nt=10,
                                                        nout=5)
    if case == "abc":
        x = np.linspace(-8, 8, 64, endpoint=False)
        s = J.SPO(x, mass=1.0, nstates=1, abc=True, kernel=jkernel)
        s.set_DPES([0.05 * x ** 2], eta=0.5)
        g = np.exp(-(x - 3.0) ** 2 + 3j * x)
        return s, _packet(g, s.dvol, 1), dict(dt=0.02, nt=60, nout=10)
    if case == "dft1":
        x = np.linspace(-3, 20, 64, endpoint=False)
        s = J.SPO(x, mass=1.0, nstates=1, kernel="dft")
        s.set_potential(lambda xx: 8.0 * (1 - np.exp(-0.5 * xx)) ** 2)
        g = np.exp(-(x - 2.0) ** 2)
        return s, _packet(g, s.dvol, 1), dict(dt=0.005, nt=40, nout=10)
    if case == "dft2":
        x = np.linspace(-8, 8, 64, endpoint=False)
        s = J.SPO(x, mass=1.0, nstates=2, kernel="dft")
        v = np.zeros((64, 2, 2))
        v[:, 0, 0] = 0.5 * x ** 2
        v[:, 1, 1] = 0.5 * x ** 2 + 1.0
        v[:, 0, 1] = v[:, 1, 0] = 0.2
        s.set_dpes(v)
        g = np.exp(-(x - 1.0) ** 2)
        return s, _packet(g, s.dvol, 2), dict(dt=0.01, nt=20, nout=5)
    raise AssertionError(case)


_JAX_RUNS = {}


def jax_run(case, jkernel="xla"):
    """The JAX solver and its Result for one case (cached)."""
    key = (case, jkernel)
    if key not in _JAX_RUNS:
        s, psi0, kw = jax_case(case, jkernel)
        _JAX_RUNS[key] = (s, psi0, kw, s.run(jnp.asarray(psi0), **kw))
    return _JAX_RUNS[key]


def assert_same_run(sol, res, js, jr):
    """psi, states, rho_el, population, times, apes and expV/2 of a port
    run against the JAX run."""
    for f in ("psi", "states", "rho_el", "population", "times"):
        assert getattr(res, f).shape == np.asarray(getattr(jr, f)).shape, f
        assert maxdiff(getattr(res, f), getattr(jr, f)) <= TOL, f
    assert maxdiff(sol._exp_V_half, js._exp_V_half) <= TOL
    if js.apes is None:
        assert sol.apes is None
    else:
        assert maxdiff(sol.apes, js.apes) <= TOL
    assert (res.dt, res.nt, res.nout) == (jr.dt, jr.nt, jr.nout)


SLICE_CASES = [(c, k) for c in ("harmonic", "morse", "spo2", "spo2_jacobi",
                                "spo3", "spo3_jacobi", "spo2nh", "abc")
               for k in (None, "xla")] + [("dft1", "dft"), ("dft2", "dft")]


@pytest.mark.parametrize("case,kernel", SLICE_CASES)
def test_slice_matches_jax(case, kernel):
    js, psi0, kw, jr = jax_run(case)
    sol = T.spo_from_reference(js, device="cpu", kernel=kernel)
    assert type(sol).__name__ == type(js).__name__
    res = sol.run(psi0, **kw)
    assert res.psi.device.type == "cpu"
    assert_same_run(sol, res, js, jr)


def test_harmonic_matches_jax_pallas_interpret(monkeypatch):
    """JAX kernel='pallas' routed through the Pallas interpreter (the
    monkeypatch of tests/test_pallas.py:295-332) against the port's
    kernel='cuda' path on CPU tensors."""
    phase, pot = pk.spo_phase_multiply, pk.spo_potential_apply
    monkeypatch.setattr(pk, "spo_phase_multiply",
                        lambda *a, **k: phase(*a, interpret=True, **k))
    monkeypatch.setattr(pk, "spo_potential_apply",
                        lambda *a, **k: pot(*a, interpret=True, **k))
    js, psi0, kw = jax_case("harmonic", jkernel="pallas")
    jr = js.run(jnp.asarray(psi0), **kw)
    sol = T.spo_from_reference(js, device="cpu", kernel="cuda")
    assert sol.kernel == "cuda"
    assert_same_run(sol, sol.run(psi0, **kw), js, jr)


def test_two_state_cap_equals_jax_exact_expm():
    """abc=True with ns = 2: the port splits the CAP off as a scalar phase
    tr(cap)/ns per grid point, which is exact because set_DPES's CAP is a
    multiple of the identity; it must equal the JAX package's exact
    per-point expm (nonherm=True) of the same complex matrix."""
    x = y = np.linspace(-6, 6, 24, endpoint=False)
    js = J.SPO2(x, y, masses=[1.0, 1.0], nstates=2, abc=True, nonherm=True,
                kernel="xla")
    v1, v2, c = _two_state(js.X, js.Y)
    js.set_DPES([v1, v2], [[(0, 1), c]], eta=0.3)
    g = np.exp(-0.5 * ((js.X - 3.0) ** 2 + js.Y ** 2) + 2j * js.X)
    psi0 = _packet(g, js.dvol, 2)
    kw = dict(dt=0.02, nt=20, nout=5)
    jr = js.run(jnp.asarray(psi0), **kw)
    sol = T.SPO2(x, y, masses=[1.0, 1.0], nstates=2, abc=True, device="cpu")
    sol.set_DPES([v1, v2], [[(0, 1), c]], eta=0.3)
    res = sol.run(psi0, **kw)
    for f in ("psi", "rho_el", "population"):
        assert maxdiff(getattr(res, f), getattr(jr, f)) <= TOL, f
    assert maxdiff(sol._exp_V_half, js._exp_V_half) <= TOL
    assert float(res.population[-1].sum()) < 1.0 - 1e-3     # absorbed


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_chunked_eigh_equals_one_call(dtype):
    """The build's eigh runs in chunks on CUDA (cuSOLVER's batch limit);
    chunking changes nothing."""
    rng = np.random.default_rng(3)
    a = torch.as_tensor(crand(rng, 50, 3, 3))
    a = a.real.to(dtype) if not dtype.is_complex else a
    a = a + a.transpose(-1, -2).conj()
    w, u = torch.linalg.eigh(a)
    wc, uc = T._eigh(a, chunk=7)
    assert torch.equal(w, wc) and torch.equal(u, uc)


def test_result_and_observables_match_jax():
    js, psi0, kw, jr = jax_run("spo2")
    sol = T.spo_from_reference(js, device="cpu")
    res = sol.run(psi0, **kw)
    assert maxdiff(res.get_population(), jr.get_population()) <= TOL
    assert maxdiff(res.position(), jr.position()) <= TOL
    assert res.x is sol.grids[0] and res.y is sol.grids[1]
    psi = np.asarray(jr.psi)
    for a, b in zip(sol.current_density(psi, 0), js.current_density(psi, 0)):
        assert maxdiff(a, b) <= TOL
    assert maxdiff(sol.population(psi), js.population(jnp.asarray(psi))) <= TOL
    assert maxdiff(sol.rdm_el(psi), js.rdm_el(jnp.asarray(psi))) <= TOL
    assert maxdiff(sol.norm(psi), js.norm(jnp.asarray(psi))) <= TOL
    for axis in (0, 1):
        assert maxdiff(sol.position_expectation(psi, axis),
                       js.position_expectation(jnp.asarray(psi), axis)) <= TOL
    # adiabatic amplitudes are d2a^H psi: compare with the JAX package's
    # eigenvectors used so (its own population() applies d2a, not d2a^H)
    d2a = np.asarray(js.d2a)
    ref = np.sum(np.abs(np.einsum("...ba, ...b -> ...a", d2a.conj(), psi))
                 ** 2, axis=(0, 1)) * js.dvol
    ad = sol.population(psi, representation="adiabatic")
    assert maxdiff(ad, ref) <= TOL
    assert abs(float(ad.sum()) - float(sol.norm(psi))) <= TOL
    both = sol.population([psi, psi])
    assert both.shape == (2, 2)
    with pytest.raises(ValueError):
        sol.population(psi, representation="bogus")


def _harmonic_port(**kw):
    x = np.linspace(-8, 8, 64, endpoint=False)
    s = pt.SPO(x, mass=1.0, device="cpu", **kw)
    s.set_potential(0.5 * x ** 2)
    psi0 = np.exp(-(x - 1.0) ** 2).astype(complex)
    return s, (psi0 / np.linalg.norm(psi0))[:, None]


def test_run_reuses_build_until_inputs_change(monkeypatch):
    s, psi0 = _harmonic_port()
    calls = []
    build = type(s).build
    monkeypatch.setattr(type(s), "build",
                        lambda self, *a, **k: calls.append(a) or build(
                            self, *a, **k))
    r1 = s.run(psi0, dt=0.02, nt=4, nout=2)
    r2 = s.run(psi0, dt=0.02, nt=4, nout=2)
    assert len(calls) == 1 and torch.equal(r1.psi, r2.psi)
    s.run(psi0, dt=0.01, nt=4, nout=2)                  # new dt
    s.run(psi0.astype(np.complex64), dt=0.01, nt=4, nout=2)   # new dtype
    s.set_potential(0.4 * s.x ** 2)                     # new potential
    s.run(psi0, dt=0.01, nt=4, nout=2)
    s.build(0.05)                                       # factors replaced
    s.run(psi0, dt=0.01, nt=4, nout=2)
    assert len(calls) == 6


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    s, psi0 = _harmonic_port()
    full = s.run(psi0, dt=0.02, nt=40, nout=4)
    ck = str(tmp_path / "spo_ck.npz")
    _harmonic_port()[0].run(psi0, dt=0.02, nt=12, nout=4, checkpoint=ck,
                            checkpoint_every=1)
    resumed = _harmonic_port()[0].run(psi0, dt=0.02, nt=40, nout=4,
                                      resume=ck)
    assert torch.equal(resumed.psi, full.psi)
    assert torch.equal(resumed.times, full.times[3:])
    assert torch.equal(resumed.rho_el, full.rho_el[3:])
    with pytest.raises(ValueError, match="resume dt"):
        s.run(psi0, dt=0.05, nt=40, nout=4, resume=ck)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    x = np.linspace(-8, 8, 64, endpoint=False)
    js = J.SPO(x, mass=1.0, kernel="xla")
    js.set_potential(0.5 * x ** 2)
    _, psi0 = _harmonic_port()
    ck = str(tmp_path / "jax_ck.npz")
    js.run(jnp.asarray(psi0), dt=0.02, nt=12, nout=4, checkpoint=ck)
    jfull = js.run(jnp.asarray(psi0), dt=0.02, nt=40, nout=4)
    s, _ = _harmonic_port()
    res = s.run(psi0, dt=0.02, nt=40, nout=4, resume=ck)
    assert maxdiff(res.psi, jfull.psi) <= TOL
    assert maxdiff(res.times, np.asarray(jfull.times)[3:]) <= TOL


# ----------------------------------------------------------- guard rails
def test_cuda_kernel_on_cpu_launches_nothing():
    kn.spo_phase_multiply.launches = kn.spo_potential_apply.launches = 0
    for k in ("cuda", "pallas", None):
        s, psi0 = _harmonic_port(kernel=k)
        s.run(psi0, dt=0.02, nt=4, nout=2)
    assert kn.spo_phase_multiply.launches == 0
    assert kn.spo_potential_apply.launches == 0


def test_mesh_raises_not_yet_ported():
    """Ported since: mesh= takes a DeviceMesh (sharded runs are held to
    JAX's in tests/test_torch_parallel.py) and refuses anything else."""
    x = np.linspace(-1, 1, 8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        pt.SPON([x], mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        pt.SPO3(x, x, x, mesh=object(), device="cpu")


@pytest.mark.parametrize("kernel", ["triton", "xla-fast", "einsum"])
def test_unknown_kernel_raises(kernel):
    with pytest.raises(ValueError, match="unknown SPO kernel"):
        pt.SPO(np.linspace(-1, 1, 8), kernel=kernel, device="cpu")


def test_dft_limits_raise_like_jax():
    x = np.linspace(-1, 1, 8, endpoint=False)
    s = pt.SPO2(x, x, nstates=1, kernel="dft", device="cpu")
    s.set_dpes(np.zeros((8, 8)))
    with pytest.raises(NotImplementedError, match="1D-only"):
        s.build(0.1)
    nh = pt.SPO2NH(x, x, nstates=2, kernel="dft", device="cpu")
    nh.set_dpes(np.zeros((8, 8, 2, 2), complex))
    with pytest.raises(NotImplementedError, match="nonherm"):
        nh.build(0.1)
    with pytest.raises(ValueError):
        pt.SPO(x, device="cpu").set_dpes(np.zeros(5))

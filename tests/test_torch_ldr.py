"""Parity of the PyTorch port's LDR slice (pyqed_tpu_torch: grid/dvr,
grid/ldr, grid/rate, tn/ttals) with the JAX package, on the CPU at
complex128.

Inputs are made with numpy (from seeds or closed forms) and handed to
both packages; ``ldr_from_reference`` builds the port's solver from the
same arrays as the JAX one. Each JAX ``run()`` compiles its own program,
so every JAX reference is computed once per module (the ``jref``
fixture) and shared. Tolerances: deterministic operators and
propagations rel 1e-12; energies, correlation functions and rates rel
1e-10; tensor trains through their phase-free dense tensors, 1e-12.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.core.diagnostics import load_checkpoint as j_load
from pyqed_tpu.grid import dvr as jdvr
from pyqed_tpu.grid import rate as jrate
from pyqed_tpu.grid.ldr import LDRN as JLDRN
from pyqed_tpu.grid.ldr import LDR2Jacobi as JLDR2Jacobi
from pyqed_tpu.grid.ldr import NonHermLDRN as JNonHermLDRN
from pyqed_tpu.open.bath import DrudeBath as JDrudeBath
from pyqed_tpu.tn import ttals as jtt

import pyqed_tpu_torch as pt
from pyqed_tpu_torch.core.diagnostics import load_checkpoint
from pyqed_tpu_torch.grid import dvr as tdvr
from pyqed_tpu_torch.grid import rate as trate
from pyqed_tpu_torch.grid.ldr import (LDR2, LDR2Jacobi, LDRN, NonHermLDRN,
                                      ldr_from_reference)
from pyqed_tpu_torch.open.bath import DrudeBath
from pyqed_tpu_torch.tn import ttals as ttt

RTOL = 1e-12
DOM = [(-4.0, 4.0), (-3.5, 3.5)]
LEV = [3, 3]
DT = 0.01
RUN = dict(dt=DT, nt=40, nout=10)


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


def model2d():
    """Two harmonic surfaces with an X-dependent gap and a mixing angle
    0.4 tanh(XY) (tests/test_dvr_ldr.py's factored model)."""
    x = [JLDRN(DOM, LEV, nstates=2).x[d] for d in range(2)]
    X, Y = np.meshgrid(x[0], x[1], indexing="ij")
    v0 = 0.5 * (X ** 2 + Y ** 2)
    gap = 1.0 + 0.3 * X
    apes = np.stack([v0 - gap / 2, v0 + gap / 2], axis=-1)
    th = 0.4 * np.tanh(X * Y)
    states = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                       np.stack([np.sin(th), np.cos(th)], -1)], -2)
    psi0 = np.zeros(X.shape + (2,), complex)
    g = np.exp(-((X + 1) ** 2 + Y ** 2))
    psi0[..., 0] = g / np.sqrt((np.abs(g) ** 2).sum())
    return apes, states, psi0


def jax_ldr(apes, states):
    s = JLDRN(DOM, LEV, nstates=2)
    s.apes = apes
    s.build_ovlp(states)
    return s


def port_ldr(apes, states):
    return ldr_from_reference(DOM, LEV, nstates=2, apes=apes, states=states,
                              device="cpu")


def model1d(level=3):
    sol = JLDRN([(-4.0, 4.0)], [level], ndim=1, nstates=2)
    x = sol.x[0]
    return x, np.stack([0.5 * x ** 2, 0.5 * x ** 2 + 0.5], axis=-1)


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """Every JAX reference that runs a compiled program, once."""
    apes, states, psi0 = model2d()
    n = psi0.size
    out = {}
    j = jax_ldr(apes, states)
    out["U"] = np.asarray(j.short_time_propagator(DT))
    out["expT"] = np.asarray(j._exp_T_flat)
    out["H"] = np.asarray(j.buildH())
    for m in ("dense", "factored"):
        out[m] = j.run(psi0, **RUN, method=m)
    ck = str(tmp_path_factory.mktemp("ldr") / "jax_ck.npz")
    j.run(psi0, dt=DT, nt=20, nout=10, checkpoint=ck, checkpoint_every=1)
    out["jax_ck"] = ck
    out["imag"] = j.run_imag(psi0, dt=0.02, nt=200, nout=20)
    rho0 = np.outer(psi0.reshape(n), psi0.reshape(n).conj())
    out["lvn"] = j.run_lvn(rho0, dt=DT, nt=20, nout=10)
    p = np.stack([psi0.reshape(n), np.roll(psi0.reshape(n), 5)], axis=1)
    out["split"] = j.make_split_stepper(DT, 25, apes=apes, states=states)(
        jnp.asarray(p.real), jnp.asarray(p.imag))
    # diabatic (separable) run of a 1-D two-state model
    x, ap1 = model1d()
    j1 = JLDRN([(-4.0, 4.0)], [3], ndim=1, nstates=2)
    j1.apes = ap1
    j1.build_ovlp(None)
    g = np.exp(-0.5 * (x - 0.4) ** 2)
    psi1 = np.stack([g, 0.5 * g], -1).astype(complex)
    psi1 /= np.sqrt((np.abs(psi1) ** 2).sum() * (x[1] - x[0]))
    out["psi1"] = psi1
    out["diabatic"] = j1.run(psi1, dt=0.005, nt=40, nout=10)
    # HEOM on the vibronic Hamiltonian of the 1-D model
    j1.buildH()
    bath = JDrudeBath(temperature=1.0, cutoff=1.0, reorg=0.05)
    rho1 = np.outer(psi1.ravel(), psi1.ravel().conj()) * (x[1] - x[0])
    out["rho1"] = rho1
    out["heom"] = j1.heom(bath, coupling="population", lmax=1,
                          nexp=1).run(rho1, dt=0.002, nt=40, nout=20)
    return out


# ---------------------------------------------------------------- DVRs
DVRS = {       # class name, arguments, keywords
    "sinc": ("SincDVR", (6.0, 21), dict(x0=0.3, mass=1.3)),
    "sine": ("SineDVR", (-3.0, 4.0, 23), dict(mass=0.7)),
    "hermite": ("HermiteDVR", (20,), dict(x0=0.2, mass=1.1)),
    "exponential": ("ExponentialDVR", (9,), dict(L=7.0, x0=0.1)),
    "bessel": ("BesselDVR", (16, 8.0), dict(l=1, dim=3)),
    "laguerre": ("LaguerreDVR", (14,), dict(alpha=2, scale=0.5)),
    "chebyshev": ("ChebDVR", (15,), dict(mass=2.0)),
    "legendre": ("LegendreDVR", (12,), dict(mass=1.5)),
}


@pytest.mark.parametrize("name", sorted(DVRS))
def test_dvr_kinetic_spectrum_and_expT(name):
    cls, args, kw = DVRS[name]
    jd = getattr(jdvr, cls)(*args, **kw)
    td = getattr(tdvr, cls)(*args, device="cpu", **kw)
    np.testing.assert_allclose(td.x, jd.x, rtol=0, atol=1e-14)
    V = lambda x: 0.5 * (x - 0.1) ** 2              # noqa: E731
    extra = {"sine": ("momentum", lambda d: d.expT(-0.05j)),
             "sinc": ("ip", "f")}.get(name, ())
    funcs = [lambda d: d.t(), lambda d: d.run(V, num_eigs=5)[0]]
    if hasattr(jd, "expT"):
        funcs.append(lambda d: d.expT(0.05))
    funcs += [f if callable(f) else (lambda d, f=f: getattr(d, f)())
              for f in extra]
    # the JAX references in one program (eager JAX compiles op by op)
    refs = jax.jit(lambda: [f(jd) for f in funcs])()
    for f, ref in zip(funcs, refs):
        assert rel_err(f(td), ref) <= (1e-10 if f is funcs[1] else RTOL)


def test_dvrn_and_kinetic():
    jx, jy = jdvr.SineDVR(-3, 3, 9), jdvr.HermiteDVR(7, x0=0.1)
    tx = tdvr.SineDVR(-3, 3, 9, device="cpu")
    ty = tdvr.HermiteDVR(7, x0=0.1, device="cpu")
    V = lambda X, Y: 0.5 * X ** 2 + 0.3 * Y ** 2 + 0.1 * X * Y  # noqa: E731
    jn, tn = jdvr.DVR2(jx, jy), tdvr.DVR2(tx, ty, device="cpu")
    rng = np.random.default_rng(3)
    psi = rng.standard_normal((9, 7)) + 1j * rng.standard_normal((9, 7))
    Vg = V(*np.meshgrid(jx.x, jy.x, indexing="ij"))
    x = np.linspace(-2, 2, 17)
    Hj, Ej, Pj, Ks, Kc = jax.jit(lambda: (
        jn.hamiltonian_dense(V), jn.run(V, 4)[0], jn.apply_H(psi, Vg),
        jdvr.kinetic(x, 1.7, "sine"), jdvr.kinetic(x, 1.7, "sinc")))()
    assert rel_err(tn.hamiltonian_dense(V), Hj) <= RTOL
    assert rel_err(tn.run(V, 4)[0], Ej) <= 1e-10
    assert rel_err(tn.apply_H(psi, Vg), Pj) <= RTOL
    assert rel_err(tdvr.kinetic(x, 1.7, "sine", device="cpu"), Ks) <= RTOL
    assert rel_err(tdvr.kinetic(x, 1.7, "sinc", device="cpu"), Kc) <= RTOL


# ---------------------------------------------------------------- LDR
def test_short_time_propagator_and_hamiltonian(jref):
    apes, states, _ = model2d()
    t = port_ldr(apes, states)
    assert rel_err(t.short_time_propagator(DT), jref["U"]) <= RTOL
    assert rel_err(t._exp_T_flat, jref["expT"]) <= RTOL
    assert rel_err(t.buildH(), jref["H"]) <= RTOL


@pytest.mark.parametrize("method", ["dense", "factored", "auto"])
def test_run_matches_jax(jref, method):
    apes, states, psi0 = model2d()
    r = port_ldr(apes, states).run(psi0, **RUN, method=method)
    ref = jref["dense" if method == "dense" else "factored"]
    assert rel_err(r.states, ref.states) <= RTOL
    assert rel_err(r.psi, ref.psi) <= RTOL
    assert rel_err(r.times, ref.times) <= 1e-15


def test_dense_equals_factored():
    apes, states, psi0 = model2d()
    t = port_ldr(apes, states)
    rd = t.run(psi0, **RUN, method="dense")
    rf = t.run(psi0, **RUN, method="factored")
    assert rel_err(rf.states, rd.states) <= RTOL


def test_diabatic_separable_run_matches_jax(jref):
    x, ap1 = model1d()
    t = ldr_from_reference([(-4.0, 4.0)], [3], nstates=2, apes=ap1,
                           device="cpu")
    r = t.run(jref["psi1"], dt=0.005, nt=40, nout=10)
    assert rel_err(r.states, jref["diabatic"].states) <= RTOL
    pop = r.get_population()
    ref = np.stack([np.asarray(t.population(s)) for s in r.psilist])
    assert rel_err(pop, ref) <= RTOL


@pytest.mark.parametrize("shape", ["2d", "3d"])
def test_blocked_build_equals_dense(shape):
    """short_time_propagator_blocked == short_time_propagator, for several
    block sizes, with nbasis > nstates (2-D) and a 3-D digit split."""
    rng = np.random.default_rng(3 if shape == "2d" else 7)
    if shape == "2d":
        dom, lev, nb = [(-3.0, 3.0), (-2.0, 2.0)], [3, 2], 3
        blocks = (None, 1, 3, 7, 21)
    else:
        dom, lev, nb = [(-3, 3), (-2, 2), (-2.5, 2.5)], [2, 2, 2], 2
        blocks = (None, 9)
    s = LDRN(dom, lev, nstates=2, device="cpu")
    shp = tuple(s.nx)
    apes = rng.normal(size=shp + (2,))
    states = rng.normal(size=shp + (nb, 2))
    if shape == "2d":
        states = states + 1j * rng.normal(size=shp + (nb, 2))
    s.apes = apes
    s.build_ovlp(states)
    U = s.short_time_propagator(0.013).clone()
    T = s._exp_T_flat.clone()
    for block in blocks:
        b = LDRN(dom, lev, nstates=2, device="cpu")
        b.apes = apes
        assert rel_err(b.short_time_propagator_blocked(0.013, states,
                                                       block=block), U) \
            <= RTOL
        assert rel_err(b._exp_T_flat, T) <= RTOL
    with pytest.raises(ValueError, match="must divide"):
        b.short_time_propagator_blocked(0.013, states, block=4)


def test_blocked_cache_and_dt_rebuild():
    """The cache contract: the same dt returns the cached blocked build, a
    new dt rebuilds it through the blocked path with the retained states
    (never the diabatic identity), new surfaces invalidate it, run() and
    run_imag use it."""
    rng = np.random.default_rng(5)
    dom = [(-4.0, 4.0), (-4.0, 4.0)]
    s = LDRN(dom, [3, 3], nstates=2, device="cpu")
    shp = tuple(s.nx)
    apes = rng.normal(size=shp + (2,))
    v = rng.normal(size=shp + (2, 2))
    _, u = np.linalg.eigh(v + np.swapaxes(v, -1, -2))

    def dense(ap, dt):
        d = LDRN(dom, [3, 3], nstates=2, device="cpu")
        d.apes = ap
        d.build_ovlp(u)
        return d.short_time_propagator(dt)

    s.apes = apes
    U1 = s.short_time_propagator_blocked(0.01, u)
    assert s.short_time_propagator(0.01) is U1
    assert rel_err(s.short_time_propagator(0.02), dense(apes, 0.02)) <= RTOL
    s.apes = apes + 0.3
    assert s._U is None and s._blocked_dt is None
    s.short_time_propagator_blocked(0.01, u)
    U3 = s.short_time_propagator(0.01)
    assert rel_err(U3, dense(apes + 0.3, 0.01)) <= RTOL
    assert rel_err(U3, dense(apes, 0.01)) > 1e-6
    s.build_ovlp(u)
    assert s._U is None and s._blocked_dt is None
    # run() after a blocked build: dense reuses it, auto takes the factor
    s.short_time_propagator_blocked(0.01, u)
    g = rng.normal(size=shp + (2,)) + 0.1
    psi0 = (g / np.linalg.norm(g)).astype(complex)
    rd = s.run(psi0, 0.01, 20, nout=10, method="dense")
    ra = s.run(psi0, 0.01, 20, nout=10)
    assert rel_err(ra.states, rd.states) <= RTOL
    r = s.run_imag(psi0, 0.01, 8, nout=4)
    assert bool(torch.isfinite(torch.view_as_real(r.psi)).all())


def test_checkpoint_resume_both_ways(jref, tmp_path):
    apes, states, psi0 = model2d()
    t = port_ldr(apes, states)
    # a JAX checkpoint (window 2 of 4) resumed by the port
    r = t.run(psi0, **RUN, resume=jref["jax_ck"])
    assert rel_err(r.states, jref["factored"].states[2:]) <= RTOL
    assert rel_err(r.times, jref["factored"].times[2:]) <= 1e-15
    # a port checkpoint read by the JAX loader, and resumed by the port
    ck = str(tmp_path / "port_ck.npz")
    t.run(psi0, dt=DT, nt=30, nout=10, checkpoint=ck, checkpoint_every=2)
    step, (leaf,), meta = j_load(ck)
    assert step == 3 and float(meta["dt"]) == DT
    ref = np.asarray(jref["factored"].states[2]).reshape(-1)
    assert rel_err(np.asarray(leaf), ref) <= RTOL
    assert rel_err(load_checkpoint(ck)[1][0], ref) <= RTOL
    r = t.run(psi0, **RUN, resume=ck)
    assert rel_err(r.psi, jref["factored"].psi) <= RTOL
    done = t.run(psi0, dt=DT, nt=30, nout=10, resume=ck)
    assert done.states.shape[0] == 0
    with pytest.raises(ValueError, match="already at window"):
        t.run(psi0, dt=DT, nt=20, nout=10, resume=ck)


def test_make_split_stepper(jref):
    apes, states, psi0 = model2d()
    t = port_ldr(apes, states)
    n = psi0.size
    p = np.stack([psi0.reshape(n), np.roll(psi0.reshape(n), 5)], axis=1)
    fr, fi = t.make_split_stepper(DT, 25, apes=apes, states=states)(
        p.real, p.imag)
    jr, ji = jref["split"]
    assert rel_err(fr, jr) <= RTOL and rel_err(fi, ji) <= RTOL
    ref = t.run(psi0, dt=DT, nt=25, nout=25, method="factored").psi
    assert rel_err(torch.complex(fr, fi)[:, 0], ref.reshape(-1)) <= RTOL
    with pytest.raises(NotImplementedError):
        t.make_split_stepper(DT, 2, states=states * (1 + 0.1j))


def test_split_stepper_gauss_hermite_matches_run():
    """On a Gauss-Hermite grid the port's stepper takes run()'s kinetic
    factors (``dvr.expT``, eigh-based here) and equals the factored run
    (the port's and the JAX package's); the JAX stepper's host factors
    use the sine-DVR formula for any DVR with an ``L`` and miss both by
    ~2e-2 (a quirk of the JAX package)."""
    kw = dict(nstates=2, dvr_type="gauss_hermite", x0=[0.0])
    j = JLDRN([(0, 0)], [9], **kw)
    t = LDRN([(0, 0)], [9], device="cpu", **kw)
    x = j.x[0]
    apes = np.stack([0.5 * x ** 2, 0.5 * x ** 2 + 1], -1)
    th = 0.3 * np.tanh(x)
    st = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                   np.stack([np.sin(th), np.cos(th)], -1)], -2)
    for s in (j, t):
        s.apes = apes
        s.build_ovlp(st)
    psi = np.stack([np.exp(-x ** 2), 0 * x], -1).astype(complex)
    ref = j.run(psi, 0.01, 10, nout=10).psi
    assert rel_err(t.run(psi, 0.01, 10, nout=10).psi, ref) <= RTOL
    p = psi.reshape(-1, 1)
    fr, fi = t.make_split_stepper(0.01, 10, apes=apes, states=st)(p.real,
                                                                  p.imag)
    assert rel_err(torch.complex(fr, fi)[:, 0], np.asarray(ref).reshape(-1)) \
        <= RTOL


def test_run_imag_and_lvn(jref):
    apes, states, psi0 = model2d()
    t = port_ldr(apes, states)
    ri = t.run_imag(psi0, dt=0.02, nt=200, nout=20)
    assert rel_err(ri.energies, jref["imag"].energies) <= 1e-10
    assert abs(ri.e_tot - jref["imag"].e_tot) <= 1e-10 * abs(ri.e_tot)
    assert rel_err(ri.psi, jref["imag"].psi) <= RTOL
    n = psi0.size
    rho0 = np.outer(psi0.reshape(n), psi0.reshape(n).conj())
    rl = t.run_lvn(rho0, dt=DT, nt=20, nout=10)
    assert rel_err(rl.rho, jref["lvn"].rho) <= RTOL
    assert rel_err(rl.states, jref["lvn"].states) <= RTOL
    # the dense branch (no factor) gives the same
    d = port_ldr(apes, states)
    d._S = None
    assert rel_err(d.run_lvn(rho0, dt=DT, nt=20, nout=10).rho, rl.rho) \
        <= RTOL
    assert abs(torch.trace(rl.rho).item() - 1.0) <= 1e-12


def test_observables_match_jax():
    apes, states, psi0 = model2d()
    j, t = jax_ldr(apes, states), port_ldr(apes, states)
    for name in ("rdm_el", "population", "rdm_nuc"):
        assert rel_err(getattr(t, name)(psi0),
                       getattr(j, name)(jnp.asarray(psi0))) <= RTOL


def test_heom_on_vibronic_hamiltonian(jref):
    """LDRN.heom wires the port's HEOMSolver (the plain version of the
    coupling kernel on the CPU) to the same operator as JAX."""
    x, ap1 = model1d()
    t = ldr_from_reference([(-4.0, 4.0)], [3], nstates=2, apes=ap1,
                           device="cpu")
    with pytest.raises(ValueError, match="buildH"):
        t.heom(DrudeBath(temperature=1.0, cutoff=1.0, reorg=0.05),
               "population")
    t.buildH()
    bath = DrudeBath(temperature=1.0, cutoff=1.0, reorg=0.05)
    sol = t.heom(bath, coupling="population", lmax=1, nexp=1, kernel="cuda")
    r = sol.run(jref["rho1"], dt=0.002, nt=40, nout=20)
    assert rel_err(r.rho, jref["heom"].rho) <= RTOL
    assert rel_err(r.states, jref["heom"].states) <= RTOL


def test_jacobi_and_ldr2():
    """LDR2Jacobi: the r-batched factored kernel equals its dense dressed
    propagator and JAX's, diabatic too; LDR2 from explicit grids."""
    mass = (2.0, lambda r: 2.0 * r ** 2)
    dom = [(1.0, 5.0), (0.3, 2.8)]
    j = JLDR2Jacobi(dom, [3, 3], nstates=2, mass=mass)
    t = LDR2Jacobi(dom, [3, 3], nstates=2, mass=mass, device="cpu")
    R, TH = np.meshgrid(j.x[0], j.x[1], indexing="ij")
    v0 = 0.5 * (R - 3.0) ** 2 + 0.3 * (TH - 1.5) ** 2
    gap = 1.0 + 0.2 * (R - 3.0)
    apes = np.stack([v0 - gap / 2, v0 + gap / 2], -1)
    th = 0.3 * np.tanh((R - 3.0) * (TH - 1.5))
    states = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                       np.stack([np.sin(th), np.cos(th)], -1)], -2)
    psi0 = np.zeros(R.shape + (2,), complex)
    g = np.exp(-((R - 2.5) ** 2 + (TH - 1.2) ** 2))
    psi0[..., 0] = g / np.sqrt((np.abs(g) ** 2).sum())
    for s in (j, t):
        s.apes = apes
    assert rel_err(t.buildK(0.005)[1], j.buildK(0.005)[1]) <= RTOL
    t.build_ovlp(states)
    rd = t.run(psi0, dt=0.005, nt=40, nout=10, method="dense")
    rf = t.run(psi0, dt=0.005, nt=40, nout=10, method="factored")
    assert rel_err(rf.states, rd.states) <= RTOL
    j.build_ovlp(None)
    t.build_ovlp(None)
    rj = j.run(psi0, dt=0.005, nt=20, nout=10)
    rt = t.run(psi0, dt=0.005, nt=20, nout=10)
    assert rel_err(rt.states, rj.states) <= RTOL
    with pytest.raises(NotImplementedError):
        t.make_split_stepper(0.005, 2, states=states)
    x, y = t.x
    l2 = LDR2(x=x, y=y, device="cpu")
    assert l2.nx == [7, 7] and np.allclose(l2.x[0], x)


def test_nonhermitian_ldr_matches_jax():
    j = JNonHermLDRN([(-4.0, 4.0)], [4], ndim=1, nstates=2)
    t = NonHermLDRN([(-4.0, 4.0)], [4], ndim=1, nstates=2, device="cpu")
    x = j.x[0]
    v = np.zeros((len(x), 2, 2), complex)
    v[:, 0, 0] = 0.5 * x ** 2
    v[:, 1, 1] = 0.5 * (x - 1) ** 2 + 0.3 - 0.05j * (x > 2)
    v[:, 0, 1] = v[:, 1, 0] = 0.1 * np.exp(-x ** 2)
    for s in (j, t):
        s.set_diabatic(v)
        s.build_ovlp()
    psi0 = np.zeros((len(x), 2), complex)
    psi0[:, 0] = np.exp(-(x + 1) ** 2)
    psi0 /= np.sqrt((np.abs(psi0) ** 2).sum() * j.dx[0])
    pa = t.from_diabatic(psi0)
    assert rel_err(pa, j.from_diabatic(psi0)) <= RTOL
    rj = j.run(j.from_diabatic(psi0), dt=0.02, nt=30, nout=10)
    rt = t.run(pa, dt=0.02, nt=30, nout=10)
    assert rel_err(rt.states, rj.states) <= RTOL
    assert abs(t.norm(rt.psi) - j.norm(rj.psi)) <= 1e-12
    assert rel_err(t.rdm_el(rt.psi), j.rdm_el(rj.psi)) <= RTOL


def test_entry_points_raise_without_card_and_mesh():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid there")
    with pytest.raises(RuntimeError, match="cuda"):
        LDRN(DOM, LEV)
    with pytest.raises(RuntimeError, match="cuda"):
        tdvr.SineDVR(-1, 1, 5)
    with pytest.raises(RuntimeError, match="cuda"):
        trate.RateFluxSide(np.eye(3), np.arange(3.0))
    # mesh= takes a DeviceMesh (sharded runs: tests/test_torch_distributed.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        LDRN(DOM, LEV, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_ldr(*model2d()[:2]).run(model2d()[2], dt=DT, nt=2,
                                     mesh=object())


# ---------------------------------------------------------------- rates
def eckart():
    sol = JLDRN([(-3, 3)], [4], nstates=1, mass=[1836.0])
    x = sol.x[0]
    return x, 0.003 / np.cosh(2 * x) ** 2


def jax_rate(H, x, beta=1052.0, t_plateau=1500.0, ntimes=60):
    """JAX's RateFluxSide.rate, its device work in one program: (k, C_fs)
    with the plateau over the last third of the window, as rate()
    computes it."""
    times = np.linspace(0.0, t_plateau, ntimes)

    def f(H):
        r = jrate.RateFluxSide(H, x)
        return r.cfs(beta, times), r.reactant_partition(beta)

    c, qr = jax.jit(f)(H)
    c = np.asarray(c)
    return float(np.mean(c[2 * ntimes // 3:])) / float(qr), c


def test_flux_side_rate_matches_jax():
    x, v = eckart()
    H = np.asarray(jdvr.SineDVR(x[0] - (x[1] - x[0]), x[-1] + (x[1] - x[0]),
                                len(x), mass=1836.0).t()) + np.diag(v)
    F, h = jax.jit(lambda: (jrate.flux_operator(H, x, 0.1),
                            jrate.heaviside_projector(x)))()
    assert rel_err(trate.flux_operator(H, x, 0.1, device="cpu"), F) <= RTOL
    assert rel_err(trate.heaviside_projector(x, device="cpu"), h) == 0
    kj, cj = jax_rate(H, x)
    kt, _, ct = trate.Rate(H, x, device="cpu").rate(1052.0, 1500.0, 60)
    assert abs(kt - kj) <= 1e-10 * abs(kj) and kt > 0
    assert rel_err(ct, cj) <= 1e-10


def test_nonadiabatic_rate_matches_jax():
    """NonadiabaticRate on a two-state LDR: H from the JAX LDRN's buildH,
    x tiled over the states, against the port's."""
    x, v = eckart()
    apes = np.stack([v, v + 0.002], -1)
    th = 0.2 * np.tanh(x)
    states = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                       np.stack([np.sin(th), np.cos(th)], -1)], -2)
    j = JLDRN([(-3, 3)], [4], nstates=2, mass=[1836.0])
    j.apes = apes
    j.build_ovlp(states)
    kj, cj = jax_rate(np.asarray(j.buildH()), np.repeat(x, 2))
    t = ldr_from_reference([(-3, 3)], [4], nstates=2, mass=[1836.0],
                           apes=apes, states=states, device="cpu")
    kt, _, ct = trate.NonadiabaticRate(t).rate(1052.0, 1500.0, 60)
    assert abs(kt - kj) <= 1e-10 * abs(kj)
    assert rel_err(ct, cj) <= 1e-10


# ---------------------------------------------------------------- TT
def test_tensor_train_matches_jax():
    rng = np.random.default_rng(11)
    a, b, c, d = (rng.standard_normal(n) for n in (4, 5, 3, 6))
    T = (np.einsum("i,j,k,l->ijkl", a, b, c, d)
         + 0.3 * np.einsum("i,j,k,l->ijkl", b[:4], a[:4].repeat(2)[:5],
                           d[:3], c.repeat(2)))
    jc = jtt.tt_svd(T, max_rank=3)
    tc = ttt.tt_svd(T, max_rank=3, device="cpu")
    assert ttt.tt_rank(tc) == jtt.tt_rank(jc)
    assert rel_err(ttt.tt_to_dense(tc), jtt.tt_to_dense(jc)) <= RTOL
    assert rel_err(ttt.tt_to_dense(tc), T) <= 1e-12
    idx = np.stack([rng.integers(0, n, 10) for n in T.shape], 1)
    assert rel_err(ttt.tt_eval(tc, idx), jtt.tt_eval(jc, idx)) <= RTOL
    assert rel_err(ttt.tt_to_dense(jc), T) <= 1e-12     # NumPy cores
    # ALS from a rank-1 start refines toward the same tensor
    j1 = jtt.tt_svd(T, max_rank=1)
    ja = jtt.tt_als(T, j1, sweeps=3)
    ta = ttt.tt_als(T, [torch.as_tensor(G) for G in j1], sweeps=3,
                    device="cpu")
    assert rel_err(ttt.tt_to_dense(ta), jtt.tt_to_dense(ja)) <= 1e-10


def test_port_package_imports_no_jax():
    import ast
    import pathlib
    root = pathlib.Path(pt.__file__).parent
    for f in list(root.rglob("*.py")):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert not name.split(".")[0] in ("jax", "pyqed_tpu"), (f,
                                                                        name)

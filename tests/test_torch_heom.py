"""Parity of the PyTorch port's HEOM main path (pyqed_tpu_torch) with the
JAX package (pyqed_tpu), on the CPU at complex128: hierarchy enumeration,
bath decompositions, every right-hand side of HEOMSolver, and the FMO
slice end to end through HEOMSolver.run.

Inputs are made with numpy from a seed and handed to both packages; the
results are compared as numpy arrays. Right-hand sides are held to rel
1e-12 (the gate of tests/test_pallas.py), Result fields to 1e-10.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyqed_tpu.units as j_units
from pyqed_tpu.models.named import FMO as JFMO
from pyqed_tpu.open import bath as j_bath
from pyqed_tpu.open.heom import HEOMSolver as JHEOMSolver
from pyqed_tpu.open.heom import enumerate_hierarchy as j_enum
from pyqed_tpu.open.heom import neighbor_maps as j_nbr

import pyqed_tpu_torch as pt
from pyqed_tpu_torch import units as t_units
from pyqed_tpu_torch.config import complex_dtype_for, resolve_device
from pyqed_tpu_torch.open import bath as t_bath
from pyqed_tpu_torch.open.heom import (HEOMSolver, HEOMSolverDrude,
                                       enumerate_hierarchy, neighbor_maps,
                                       solver_from_reference)

RTOL = 1e-12          # RHS parity gate (f64)
RESULT_TOL = 1e-10    # Result fields after a propagation
REPO = Path(__file__).resolve().parent.parent


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


# ---------------------------------------------------------------- (iv)
@pytest.mark.parametrize("M,lmax", [(3, 3), (14, 2), (2, 5), (1, 4)])
def test_hierarchy_maps_identical(M, lmax):
    keys, index = enumerate_hierarchy(M, lmax)
    j_keys, j_index = j_enum(M, lmax)
    np.testing.assert_array_equal(keys, np.asarray(j_keys))
    assert keys.dtype == np.asarray(j_keys).dtype
    assert index == j_index
    for a, b in zip(neighbor_maps(keys, index), j_nbr(j_keys, j_index)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("nexp", [0, 1, 2, 4])
@pytest.mark.parametrize("method", ["pade", "matsubara"])
def test_drude_bath_decompositions_agree(method, nexp):
    kw = dict(temperature=0.7, cutoff=0.3, reorg=0.05)
    c, nu = getattr(t_bath.DrudeBath(**kw), method)(nexp)
    jc, jnu = getattr(j_bath.DrudeBath(**kw), method)(nexp)
    assert np.max(np.abs(c - jc)) <= 1e-15 * max(1.0, np.max(np.abs(jc)))
    assert np.max(np.abs(nu - jnu)) <= 1e-15 * max(1.0, np.max(np.abs(jnu)))


def test_pade_poles_and_prony_agree():
    for N in range(1, 5):
        for a, b in zip(t_bath.pade_poles_bose(N), j_bath.pade_poles_bose(N)):
            np.testing.assert_array_equal(a, b)
    J = t_bath.OhmicBath(temperature=1.0, cutoff=2.0, coupling=0.1)
    env_t = t_bath.Env(J.spectral_density, temperature=1.0)
    env_j = j_bath.Env(J.spectral_density, temperature=1.0)
    for a, b in zip(env_t.fit_exponentials(3, nt=120),
                    env_j.fit_exponentials(3, nt=120)):
        np.testing.assert_array_equal(a, b)


def test_units_match_jax():
    names = [k for k, v in vars(t_units).items()
             if not k.startswith("_") and isinstance(v, float)]
    assert "au2fs" in names and "au2wavenumber" in names and "au2k" in names
    for k in names:
        assert getattr(t_units, k) == getattr(j_units, k), k


def test_complex_dtype_for():
    assert complex_dtype_for(np.zeros(2)) == torch.complex128
    assert complex_dtype_for(np.zeros(2, np.float32)) == torch.complex64
    assert complex_dtype_for(torch.zeros(2, dtype=torch.complex64),
                             None, 1.0) == torch.complex64
    assert complex_dtype_for(torch.zeros(2, dtype=torch.complex64),
                             np.zeros(2)) == torch.complex128
    assert complex_dtype_for(np.zeros(2, int)) == torch.complex128


# ---------------------------------------------------------------- (iii)
def small_solvers(coupling):
    """A JAX solver and the port's solver on the same operators."""
    rng = np.random.default_rng(11)
    n = 3
    H = rng.standard_normal((n, n))
    H = H + H.T
    bath = j_bath.DrudeBath(temperature=0.3, cutoff=0.5, reorg=0.05)
    c, nu = bath.matsubara(1)
    if coupling == "projector":
        Qs = [np.diag(np.eye(n)[s]) for s in (1, 2)]
    else:
        Q = rng.standard_normal((n, n))
        Qs = [Q + Q.T]
    js = JHEOMSolver(H, bath=[(Q, c, nu) for Q in Qs], lmax=3)
    return js, solver_from_reference(js._H_np, js._modes, js.lmax,
                                     device="cpu")


_JAX_RHS = {}


def jax_rhs_outputs(coupling):
    """JAX 'pallas' and 'einsum' RHS on one seeded ADO stack (cached)."""
    if coupling not in _JAX_RHS:
        js, _ = small_solvers(coupling)
        r_p, nado = js.rhs_fn(jnp.complex128, kernel="pallas")
        r_e, _ = js.rhs_fn(jnp.complex128, kernel="einsum")
        ados = crand(np.random.default_rng(5), nado, js.n, js.n)
        _JAX_RHS[coupling] = (ados, np.asarray(r_p(jnp.asarray(ados))),
                              np.asarray(r_e(jnp.asarray(ados))))
    return _JAX_RHS[coupling]


RHS_CASES = [(k, cpl) for cpl in ("projector", "dense")
             for k in ("einsum", "matmul", "levels", "rowcol", "cuda",
                       "pallas", None)
             if not (k == "rowcol" and cpl == "dense")]


@pytest.mark.parametrize("kernel,coupling", RHS_CASES)
def test_rhs_matches_jax_pallas_and_einsum(kernel, coupling):
    ados, ref_p, ref_e = jax_rhs_outputs(coupling)
    _, ts = small_solvers(coupling)
    rhs, nado = ts.rhs_fn(torch.complex128, kernel=kernel)
    assert nado == ados.shape[0]
    out = rhs(torch.as_tensor(ados)).numpy()
    assert rel_err(out, ref_p) < RTOL
    assert rel_err(out, ref_e) < RTOL


@pytest.mark.parametrize("kernel", ["cuda", "levels", "matmul"])
def test_complex_rates_match_jax_einsum(kernel, monkeypatch):
    """Underdamped/Prony baths carry complex rates. 'cuda' keeps the
    coupling kernel for them (its wrapper is called once per right-hand
    side; the complex damping is applied outside it), and the port's
    'levels' keeps Im(nu) in the damping."""
    from pyqed_tpu_torch.ops import kernels as kn
    calls = []
    wrapper = kn.heom_coupling

    def spy(*args, **kwargs):
        calls.append(kwargs.get("plan"))
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(kn, "heom_coupling", spy)
    H = np.diag([0.0, 1.0])
    Q = np.array([[0.0, 1.0], [1.0, 0.0]])
    bath = [(Q, [0.05 + 0.02j, 0.05 - 0.02j], [0.3 + 0.5j, 0.3 - 0.5j])]
    js = JHEOMSolver(H, bath=bath, lmax=3)
    ts = solver_from_reference(js._H_np, js._modes, js.lmax, device="cpu")
    r_e, nado = js.rhs_fn(jnp.complex128, kernel="einsum")
    ados = crand(np.random.default_rng(3), nado, 2, 2)
    ref = np.asarray(r_e(jnp.asarray(ados)))
    rhs, _ = ts.rhs_fn(torch.complex128, kernel=kernel)
    assert rel_err(rhs(torch.as_tensor(ados)).numpy(), ref) < RTOL
    if kernel == "cuda":
        assert len(calls) == 1 and isinstance(calls[0], kn.CouplingPlan)
    else:
        assert calls == []


# ---------------------------------------------------------------- (v)
_FMO_JAX = {}


def jax_fmo_run(store_ados):
    """JAX FMO slice: lmax=2, nexp=1 Pade (120 ADOs), 50 RK4 steps."""
    if store_ados not in _FMO_JAX:
        m = JFMO()
        js = m.heom(lmax=2, nexp=1, decomposition="pade")
        res = js.run(m.initial_state(0), dt=10.0, nt=50, nout=5,
                     e_ops=m.site_projectors(), kernel="einsum",
                     store_ados=store_ados)
        _FMO_JAX[store_ados] = (js, res)
    return _FMO_JAX[store_ados]


@pytest.mark.parametrize("kernel,store_ados", [(None, False),
                                               ("cuda", False),
                                               ("levels", True)])
def test_fmo_slice_matches_jax(kernel, store_ados):
    js, jr = jax_fmo_run(store_ados)
    assert js._modes is not None and len(js._modes) == 14
    ts = solver_from_reference(js._H_np, js._modes, js.lmax, device="cpu",
                               kernel=kernel)
    m = pt.FMO()
    tr = ts.run(m.initial_state(0), dt=10.0, nt=50, nout=5,
                e_ops=m.site_projectors(), store_ados=store_ados)
    assert tr.ado.shape == (120, 7, 7)
    for field in ("times", "observables", "rho", "ado", "states", "rho0"):
        ours = getattr(tr, field).numpy()
        ref = np.asarray(getattr(jr, field))
        assert ours.shape == ref.shape, field
        assert np.max(np.abs(ours - ref)) <= RESULT_TOL, field
    assert (tr.dt, tr.nt, tr.nout) == (jr.dt, jr.nt, jr.nout)


def test_fmo_model_builds_the_jax_operators():
    jm, m = JFMO(), pt.FMO()
    np.testing.assert_array_equal(m.H.numpy(), np.asarray(jm.H))
    for a, b in zip(m.site_projectors(), jm.site_projectors()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(m.initial_state(3).numpy(),
                                  np.asarray(jm.initial_state(3)))
    ts = m.heom(temperature=300.0, lmax=3, nexp=1, decomposition="pade",
                device="cpu")
    js = jm.heom(temperature=300.0, lmax=3, nexp=1, decomposition="pade")
    assert len(ts._modes) == len(js._modes) == 14
    for (Qa, ca, nua), (Qb, cb, nub) in zip(ts._modes, js._modes):
        np.testing.assert_array_equal(Qa, np.asarray(Qb))
        assert (ca, nua) == (cb, nub)
    assert ts.device == torch.device("cpu")


def test_euler_matches_jax():
    js, ts = small_solvers("dense")
    rho0 = np.diag([1.0, 0.0, 0.0]).astype(complex)
    e_ops = [np.diag([1.0, 0.0, 0.0]), np.diag([0.0, 0.0, 1.0])]
    kw = dict(dt=0.02, nt=30, nout=3, e_ops=e_ops, method="euler")
    jr = js.run(rho0, kernel="einsum", **kw)
    tr = ts.run(rho0, **kw)
    assert np.max(np.abs(tr.observables.numpy()
                         - np.asarray(jr.observables))) <= RESULT_TOL
    assert np.max(np.abs(tr.states.numpy()
                         - np.asarray(jr.states))) <= RESULT_TOL


def test_result_dump_roundtrip(tmp_path):
    _, ts = small_solvers("projector")
    res = ts.run(np.diag([1.0, 0.0, 0.0]), dt=0.05, nt=4, nout=2,
                 e_ops=[np.eye(3)])
    res.dump(tmp_path / "r")
    back = pt.load_result(tmp_path / "r")
    for f in ("times", "observables", "states", "rho", "ado", "rho0"):
        torch.testing.assert_close(getattr(back, f), getattr(res, f))
    assert (back.dt, back.nt, back.nout) == (0.05, 4, 2)


# ---------------------------------------------------------------- (vi)
def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pyqed_tpu'] = None\n"
        "import numpy as np, torch\n"
        "import pyqed_tpu_torch as pt\n"
        "H = np.array([[1.0, 0.2], [0.2, -1.0]])\n"
        "Q = np.diag([1.0, -1.0])\n"
        "b = pt.DrudeBath(temperature=1.0, cutoff=0.5, reorg=0.1)\n"
        "c, nu = b.matsubara(1)\n"
        "for k in ('einsum', 'matmul', 'levels', 'cuda'):\n"
        "    r = pt.HEOMSolver(H, bath=[(Q, c, nu)], lmax=3,\n"
        "                      device='cpu').run(\n"
        "        np.diag([1.0, 0.0]), dt=0.01, nt=20, nout=5,\n"
        "        e_ops=[np.eye(2)], kernel=k)\n"
        "    assert abs(r.observables[-1, 0].item() - 1) < 1e-12\n"
        "import pyqed_tpu_torch.grid as grid\n"
        "x = np.linspace(-8, 8, 32, endpoint=False)\n"
        "for k in ('cuda', 'xla'):\n"
        "    s = grid.SPO2(x, x, nstates=2, kernel=k, device='cpu')\n"
        "    s.set_DPES([0.5 * s.X ** 2, 0.5 * s.Y ** 2 + 1.0],\n"
        "               [[(0, 1), 0.1 + 0 * s.X]])\n"
        "    psi = np.zeros((32, 32, 2), complex)\n"
        "    psi[..., 0] = np.exp(-s.X ** 2 - s.Y ** 2)\n"
        "    r = s.run(psi / np.sqrt(s.norm(psi).item()), dt=0.02, nt=10,\n"
        "              nout=5)\n"
        "    assert abs(r.population[-1].sum().item() - 1) < 1e-12\n"
        "for k in ('cuda', 'matmul'):\n"
        "    r = pt.LindbladSolver(H, [0.3 * pt.sigmam()], kernel=k,\n"
        "                          device='cpu').run(\n"
        "        pt.ket2dm(pt.basis(2, 1)), dt=0.01, Nt=20, nout=5,\n"
        "        e_ops=[np.eye(2)])\n"
        "    assert abs(r.observables[-1, 0].item() - 1) < 1e-12\n"
        "m = pt.FMO()\n"
        "r = m.redfield(device='cpu').run(m.initial_state(0), dt=10.0,\n"
        "                                 Nt=20, nout=5,\n"
        "                                 e_ops=m.site_projectors())\n"
        "assert abs(r.observables[-1].real.sum().item() - 1) < 1e-12\n"
        "from pyqed_tpu_torch.signal import sos, tdes\n"
        "dip = np.zeros((4, 4))\n"
        "dip[0, 1] = dip[1, 0] = dip[1, 3] = dip[3, 1] = 1.0\n"
        "dip[0, 2] = dip[2, 0] = dip[2, 3] = dip[3, 2] = 0.7\n"
        "mol = pt.Mol(np.diag([0.0, 1.0, 1.15, 2.1]), edip=dip)\n"
        "mol.set_decay_for_all(0.02)\n"
        "w = np.linspace(0.7, 1.45, 16)\n"
        "for f in (sos.photon_echo_t2series,\n"
        "          sos.photon_echo_t2series_factored):\n"
        "    S = f(mol, w, w, [0.0, 5.0], e_idx=[1, 2], f_idx=[3],\n"
        "          device='cpu')\n"
        "    assert tuple(S.shape) == (2, 16, 16)\n"
        "t = 0.5 * np.arange(16)\n"
        "R, S, w1, w3 = tdes.twodes(mol, t, [0.0, 5.0], t, device='cpu')\n"
        "assert tuple(S.shape) == (16, 2, 16)\n"
        "d = pt.DEOMSolver(system=H, bath=pt.DEOMBath.drude(\n"
        "    temperature=1.0, cutoff=0.5, reorg=0.1, npsd=1), coupling=Q,\n"
        "    lmax=2, device='cpu')\n"
        "r = d.run(np.diag([1.0, 0.0]), dt=0.01, nt=20, nout=5)\n"
        "assert abs(r.observables[-1, 0].item() - 1) < 1e-12\n"
        "sx = np.array([[0.0, 1.0], [1.0, 0.0]])\n"
        "S = d.correlation_4op_3t_gmres(sx, sx, sx, sx, np.diag([1.0, 0.0]),\n"
        "                               1.0, [0.7], [-0.7], nt_T=20)\n"
        "assert tuple(S.shape) == (1, 1)\n"
        "pulse = pt.GaussianPulse(omegac=1.0, tau=2.0, amplitude=0.1)\n"
        "r = pt.HEOMSolver(H, bath=[(Q, c, nu)], lmax=2, device='cpu').run(\n"
        "    np.diag([1.0, 0.0]), dt=0.01, nt=20, nout=5, e_ops=[np.eye(2)],\n"
        "    edip=sx, pulse=pulse.efield)\n"
        "assert abs(r.observables[-1, 0].item() - 1) < 1e-12\n"
        "pol = pt.QRM(1.0, 1.0, ncav=3)\n"
        "pol.g = 0.05\n"
        "pol.getH()\n"
        "r = pol.driven_dynamics(np.eye(6)[0], pulse, dt=0.005, nt=20,\n"
        "                        device='cpu')\n"
        "assert abs(torch.linalg.norm(r.psi).item() - 1) < 1e-10\n"
        "q = pt.floquet.Floquet(np.diag([0.0, 1.0]), sx, 0.8, 0.1, nt=5,\n"
        "                       device='cpu').quasienergies()\n"
        "assert tuple(q.shape) == (10,)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "               'pyqed_tpu.')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


# ---------------------------------------------------------------- (vii)
def test_cuda_device_without_card_raises():
    """Entry points default to the card; without one they raise, whether
    CUDA is asked for or left to the default."""
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        assert resolve_device(None).type == "cuda"
        return
    H = np.diag([0.0, 1.0])
    bath = [(np.diag([1.0, -1.0]), [0.1], [0.5])]
    x = np.linspace(-1, 1, 8)
    for make in (lambda: resolve_device("cuda"),
                 lambda: resolve_device(None),
                 lambda: pt.FMO().heom(lmax=1, device="cuda"),
                 lambda: pt.FMO().heom(lmax=1),
                 lambda: HEOMSolver(H, bath),
                 lambda: pt.SPO(x),
                 lambda: pt.SPO3(x, x, x, device="cuda")):
        with pytest.raises(RuntimeError):
            make()
    assert resolve_device("cpu").type == "cpu"


def test_auto_kernel_on_cpu_is_einsum_and_launches_nothing():
    from pyqed_tpu_torch.ops import kernels as kn
    _, ts = small_solvers("projector")
    kn.heom_coupling.launches = 0
    ts.run(np.diag([1.0, 0.0, 0.0]), dt=0.05, nt=4, kernel="cuda")
    ts.run(np.diag([1.0, 0.0, 0.0]), dt=0.05, nt=4)
    assert kn.heom_coupling.launches == 0


# ------------------------------------------------- not yet ported options
STILL_UNPORTED = ("matmul-fast",)


def _unported(case, tmp_path):
    _, ts = small_solvers("projector")
    rho0 = np.diag([1.0, 0.0, 0.0])
    run = dict(dt=0.1, nt=2)
    ck = str(tmp_path / "ck.npz")
    calls = {
        "mesh": lambda: HEOMSolver(np.eye(2), mesh=object()),
        "run mesh": lambda: ts.run(rho0, mesh=object(), **run),
        "checkpoint": lambda: ts.run(rho0, checkpoint=ck, **run),
        "resume": lambda: (ts.run(rho0, checkpoint=ck, dt=0.1, nt=1),
                           ts.run(rho0, resume=ck, **run))[1],
        "drive": lambda: ts.run(rho0, edip=np.eye(3), pulse=lambda t: 0.0,
                                **run),
        "levels-fast": lambda: ts.run(rho0, kernel="levels-fast", **run),
        "matmul-fast": lambda: HEOMSolver(np.eye(2), kernel="matmul-fast",
                                          device="cpu"),
        "correlation_3op_1t": lambda: ts.correlation_3op_1t(
            rho0, [np.eye(3)] * 3, 0.1, 2),
        "correlation_2op_1t": lambda: ts.correlation_2op_1t(
            rho0, np.eye(3), np.eye(3), 0.1, 2),
        "correlation_3op_2t": lambda: ts.correlation_3op_2t(
            rho0, [np.eye(3)] * 3, 0.1, 2, 2),
        "liouvillian_dense": lambda: ts.liouvillian_dense(),
        "steady_state": lambda: ts.steady_state(),
        "propagator": lambda: ts.propagator(0.1, 2),
        "absorption": lambda: ts.absorption(np.ones(2), np.eye(3), ntau=4),
        "HEOMSolverDrude": lambda: HEOMSolverDrude(np.eye(2), device="cpu"),
    }
    return calls[case]


@pytest.mark.parametrize("case", [
    "mesh", "run mesh", "checkpoint", "resume", "drive", "levels-fast",
    "matmul-fast", "correlation_3op_1t", "correlation_2op_1t",
    "correlation_3op_2t", "liouvillian_dense", "steady_state", "propagator",
    "absorption", "HEOMSolverDrude"])
def test_unported_options_raise(case, tmp_path):
    """``matmul-fast``, no JAX kernel, still raises "not yet ported". The
    other options of this list were ported and now run: a sharded solver
    or run takes a torch.distributed DeviceMesh and refuses anything else
    (the sharded runs themselves are held to JAX's and to the unsharded
    ones in tests/test_torch_parallel.py); ``levels-fast`` is ``levels``
    at complex128 (its parity with JAX's is test_levels_fast_matches_jax);
    a checkpointed run, a resumed run and a zero drive give the undriven
    run's rows exactly; correlations of identities are 1 (the hierarchy
    keeps the trace); the dense forms have the hierarchy's size. Their
    parity with JAX is in tests/test_torch_heom_driven.py."""
    call = _unported(case, tmp_path)
    if case in STILL_UNPORTED:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()
        return
    if case in ("mesh", "run mesh"):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
        return
    out = call()
    _, ts = small_solvers("projector")
    D = ts.rhs_fn(torch.complex128)[1] * 9
    if case == "levels-fast":
        full = ts.run(np.diag([1.0, 0.0, 0.0]), dt=0.1, nt=2,
                      kernel="levels")
        assert torch.equal(out.states, full.states)
    elif case in ("checkpoint", "resume", "drive"):
        full = ts.run(np.diag([1.0, 0.0, 0.0]), dt=0.1, nt=2)
        assert torch.equal(out.states, full.states[-len(out.states):])
    elif case.startswith("correlation"):
        assert (out - 1).abs().max().item() < 1e-12
    elif case == "liouvillian_dense":
        assert tuple(out.shape) == (D, D) and torch.isfinite(out).all()
    elif case == "propagator":
        assert tuple(out.shape) == (3, D, D)
        eye = torch.eye(D, dtype=out.dtype)
        assert (out[0] - eye).abs().max().item() < 1e-12
    elif case == "steady_state":
        assert abs(torch.trace(out).item() - 1) < 1e-12
        assert (out - out.mH).abs().max().item() < 1e-12
    elif case == "absorption":
        assert out.shape == (2,) and np.isfinite(out).all()
    else:
        assert isinstance(out, HEOMSolverDrude) and out.device.type == "cpu"


def test_levels_fast_matches_jax():
    """JAX's ``levels-fast`` runs its levels form at Precision.DEFAULT,
    which on the CPU in float64 gives the numbers of ``levels``; the
    port's ``levels-fast`` is its ``levels``. Held at 1e-12."""
    js, ts = small_solvers("dense")
    rho0 = np.diag([1.0, 0.0, 0.0]).astype(complex)
    e_ops = [np.diag([1.0, 0.0, 0.0]), np.diag([0.0, 0.0, 1.0])]
    kw = dict(dt=0.02, nt=30, nout=3, e_ops=e_ops, kernel="levels-fast")
    jr = js.run(rho0, **kw)
    tr = ts.run(rho0, **kw)
    for field in ("observables", "states", "rho"):
        assert np.max(np.abs(getattr(tr, field).numpy()
                             - np.asarray(getattr(jr, field)))) <= RTOL


def test_unknown_kernel_raises():
    with pytest.raises(ValueError):
        HEOMSolver(np.eye(2), kernel="triton", device="cpu")

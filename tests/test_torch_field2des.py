"""Parity of the PyTorch port's explicit-field 2DES (pyqed_tpu_torch:
signal/field2des, and the batched HEOM right-hand sides and coupling
kernel it runs on) with the JAX package, on the CPU at complex128.

The same numpy inputs go through ``pyqed_tpu.signal.field2des`` (kernel
``einsum``) and the port, whose ``einsum`` and ``cuda`` forms both run
here (``cuda`` on CPU tensors is the batched plain version of the
coupling kernel). Each JAX propagation compiles its own program, so the
references are computed once per module (the ``jref`` fixture). JAX's
``kernel='pallas'`` is not run: its interpret mode under ``vmap`` takes
over two minutes for the smallest case here. Tolerances: P3 relative to
its largest entry 1e-12 (phase cycling cancels the first- and
second-order signals, which are larger by 1/E^2, so the comparison
carries that factor over rounding); the plain batched operators 1e-14.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu import DrudeBath as JDrudeBath
from pyqed_tpu import HEOMSolver as JHEOMSolver
from pyqed_tpu.signal import field2des as jf

import pyqed_tpu_torch as pt
from pyqed_tpu_torch.ops import kernels as kn
from pyqed_tpu_torch.signal import field2des as tf

RTOL = 1e-12
PULSES = dict(t2=0.5, dt=0.02, pulse_width=0.3, e_amps=(0.05, 0.05, 0.05),
              omega_c=1.0)
SZ = np.diag([1.0, -1.0])
SX = np.array([[0.0, 1.0], [1.0, 0.0]])


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


def tls():
    """tests/test_field2des.py's two-level system (Drude bath on sz,
    Pade 1, lmax 1): (H, bath kwargs, rho0, mu, t1s, nt3)."""
    return (0.5 * SZ, [SZ], 1, np.diag([1.0, 0.0]), SX,
            np.arange(4) * 0.4, 64)


def three_level():
    """Ground + two coupled excited states, a Drude bath on each excited
    site (Pade 1: M = 4), lmax 2 (15 ADOs); mu couples the ground state
    to both."""
    H = np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.05], [0.0, 0.05, 1.1]])
    Q = [np.diag([0.0, 1.0, 0.0]), np.diag([0.0, 0.0, 1.0])]
    mu = np.array([[0.0, 1.0, 0.7], [1.0, 0.0, 0.0], [0.7, 0.0, 0.0]])
    return H, Q, 2, np.diag([1.0, 0.0, 0.0]), mu, np.arange(3) * 0.4, 32


SYSTEMS = {"tls": tls, "three_level": three_level}
BATH = dict(temperature=0.5, cutoff=0.5, reorg=0.01)


def solvers(name):
    H, Q, lmax, rho0, mu, t1s, nt3 = SYSTEMS[name]()
    jb = JDrudeBath(**BATH)
    jb.set_bath_ops([jnp.asarray(q) for q in Q])
    js = JHEOMSolver(jnp.asarray(H, dtype=complex), bath=jb, lmax=lmax,
                     decomposition="pade", nexp=1)
    tb = pt.DrudeBath(**BATH)
    tb.set_bath_ops(Q)
    ts = pt.HEOMSolver(H.astype(complex), bath=tb, lmax=lmax,
                       decomposition="pade", nexp=1, device="cpu")
    return js, ts, rho0, mu, t1s, nt3


@pytest.fixture(scope="module")
def jref():
    out = {}
    for name in SYSTEMS:
        js, _, rho0, mu, t1s, nt3 = solvers(name)
        out[name] = jf.field_2des_rephasing(js, rho0, mu, t1s, nt3=nt3,
                                            **PULSES)
    return out


@pytest.mark.parametrize("kernel", ["einsum", "cuda"])
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_rephasing_matches_jax(jref, name, kernel):
    _, ts, rho0, mu, t1s, nt3 = solvers(name)
    P3, t1, t3 = tf.field_2des_rephasing(ts, rho0, mu, t1s, nt3=nt3,
                                         kernel=kernel, **PULSES)
    jP3, jt1, jt3 = jref[name]
    assert np.abs(host(P3)).max() > 1e-8
    assert rel_err(P3, jP3) < RTOL
    np.testing.assert_array_equal(host(t1), jt1)
    np.testing.assert_allclose(host(t3), jt3, rtol=1e-15, atol=0)


def test_rephasing_spectrum_matches_jax(jref):
    P3, t1s, t3s = jref["tls"]
    w1, w3, S = jf.rephasing_spectrum(P3, t1s, t3s)
    tw1, tw3, tS = tf.rephasing_spectrum(torch.as_tensor(P3), t1s, t3s)
    assert rel_err(tS, S) < 1e-14
    assert rel_err(tw1, w1) < 1e-15 and rel_err(tw3, w3) < 1e-15


def test_no_third_pulse_cancels():
    """Without the third pulse the phase-cycled signal vanishes: no
    second-order term carries polarization."""
    _, ts, rho0, mu, t1s, nt3 = solvers("tls")
    P3, _, _ = tf.field_2des_rephasing(ts, rho0, mu, t1s, nt3=nt3,
                                       **PULSES)
    zero = dict(PULSES, e_amps=(0.05, 0.05, 0.0))
    P30, _, _ = tf.field_2des_rephasing(ts, rho0, mu, t1s, nt3=nt3, **zero)
    assert np.abs(host(P30)).max() / np.abs(host(P3)).max() < 1e-10


def test_mesh_raises():
    """mesh= takes a torch.distributed DeviceMesh (the sharded run is held
    to JAX's in tests/test_torch_parallel.py) and refuses anything else."""
    _, ts, rho0, mu, t1s, nt3 = solvers("tls")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tf.field_2des_rephasing(ts, rho0, mu, t1s, nt3=nt3, mesh=object(),
                                **PULSES)


# ------------------------------------- the batched operators beneath it
def crand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("B", [1, 7])
def test_batched_coupling_ref_matches_single_calls(B, dtype):
    """heom_coupling_ref on F (nado, B, V) equals B calls on (nado, V);
    on CPU tensors the wrapper is that plain version and launches
    nothing."""
    _, ts, *_ = solvers("three_level")
    keys, plus_idx, minus_idx, Q, c, _ = ts._build(dtype)
    _, OpT, nbr, w = kn.heom_coupling_operands(ts._H_np, Q, c, keys,
                                               plus_idx, minus_idx)
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    nbr, w = torch.as_tensor(nbr), torch.as_tensor(w, dtype=rdt)
    OpT = torch.as_tensor(OpT, dtype=dtype)
    F = torch.as_tensor(crand(np.random.default_rng(B), keys.shape[0], B,
                              OpT.shape[-1]), dtype=dtype)
    ref = torch.stack([kn.heom_coupling_ref(F[:, b].contiguous(), nbr, w,
                                            OpT) for b in range(B)], 1)
    out = kn.heom_coupling_ref(F, nbr, w, OpT)
    tol = 1e-14 if dtype == torch.complex128 else 1e-6
    assert rel_err(out, ref) < tol
    kn.heom_coupling.launches = 0
    plan = kn.heom_coupling_plan(nbr, w)
    torch.testing.assert_close(kn.heom_coupling(F, nbr, w, OpT, plan=plan),
                               out, rtol=0, atol=0)
    assert kn.heom_coupling.launches == 0


def test_batched_coupling_rejects_bad_batches():
    _, ts, *_ = solvers("three_level")
    keys, plus_idx, minus_idx, Q, c, _ = ts._build(torch.complex128)
    _, OpT, nbr, w = kn.heom_coupling_operands(ts._H_np, Q, c, keys,
                                               plus_idx, minus_idx)
    nbr, w, OpT = (torch.as_tensor(x) for x in (nbr, w, OpT))
    V = OpT.shape[-1]
    for F in (torch.zeros((keys.shape[0], 2, 3, V), dtype=OpT.dtype),
              torch.zeros((keys.shape[0] - 1, 2, V), dtype=OpT.dtype),
              torch.zeros((keys.shape[0], 2, V + 1), dtype=OpT.dtype)):
        with pytest.raises(ValueError, match="shapes"):
            kn.heom_coupling(F, nbr, w, OpT)


@pytest.mark.parametrize("kernel", ["einsum", "matmul", "levels", "rowcol",
                                    "cuda"])
def test_batched_rhs_matches_single_calls(kernel):
    """Every kernel's right-hand side takes a (nado, B, n, n) batch and
    gives the B single results; the unbatched call is unchanged."""
    H, Q, *_ = three_level()
    sol = pt.HEOMSolver(H, bath=[(q, *pt.DrudeBath(**BATH).pade(1))
                                 for q in Q], lmax=2, device="cpu")
    rhs, nado = sol.rhs_fn(torch.complex128, kernel=kernel)
    y = torch.as_tensor(crand(np.random.default_rng(5), nado, 5, 3, 3))
    ref = torch.stack([rhs(y[:, b].contiguous()) for b in range(5)], 1)
    assert rel_err(rhs(y), ref) < 1e-14

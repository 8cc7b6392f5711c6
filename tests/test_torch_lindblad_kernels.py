"""Parity of the PyTorch port's Lindblad operators (pyqed_tpu_torch/ops)
with the JAX package's, on the CPU: the Liouvillian commutator kernel's
wrapper and plain version, liouvillian_matvec, and the modules the
Lindblad slice stands on (superoperator, linalg, operators, expm).

The same inputs, made with numpy from a seed, go through the JAX function
(the Pallas commutator in interpret mode) and the port's counterpart; the
two are compared as numpy arrays. Tolerances: rel 1e-12 for kernels,
right-hand sides and exact algebra at complex128 (the gate of
tests/test_pallas.py's HEOM kernels), rel 1e-5 at complex64, 1e-10 for
propagated fields. The CUDA kernel runs only on a GPU (chip_smoke.py);
here its wrapper takes the plain version because the tensors lie on the
CPU.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.ops import linalg as j_linalg
from pyqed_tpu.ops import operators as j_ops
from pyqed_tpu.ops import pallas_kernels as pk
from pyqed_tpu.ops import superoperator as j_sop
from pyqed_tpu_torch.ops import _cuda_lib
from pyqed_tpu_torch.ops import kernels as kn
from pyqed_tpu_torch.ops import linalg as t_linalg
from pyqed_tpu_torch.ops import operators as t_ops
from pyqed_tpu_torch.ops import superoperator as t_sop

# the modules, not the functions that pyqed_tpu.ops and pyqed_tpu_torch.ops
# export under their name
j_expm = importlib.import_module("pyqed_tpu.ops.expm")
t_expm = importlib.import_module("pyqed_tpu_torch.ops.expm")

RTOL = 1e-12         # kernels, right-hand sides, exact algebra (c128)
RTOL_C64 = 1e-5      # kernels at complex64
FIELD_TOL = 1e-10    # propagated fields


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


def herm(rng, n):
    a = crand(rng, n, n)
    return (a + a.conj().T) / 2


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ------------------------------------------------- the commutator kernel
@pytest.mark.parametrize("n", [12, 37])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_commutator_matches_pallas_interpret(n, dtype):
    """Wrapper and plain version == pk.liouvillian_commutator_pallas
    (interpret mode) on a random non-Hermitian H_eff."""
    rng = np.random.default_rng(n)
    H, rho = crand(rng, n, n), crand(rng, n, n)
    npdt = np.complex128 if dtype == torch.complex128 else np.complex64
    H, rho = H.astype(npdt), rho.astype(npdt)
    ref = np.asarray(pk.liouvillian_commutator_pallas(
        jnp.asarray(H), jnp.asarray(rho), interpret=True))
    tol = RTOL if dtype == torch.complex128 else RTOL_C64
    kn.liouvillian_commutator.launches = 0
    out = kn.liouvillian_commutator(t(H), t(rho))
    assert kn.liouvillian_commutator.launches == 0
    assert out.dtype == dtype
    assert rel_err(out.numpy(), ref) < tol
    plain = kn.liouvillian_commutator_ref(t(H), t(rho))
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def _bad_commutator_args(case):
    rng = np.random.default_rng(0)
    H, rho = t(crand(rng, 5, 5)), t(crand(rng, 5, 5))
    if case == "real":
        return (H.real.contiguous(), rho.real.contiguous()), TypeError
    if case == "mixed dtype":
        return (H.to(torch.complex64), rho), TypeError
    if case == "not square":
        return (H[:4].contiguous(), rho[:4].contiguous()), ValueError
    if case == "shapes differ":
        return (H[:4, :4].contiguous(), rho), ValueError
    if case == "noncontiguous":
        return (H.t(), rho), ValueError
    if case == "lazy conj":
        return (H.conj(), rho), ValueError
    if case == "meta device":
        return (H.to("meta"), rho.to("meta")), ValueError
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["real", "mixed dtype", "not square",
                                  "shapes differ", "noncontiguous",
                                  "lazy conj", "meta device"])
def test_commutator_rejects_bad_arguments(case):
    args, exc = _bad_commutator_args(case)
    with pytest.raises(exc):
        kn.liouvillian_commutator(*args)


def test_liouvillian_matvec_matches_jax():
    """Port liouvillian_matvec (kernel wrapper and inline forms) ==
    pk.liouvillian_matvec(use_pallas=True, interpret=True) and == the
    JAX liouvillian_action at n = 12 with two jump operators."""
    rng = np.random.default_rng(12)
    n = 12
    H = herm(rng, n)
    cs = [0.3 * crand(rng, n, n) for _ in range(2)]
    rho = crand(rng, n, n)
    jcs = [jnp.asarray(c) for c in cs]
    ref_p = np.asarray(pk.liouvillian_matvec(
        jnp.asarray(H), jcs, use_pallas=True, interpret=True)(
            jnp.asarray(rho)))
    ref_a = np.asarray(j_sop.liouvillian_action(jnp.asarray(H), jcs)(
        jnp.asarray(rho)))
    for use_kernel in (None, True, False):
        L = kn.liouvillian_matvec(t(H), [t(c) for c in cs],
                                  use_kernel=use_kernel)
        out = L(t(rho)).numpy()
        assert rel_err(out, ref_p) < RTOL
        assert rel_err(out, ref_a) < RTOL
    no_jump = kn.liouvillian_matvec(t(H))(t(rho)).numpy()
    assert rel_err(no_jump, -1j * (H @ rho - rho @ H)) < RTOL


def test_cuda_entry_points_match_ctypes_signatures():
    """Every extern "C" function of csrc/liouvillian.cu has argtypes in
    _cuda_lib with as many entries as the C function has parameters."""
    src = (Path(_cuda_lib.CSRC) / "liouvillian.cu").read_text()
    found = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        found[name] = len([p for p in params.split(",") if p.strip()])
    sigs = _cuda_lib.SIGNATURES["liouvillian"]
    assert set(found) == {"liouvillian_commutator_c128",
                          "liouvillian_commutator_c64"}
    assert set(found) == set(sigs)
    for name, nparams in found.items():
        assert len(sigs[name]) == nparams


# ------------------------------------------------------- superoperator
def sop_inputs():
    rng = np.random.default_rng(3)
    n = 4
    return rng, n, herm(rng, n), crand(rng, n, n), crand(rng, n, n)


@pytest.mark.parametrize("name", [
    "dm2vec", "vec2dm", "left", "right", "op2sop-", "op2sop+", "op2sopl",
    "op2sopr", "lindblad_dissipator", "kraus", "liouvillian",
    "lindbladian_action", "liouvillian_action", "obs_vec", "trace_vec",
    "resolvent"])
def test_superoperator_matches_jax(name):
    rng, n, H, a, rho = sop_inputs()
    c = 0.4 * crand(rng, n, n)
    J, T = jnp.asarray, t
    calls = {
        "dm2vec": lambda m: m.dm2vec(X(rho)),
        "vec2dm": lambda m: m.vec2dm(X(rho.reshape(-1))),
        "left": lambda m: m.left(X(a)),
        "right": lambda m: m.right(X(a)),
        "op2sop-": lambda m: m.op2sop(X(a)),
        "op2sop+": lambda m: m.op2sop(X(a), "anticommutator"),
        "op2sopl": lambda m: m.operator_to_superoperator(X(a), "l"),
        "op2sopr": lambda m: m.to_super(X(a), "r"),
        "lindblad_dissipator": lambda m: m.lindblad_dissipator(X(c)),
        "kraus": lambda m: m.kraus(X(c)),
        "liouvillian": lambda m: m.liouvillian(X(H), [X(c), X(a)]),
        "lindbladian_action": lambda m: m.lindbladian_action(X(c), X(rho)),
        "liouvillian_action": lambda m: m.liouvillian_action(
            X(H), [X(c)])(X(rho)),
        "obs_vec": lambda m: m.obs_vec(X(rho.reshape(-1)), X(a)),
        "trace_vec": lambda m: m.trace_vec(X(rho.reshape(-1))),
        "resolvent": lambda m: m.resolvent(0.7 + 0.2j, m.liouvillian(
            X(H), [X(c)])),
    }
    X = J
    ref = np.asarray(calls[name](j_sop))
    X = T
    out = calls[name](t_sop).numpy()
    assert out.shape == ref.shape
    assert rel_err(out, ref) < RTOL
    assert t_sop.mat2vec_index(n, 2, 3) == j_sop.mat2vec_index(n, 2, 3)
    assert t_sop.vec2mat_index(n, 11) == j_sop.vec2mat_index(n, 11)


def test_liouvillian_matches_dense_action_and_real_input():
    """The dense L applied to vec(ρ) is the matrix-free action; a real H
    and real jump give the JAX package's complex128 L."""
    rng, n, H, a, rho = sop_inputs()
    Hr = H.real.copy()
    cr = rng.standard_normal((n, n))
    L = t_sop.liouvillian(Hr, [cr])
    assert L.dtype == torch.complex128
    assert rel_err(L.numpy(), np.asarray(j_sop.liouvillian(
        jnp.asarray(Hr), [jnp.asarray(cr)]))) < RTOL
    act = t_sop.liouvillian_action(t(Hr).to(torch.complex128),
                                   [t(cr).to(torch.complex128)])(t(rho))
    assert rel_err((L @ t(rho).reshape(-1)).numpy(),
                   act.reshape(-1).numpy()) < RTOL


# ---------------------------------------------------------------- linalg
@pytest.mark.parametrize("name", [
    "dag", "dag_ket", "commutator", "anticommutator", "tensor", "tensor_list",
    "tensor_power", "ptraceB", "ptraceA", "transform", "obs", "obs_dm",
    "expect_ket", "expect_dm", "overlap", "ket2dm", "norm", "rk4", "project",
    "lindbladian", "ldo", "eigh", "eigh_k"])
def test_linalg_matches_jax(name):
    rng = np.random.default_rng(5)
    n = 4
    A, B = crand(rng, n, n), crand(rng, n, n)
    Hh = herm(rng, n)
    psi = crand(rng, n)
    rho6 = crand(rng, 6, 6)
    calls = {
        "dag": lambda m: m.dag(X(A)),
        "dag_ket": lambda m: m.dag(X(psi)),
        "commutator": lambda m: m.commutator(X(A), X(B)),
        "anticommutator": lambda m: m.anticomm(X(A), X(B)),
        "tensor": lambda m: m.tensor(X(A), X(B[:2, :2]), X(A[:3, :3])),
        "tensor_list": lambda m: m.tensor([X(A), X(B)]),
        "tensor_power": lambda m: m.tensor_power(X(A[:2, :2]), 3),
        "ptraceB": lambda m: m.ptrace(X(rho6), (2, 3), "B"),
        "ptraceA": lambda m: m.ptrace(X(rho6), (2, 3), "A"),
        "transform": lambda m: m.transform(X(A), X(B)),
        "obs": lambda m: m.obs(X(psi), X(A)),
        "obs_dm": lambda m: m.obs_dm(X(B), X(A)),
        "expect_ket": lambda m: m.expect(X(psi), X(A)),
        "expect_dm": lambda m: m.expect(X(B), X(A)),
        "overlap": lambda m: m.overlap(X(psi), X(A[0])),
        "ket2dm": lambda m: m.ket2dm(X(psi)),
        "norm": lambda m: m.norm(X(psi), 0.3),
        "rk4": lambda m: m.rk4(X(psi), lambda y, s: s * (X(A) @ y), 0.01,
                               -1j),
        "project": lambda m: m.project(X(A), X(B)),
        "lindbladian": lambda m: m.lindbladian(X(A), X(B)),
        "ldo": lambda m: m.ldo(X(psi), X(A)),
        "eigh": lambda m: m.eigh(X(Hh))[0],
        "eigh_k": lambda m: m.eigh(X(Hh), k=2)[0],
    }
    X = jnp.asarray
    ref = np.asarray(calls[name](j_linalg))
    X = t
    out = np.asarray(calls[name](t_linalg))
    assert out.shape == ref.shape
    assert rel_err(out, ref) < RTOL


def test_linalg_predicates_sorting_and_eigs():
    rng = np.random.default_rng(6)
    n = 5
    Hh = herm(rng, n)
    U = np.linalg.qr(crand(rng, n, n))[0]
    A = crand(rng, n, n)
    assert t_linalg.isherm(t(Hh)) and not t_linalg.isherm(t(A))
    assert t_linalg.isunitary(t(U)) and not t_linalg.isunitary(t(A))
    assert t_linalg.isdiag(t(np.diag(np.arange(3.0))))
    assert not t_linalg.isdiag(t(A))
    # sorting: real and complex eigenvalues, as JAX sorts them
    w = rng.standard_normal(n)
    wc = np.array([1 + 2j, 1 - 1j, -3 + 0j, 1 + 0j, 0.5j])
    for vals in (w, wc):
        a, b = t_linalg.sort_eig(t(vals), t(A))
        ja, jb = j_linalg.sort_eig(jnp.asarray(vals), jnp.asarray(A))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    # eig_asymm: same sorted spectrum, eigenvectors that diagonalise A
    e, c = t_linalg.eig_asymm(t(A))
    je, _ = j_linalg.eig_asymm(jnp.asarray(A))
    assert rel_err(e.numpy(), np.asarray(je)) < RTOL
    assert rel_err((t(A) @ c).numpy(), (c * e).numpy()) < RTOL
    er, _ = t_linalg.eig_asymm(t(np.diag([3.0, 1.0, 2.0])))
    assert not er.is_complex()
    np.testing.assert_array_equal(er.numpy(), [1.0, 2.0, 3.0])


def test_prefix_and_magnus_propagators_match_jax():
    rng = np.random.default_rng(0)
    n, nsteps, dt = 6, 8, 0.01
    H0 = rng.standard_normal((n, n))
    H0 = (H0 + H0.T) / 2
    mu = rng.standard_normal((n, n))
    mu = (mu + mu.T) / 2
    ts = dt * np.arange(nsteps)
    Hmid = H0[None] + (0.05 * np.cos(1.05 * (ts + dt / 2)))[:, None,
                                                             None] * mu
    Us = t_linalg.magnus2_propagators(t(Hmid), dt)
    jUs = j_linalg.magnus2_propagators(jnp.asarray(Hmid), dt)
    assert rel_err(Us.numpy(), np.asarray(jUs)) < RTOL
    pref = t_linalg.prefix_propagators(Us)
    jpref = j_linalg.prefix_propagators(jUs)
    assert np.max(np.abs(pref.numpy() - np.asarray(jpref))) < FIELD_TOL


# ------------------------------------------------------------- operators
# one Hilbert-space size (5) wherever the constructor allows it, so the
# JAX references share their compiled primitives
OPERATOR_CASES = {
    "pauli": lambda m: np.stack([np.asarray(x) for x in m.pauli()]),
    "sigmax": lambda m: m.sigmax(), "sigmay": lambda m: m.sigmay(),
    "sigmaz": lambda m: m.sigmaz(), "sigmam": lambda m: m.sigmam(),
    "sigmap": lambda m: m.sigmap(), "destroy": lambda m: m.destroy(5),
    "create": lambda m: m.create(5), "basis": lambda m: m.basis(5, 2),
    "coh_op": lambda m: m.coh_op(1, 3, 5), "jump": lambda m: m.jump(0, 2, 5),
    "jump_nh": lambda m: m.jump(0, 2, 5, isherm=False),
    "ham_ho": lambda m: m.ham_ho(0.7, 5, ZPE=True),
    "boson": lambda m: m.boson(0.3, 5), "quadrature": lambda m: m.quadrature(5),
    "position": lambda m: m.position(5), "momentum": lambda m: m.momentum(5),
    "num": lambda m: m.num(5), "thermal_dm": lambda m: m.thermal_dm(5, 0.4),
    "spin_ops": lambda m: np.stack([np.asarray(x) for x in m.spin_ops(5)]),
    "multispin": lambda m: m.multispin(0.5, 0.1, 3)[0],
    "multispin_lowering": lambda m: m.multispin(0.5, 0.1, 3)[1][1],
    "multiboson": lambda m: m.multiboson(0.4, 2, J=0.05, truncate=3)[0],
    "multimode": lambda m: m.multimode([0.3, 0.5], 2, J=0.1, truncate=3)[0],
    "displace": lambda m: m.displace(5, 0.3 + 0.2j),
    "coherent": lambda m: m.coherent(5, 0.5),
    "coherent_dm": lambda m: m.coherent_dm(5, 0.2 - 0.1j),
    "lowering": lambda m: m.lowering(), "raising": lambda m: m.raising(),
    "multi_spin": lambda m: m.multi_spin([0.2, 0.5], 2)[0],
    "multi_spin_sum": lambda m: m.multi_spin(0.3, 3)[1],
    "norm2": lambda m: m.norm2(np.arange(12.0).reshape(3, 4), 0.5, 0.2),
    "direct_product": lambda m: m.direct_product(m.sigmax(), m.sigmaz()),
    "jacobi_anger": lambda m: m.jacobi_anger(3, 0.7),
    "propagator": lambda m: m.propagator(m.jump(0, 1, 5) + m.num(5), 0.6),
    "propagator_t": lambda m: m.propagator_H_const(
        m.jump(0, 1, 5) + m.num(5), np.array([0.0, 0.3, 0.9])),
}


@pytest.mark.parametrize("name", sorted(OPERATOR_CASES))
def test_operators_match_jax(name):
    ref = np.asarray(OPERATOR_CASES[name](j_ops))
    out = np.asarray(OPERATOR_CASES[name](t_ops))
    assert out.shape == ref.shape
    assert out.dtype == ref.dtype
    assert np.max(np.abs(out - ref)) <= RTOL * max(1.0, np.max(np.abs(ref)))


def test_operator_scalars_and_dtype():
    assert t_ops.delta(2, 2) == j_ops.delta(2, 2) == 1.0
    assert t_ops.delta(1, 2) == 0.0
    assert t_ops.is_positive_def(np.diag([1.0, 2.0]))
    assert not t_ops.is_positive_def(np.diag([1.0, -2.0]))
    assert t_ops.sigmaz(torch.complex64).dtype == torch.complex64
    assert t_ops.destroy(3).device.type == "cpu"
    with pytest.raises(ValueError):
        t_ops.basis(2, 2)
    with pytest.raises(ValueError):
        t_ops.lowering(3)


# ------------------------------------------------------------------ expm
def expm_inputs():
    rng = np.random.default_rng(8)
    n = 5
    return rng, herm(rng, n), crand(rng, n), crand(rng, n, n)


@pytest.mark.parametrize("name", ["expm_eig", "expm_herm", "diag", "rk4",
                                  "expm", "expm_t"])
def test_expm_dense_matches_jax(name):
    _, H, _, A = expm_inputs()
    calls = {
        "expm_eig": lambda m: m.expm_eig(X(H), 0.7),
        "expm_herm": lambda m: m.expm_herm(X(H), 0.4, prefactor=-0.5),
        "diag": lambda m: m.propagators(X(H), 0.05, 20),
        "rk4": lambda m: m.propagators(X(H), 0.01, 20, method="rk4"),
        "expm": lambda m: m.expm(X(0.3 * A), 0.8),
        "expm_t": lambda m: m.expm(X(0.3 * A), np.array([0.0, 0.5, 1.1])),
    }
    X = jnp.asarray
    ref = np.asarray(calls[name](j_expm))
    X = t
    out = calls[name](t_expm).numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) < FIELD_TOL


def test_expm_multiply_engines_match_jax():
    """Taylor and Krylov actions on a Lindblad matvec, Chebyshev on a
    Hermitian H, against the JAX engines on the same inputs. The
    Chebyshev weights come from scipy.special.jv on the host, the JAX
    ones from jax.scipy.special.bessel_jn: they agree to 1e-12 here."""
    rng, H, b, A = expm_inputs()
    n = H.shape[0]
    c = 0.3 * crand(rng, n, n)
    rho = crand(rng, n, n)
    jL = j_sop.liouvillian_action(jnp.asarray(H), [jnp.asarray(c)])
    tL = t_sop.liouvillian_action(t(H), [t(c)])
    kw = dict(dt=0.5, order=8, nsub=3)
    ref = np.asarray(j_expm.expm_multiply_taylor(jL, jnp.asarray(rho), **kw))
    out = t_expm.expm_multiply_taylor(tL, t(rho), **kw).numpy()
    assert rel_err(out, ref) < RTOL
    ref = np.asarray(j_expm.krylov_expm_multiply(jL, jnp.asarray(rho),
                                                 dt=0.3, m=5))
    out = t_expm.krylov_expm_multiply(tL, t(rho), dt=0.3, m=5).numpy()
    assert np.max(np.abs(out - ref)) < FIELD_TOL
    w = np.linalg.eigvalsh(H)
    emin, emax = w[0] - 0.1, w[-1] + 0.1
    ref = np.asarray(j_expm.chebyshev_expm_multiply(
        jnp.asarray(H), jnp.asarray(b), 0.8, emin, emax, order=24))
    out = t_expm.chebyshev_expm_multiply(t(H), t(b), 0.8, emin, emax,
                                         order=24).numpy()
    assert np.max(np.abs(out - ref)) < 1e-12
    exact = t_expm.expm_eig(t(H), 0.8).numpy() @ b
    assert np.max(np.abs(out - exact)) < FIELD_TOL
    from jax.scipy.special import bessel_jn
    z = (emax - emin) / 2.0 * 0.8
    jb = np.asarray(bessel_jn(z, v=24, n_iter=50))
    assert np.max(np.abs(t_expm.chebyshev_coefficients(z, 24) - jb)) < 1e-12
    with pytest.raises(ValueError):
        t_expm.propagators(t(H), 0.1, 2, method="pade")

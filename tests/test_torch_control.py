"""Parity of the PyTorch port's optimal control (pyqed_tpu_torch.control)
with the JAX package's, on the CPU at complex128, and the gradients of
the kernel wrappers.

GRAPE, OpenGRAPE, CRAB and fit are compared on their loss histories and
final controls (1e-8), Krotov on its fidelities (1e-10). The gradient of
a Lindblad decay rate through ``LindbladSolver`` is compared across the
commutator kernel's wrapper (``kernel='cuda'``, whose CPU branch is the
plain version inside the same ``torch.autograd.Function`` as on the
card), ``kernel='matmul'`` and JAX (1e-10).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu import control as jc
from pyqed_tpu.open.lindblad import LindbladSolver as JLindbladSolver

import pyqed_tpu_torch as pt
from pyqed_tpu_torch import control as tc
from pyqed_tpu_torch.ops import kernels as kn

CPU = "cpu"
SX = np.array([[0.0, 1.0], [1.0, 0.0]], complex)
SY = np.array([[0.0, -1j], [1j, 0.0]])
SZ = np.diag([1.0, -1.0]).astype(complex)
SM = np.array([[0.0, 1.0], [0.0, 0.0]], complex)


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


def err(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b)))


# ------------------------------------------------------------------ fit

def test_fit_dict_params_and_aux_match_jax():
    target = {"a": 2.0, "b": -1.5}

    def loss(p, m):
        v = (p["a"] - target["a"]) ** 2 + (p["b"] - target["b"]) ** 2
        return v, m.abs(p["a"] * p["b"])

    jp, (jl, ja) = jc.fit(lambda p: loss(p, jnp),
                          {"a": jnp.asarray(0.0), "b": jnp.asarray(0.0)},
                          iters=60, learning_rate=0.05, has_aux=True)
    p, (l, a) = tc.fit(lambda p: loss(p, torch), {"a": 0.0, "b": 0.0},
                       iters=60, learning_rate=0.05, has_aux=True,
                       device=CPU)
    assert set(p) == {"a", "b"}
    assert err(l, jl) <= 1e-12 and err(a, ja) <= 1e-12
    assert err(p["a"], jp["a"]) <= 1e-12 and err(p["b"], jp["b"]) <= 1e-12


def test_fit_exponential_decay_matches_jax():
    t = np.linspace(0.0, 10.0, 200)
    y = np.exp(-0.37 * t)
    jg, jl = jc.fit_exponential_decay(t, y, gamma0=0.1, iters=100)
    g, l = tc.fit_exponential_decay(t, y, gamma0=0.1, iters=100, device=CPU)
    assert abs(g - jg) <= 1e-10 and err(l, jl) <= 1e-10


def test_fit_takes_a_torch_optimizer_factory_and_lists():
    p, l = tc.fit(lambda p: (p[0] - 1.0) ** 2 + (p[1] + 2.0) ** 2,
                  [torch.zeros((), dtype=torch.float64), np.zeros(())],
                  iters=60, device=CPU,
                  optimizer=lambda ps: torch.optim.SGD(ps, lr=0.25))
    assert isinstance(p, list)
    assert abs(float(p[0]) - 1.0) <= 1e-10 and abs(float(p[1]) + 2.0) <= 1e-10
    assert l.shape == (60,) and float(l[-1]) <= 1e-18


# ---------------------------------------------------------------- GRAPE

@pytest.fixture(scope="module")
def grape_ref():
    """The JAX optimizations, once each."""
    out = {}
    g = jc.GRAPE(H0=0.5 * SZ, Hc=[SX], dt=0.2, n_steps=40)
    out["state"] = g.optimize_state_transfer([1, 0], [0, 1], iters=60,
                                             learning_rate=0.08, penalty=1e-3)
    g2 = jc.GRAPE(H0=0.3 * SZ, Hc=[SX, SY], dt=0.25, n_steps=30)
    out["gate"] = g2.optimize_gate(SX, iters=60, learning_rate=0.08)
    og = jc.OpenGRAPE(H0=0.5 * SZ, Hc=[SX], dt=0.2, n_steps=30,
                      c_ops=[0.3 * SM])
    rho0 = np.diag([1.0, 0.0]).astype(complex)
    e1 = np.array([0.0, 1.0], complex)
    out["open"] = og.optimize(lambda u: 1.0 - og.fidelity_state(u, rho0, e1),
                              1e-2 * np.ones((30, 1)), iters=60,
                              learning_rate=0.08)
    u = np.sin(np.linspace(0, 3, 30))[:, None]
    out["open_gate"] = (og.fidelity_gate(u, SX), og.trajectory(u, rho0),
                        og.expect_final(u, rho0, SZ))
    cr = jc.CRAB(H0=0.5 * SZ, Hc=[SX], dt=0.2, n_steps=40, n_modes=4)
    out["crab"] = cr.optimize_state_transfer([1, 0], [0, 1], iters=60)
    out["crab_gate"] = cr.optimize_gate(SX, iters=30)
    return out


def test_grape_state_transfer_matches_jax(grape_ref):
    g = tc.GRAPE(H0=0.5 * SZ, Hc=[SX], dt=0.2, n_steps=40, device=CPU)
    u, f = g.optimize_state_transfer([1, 0], [0, 1], iters=60,
                                     learning_rate=0.08, penalty=1e-3)
    ju, jf = grape_ref["state"]
    assert err(f, jf) <= 1e-8 and err(u, ju) <= 1e-8
    traj = g.trajectory(u, [1, 0])
    assert traj.shape == (41, 2)
    assert err(torch.linalg.vector_norm(traj, dim=1), np.ones(41)) <= 1e-12
    U = g.total_propagator(u)
    assert err(U.mH @ U, np.eye(2)) <= 1e-12


def test_grape_gate_matches_jax(grape_ref):
    g = tc.GRAPE(H0=0.3 * SZ, Hc=[SX, SY], dt=0.25, n_steps=30, device=CPU)
    u, f = g.optimize_gate(SX, iters=60, learning_rate=0.08)
    ju, jf = grape_ref["gate"]
    assert err(f, jf) <= 1e-8 and err(u, ju) <= 1e-8


def test_open_grape_matches_jax(grape_ref):
    og = tc.OpenGRAPE(H0=0.5 * SZ, Hc=[SX], dt=0.2, n_steps=30,
                      c_ops=[0.3 * SM], device=CPU)
    rho0 = np.diag([1.0, 0.0]).astype(complex)
    e1 = np.array([0.0, 1.0], complex)
    u, l = og.optimize(lambda u: 1.0 - og.fidelity_state(u, rho0, e1),
                       1e-2 * np.ones((30, 1)), iters=60, learning_rate=0.08)
    ju, jl = grape_ref["open"]
    assert err(l, jl) <= 1e-8 and err(u, ju) <= 1e-8
    uu = np.sin(np.linspace(0, 3, 30))[:, None]
    jF, jtraj, jexp = grape_ref["open_gate"]
    assert abs(float(og.fidelity_gate(uu, SX)) - float(jF)) <= 1e-12
    assert err(og.trajectory(uu, rho0), jtraj) <= 1e-12
    assert abs(float(og.expect_final(uu, rho0, SZ)) - float(jexp)) <= 1e-12


def test_crab_matches_jax(grape_ref):
    cr = tc.CRAB(H0=0.5 * SZ, Hc=[SX], dt=0.2, n_steps=40, n_modes=4,
                 device=CPU)
    c, f = cr.optimize_state_transfer([1, 0], [0, 1], iters=60)
    jc_, jf = grape_ref["crab"]
    assert err(f, jf) <= 1e-8 and err(c, jc_) <= 1e-8
    c, f = cr.optimize_gate(SX, iters=30)
    jc_, jf = grape_ref["crab_gate"]
    assert err(f, jf) <= 1e-8 and err(c, jc_) <= 1e-8
    env = np.linspace(0.0, 1.0, 40)
    cr2 = tc.CRAB(H0=0.5 * SZ, Hc=[SX], dt=0.2, n_steps=40, envelope=env,
                  device=CPU)
    jcr2 = jc.CRAB(H0=0.5 * SZ, Hc=[SX], dt=0.2, n_steps=40, envelope=env)
    coeffs = np.random.default_rng(0).standard_normal((5, 2, 1))
    assert err(cr2.coeffs_to_u(coeffs), jcr2.coeffs_to_u(coeffs)) <= 1e-14
    with pytest.raises(ValueError, match="envelope shape"):
        tc.CRAB(H0=SZ, Hc=[SX], dt=0.2, n_steps=40, envelope=env[:3],
                device=CPU)


def test_penalties_match_jax():
    u = np.random.default_rng(1).standard_normal((20, 2))
    tu = torch.as_tensor(u)
    assert abs(float(tc.amplitude_penalty(tu, 0.3))
               - float(jc.amplitude_penalty(jnp.asarray(u), 0.3))) <= 1e-15
    assert abs(float(tc.smoothness_penalty(tu, 0.3))
               - float(jc.smoothness_penalty(jnp.asarray(u), 0.3))) <= 1e-15


@pytest.mark.parametrize("n_ctrl", [1, 2])
def test_krotov_matches_jax(n_ctrl):
    Hc = [SX, SY][:n_ctrl]
    tgt = [0, 1] if n_ctrl == 1 else np.array([1.0, 1.0]) / np.sqrt(2)
    jk = jc.Krotov(H0=0.5 * SZ, Hc=Hc, dt=0.2, n_steps=30, lam=0.5)
    k = tc.Krotov(H0=0.5 * SZ, Hc=Hc, dt=0.2, n_steps=30, lam=0.5,
                  device=CPU)
    ju, jf = jk.optimize_state_transfer([1, 0], tgt, iters=15)
    u, f = k.optimize_state_transfer([1, 0], tgt, iters=15)
    assert err(f, jf) <= 1e-10 and err(u, ju) <= 1e-10
    assert np.all(np.diff(host(f)) >= -1e-10)
    assert abs(float(k.fidelity(u, [2, 0], tgt)) - float(f[-1])) <= 1e-10


# ----------------------------------------- the gradient through Lindblad

def _trace(solver_cls, gamma, m, **kw):
    sol = solver_cls(0.5 * m.asarray(SZ) if m is jnp else
                     0.5 * torch.as_tensor(SZ),
                     c_ops=[m.sqrt(gamma) * (m.asarray(SM) if m is jnp
                                             else torch.as_tensor(SM))],
                     **kw)
    res = sol.run(np.diag([0.0, 1.0]).astype(complex), dt=0.05, Nt=120,
                  e_ops=[np.diag([0.0, 1.0]).astype(complex)], nout=4)
    return (jnp.real(jnp.asarray(res.observables)[:, 0]) if m is jnp
            else res.observables[:, 0].real)


def test_lindblad_rate_gradient_cuda_equals_matmul_and_jax():
    """tests/test_control.py's rate fit: the gradient of the misfit with
    respect to log(gamma), through the commutator wrapper's
    autograd.Function, through kernel='matmul', and through JAX."""
    y = _trace(JLindbladSolver, jnp.asarray(0.25), jnp)

    def jloss(lg):
        return jnp.mean((_trace(JLindbladSolver, jnp.exp(lg), jnp) - y) ** 2)

    jgrad = float(jax.grad(jloss)(jnp.log(0.05)))
    yt = torch.as_tensor(np.array(y))
    grads = {}
    for kernel in ("cuda", "matmul"):
        lg = torch.tensor(np.log(0.05), dtype=torch.float64,
                          requires_grad=True)
        loss = torch.mean((_trace(pt.LindbladSolver, torch.exp(lg), torch,
                                  kernel=kernel, device=CPU) - yt) ** 2)
        loss.backward()
        grads[kernel] = lg.grad.item()
    for g in grads.values():
        assert abs(g - jgrad) <= 1e-10 * abs(jgrad)
    assert abs(grads["cuda"] - grads["matmul"]) <= 1e-10 * abs(jgrad)
    # and a short fit through the solver, cuda wrapper against JAX
    jlg, jl = jc.fit(jloss, jnp.log(0.05), iters=3, learning_rate=0.1)
    lg, l = tc.fit(lambda lg: torch.mean((_trace(
        pt.LindbladSolver, torch.exp(lg), torch, device=CPU) - yt) ** 2),
        np.log(0.05), iters=3, learning_rate=0.1, device=CPU)
    assert err(l, jl) <= 1e-10 and abs(float(lg) - float(jlg)) <= 1e-10


# --------------------------------------------- kernel wrappers and grad

def test_commutator_function_gradcheck():
    rng = np.random.default_rng(2)
    H, rho = (torch.as_tensor(rng.standard_normal((5, 5))
                              + 1j * rng.standard_normal((5, 5)))
              .requires_grad_(True) for _ in range(2))
    assert torch.autograd.gradcheck(kn.liouvillian_commutator, (H, rho))
    g = torch.as_tensor(rng.standard_normal((5, 5))
                        + 1j * rng.standard_normal((5, 5)))
    got = torch.autograd.grad((kn.liouvillian_commutator(H, rho) * g)
                              .real.sum(), (H, rho))
    want = torch.autograd.grad((kn.liouvillian_commutator_ref(H, rho) * g)
                               .real.sum(), (H, rho))
    for a, b in zip(got, want):
        assert err(a, b) <= 1e-14
    # the CPU branch counts no launch, forward or backward
    assert kn.liouvillian_commutator.launches == 0
    assert kn.liouvillian_commutator.backward_launches == 0


def test_wrappers_without_backward_refuse_grad():
    """heom_coupling and the SPO kernels have no backward: on CUDA they
    raise when grad is enabled and an input requires grad (the check runs
    before any launch, so it is tested here on CPU tensors); on the CPU
    their plain versions carry the gradient."""
    x = torch.ones(3, dtype=torch.complex128, requires_grad=True)
    y = torch.ones(3, dtype=torch.complex128)
    with pytest.raises(RuntimeError, match="no backward"):
        kn._refuse_grad("spo_phase_multiply", y, x)
    with torch.no_grad():
        kn._refuse_grad("spo_phase_multiply", y, x)
    kn._refuse_grad("spo_phase_multiply", y, y)
    expK = torch.exp(1j * torch.linspace(0, 1, 6, dtype=torch.float64))
    psik = torch.ones((6, 2), dtype=torch.complex128, requires_grad=True)
    out = kn.spo_phase_multiply(expK, psik)
    (g,) = torch.autograd.grad(out.real.sum(), psik)
    assert err(g, np.conj(host(expK))[:, None] * np.ones((6, 2))) <= 1e-15
    expV = torch.eye(2, dtype=torch.complex128).expand(6, 2, 2).contiguous()
    (g,) = torch.autograd.grad(kn.spo_potential_apply(expV, psik).real.sum(),
                               psik)
    assert err(g, np.ones((6, 2))) <= 1e-15
    F = torch.ones((2, 3), dtype=torch.complex128, requires_grad=True)
    nbr = torch.tensor([[1], [0]], dtype=torch.int32)
    w = torch.ones((2, 1), dtype=torch.float64)
    OpT = torch.eye(3, dtype=torch.complex128)[None]
    (g,) = torch.autograd.grad(kn.heom_coupling(F, nbr, w, OpT).real.sum(),
                               F)
    assert err(g, np.ones((2, 3))) <= 1e-15

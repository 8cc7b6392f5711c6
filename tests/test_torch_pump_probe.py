"""Parity of the PyTorch port's pump-probe and third-order response
functions (pyqed_tpu_torch.signal.pump_probe) with the JAX package, on the
CPU at complex128.

The same 3-level molecule and pulses (numpy inputs) go through both
packages. TransientAbsorption propagates every delay and the pump-only
run as one block in the port and a vmapped scan in JAX: rel 1e-10 (RK4
with the same stage times; the windowed transform factors e^{i f (t-d)}
into e^{i f t} e^{-i f d}). The response functions are closed-form sums:
rel 1e-12. JAX references are computed under ``jax.jit``.
"""
import numpy as np
import jax
import pytest
import torch

from pyqed_tpu.models.mol import Mol as JMol
from pyqed_tpu.models.pulse import GaussianPulse as JGaussianPulse
from pyqed_tpu.signal import pump_probe as jpp

from pyqed_tpu_torch.models.mol import Mol
from pyqed_tpu_torch.models.pulse import GaussianPulse
from pyqed_tpu_torch.signal import pump_probe as tpp

CPU = "cpu"
EN = np.array([0.0, 1.0, 1.9])
DIP = np.array([[0.0, 1.0, 0.2], [1.0, 0.0, 0.7], [0.2, 0.7, 0.0]])
GAMMA = np.array([0.0, 0.02, 0.03])
W1 = np.linspace(0.8, 1.2, 5)
W3 = np.linspace(0.7, 1.1, 4)


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def rel_err(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_transient_absorption_matches_jax():
    H, mu = np.diag(EN), DIP
    pulse = dict(omegac=1.0, tau=2.0, amplitude=0.05)
    delays = np.array([0.0, 3.0, 6.0])
    freqs = np.linspace(0.5, 1.5, 16)
    run = dict(dt=0.1, nt=300, freqs=freqs)
    fj, Sj = jpp.TransientAbsorption(
        JMol(H, edip=mu), JGaussianPulse(**pulse),
        JGaussianPulse(**dict(pulse, amplitude=0.01)), delays).run(**run)
    ft, St = tpp.TransientAbsorption(
        Mol(H, edip=mu), GaussianPulse(**pulse),
        GaussianPulse(**dict(pulse, amplitude=0.01)), delays,
        device=CPU).run(**run)
    assert np.array_equal(ft, fj)
    assert St.shape == (16, 3)
    assert rel_err(St, Sj) < 1e-10
    # the default frequency grid
    fd, Sd = tpp.TransientAbsorption(
        Mol(H, edip=mu), GaussianPulse(**pulse), GaussianPulse(**pulse),
        delays[:1], device=CPU).run(dt=0.1, nt=20)
    assert len(fd) == 200 and np.isclose(fd[-1], 2 * 1.9)
    assert bool(torch.isfinite(torch.view_as_real(Sd)).all())


def test_response_functions_match_jax():
    fns = ("response1_freq", "response2_freq", "response3_freq",
           "response4_freq", "chi3")
    ref = jax.jit(lambda: [getattr(jpp, f)(EN, DIP, GAMMA, W3, 5.0, W1)
                           for f in fns]
                  + [jpp.chi1(EN, DIP, GAMMA, W1)])()
    got = [getattr(tpp, f)(EN, DIP, GAMMA, W3, 5.0, W1, device=CPU)
           for f in fns] + [tpp.chi1(EN, DIP, GAMMA, W1, device=CPU)]
    for name, a, b in zip(fns + ("chi1",), got, ref):
        assert a.shape == b.shape, name
        assert rel_err(a, b) < 1e-12, name


def test_frequency_domain_responses_match_jax(monkeypatch):
    # one compilation per pathway for JAX's 48 pathway calls
    monkeypatch.setattr(jpp, "_resp_fd_core",
                        jax.jit(jpp._resp_fd_core, static_argnums=(6,)))
    w = (0.9, 1.1, -0.3)
    fns = ("response1_fd", "response2_fd", "response3_fd", "response4_fd")
    w123 = np.linspace(1.5, 1.9, 6)
    ref = [getattr(jpp, f)(EN, DIP, GAMMA, w123, 1.0, 0.9) for f in fns]
    ref.append(jpp.susceptibility(EN, DIP, GAMMA, w))
    got = [getattr(tpp, f)(EN, DIP, GAMMA, w123, 1.0, 0.9, device=CPU)
           for f in fns] + [tpp.susceptibility(EN, DIP, GAMMA, w,
                                               device=CPU)]
    for name, a, b in zip(fns + ("susceptibility",), got, ref):
        assert rel_err(a, b) < 1e-12, name
    with pytest.raises(ValueError):
        tpp.susceptibility(EN, DIP, GAMMA, (1.0, 2.0), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tpp.chi1(EN, DIP, GAMMA, W1)

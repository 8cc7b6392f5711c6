"""Parity of the PyTorch port's 2DES signal slice (pyqed_tpu_torch: the
rest of ops/math, models/mol.Mol, signal/sos and signal/tdes) with the
JAX package, on the CPU at complex128.

Inputs are made with numpy from a seed: the 6-level random-dipole system
of tests/test_signal.py (test_photon_echo_factored_equals_vmapped) on a
41-point grid. Every JAX reference that can be traced is computed in ONE
jitted function per module (the `refs` fixture), so XLA compiles once;
functions of a molecule get a stand-in object with the JAX Mol's arrays
(the JAX Mol's own ``isdiag`` check cannot run under jit; its properties
are compared eagerly below). Maps are held to rel 1e-12, the math
helpers to 1e-14.
"""
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyqed_tpu.ops.math as jmath
import pyqed_tpu.signal.sos as jsos
import pyqed_tpu.signal.tdes as jtdes
from pyqed_tpu.models.mol import Mol as JMol
import pyqed_tpu.models.pulse as jpulse
from pyqed_tpu.models.pulse import Biphoton
from pyqed_tpu.open.heom import HEOMSolver as JHEOMSolver
from pyqed_tpu.open.bath import DrudeBath as JDrudeBath
from pyqed_tpu.units import au2ev

import pyqed_tpu_torch as pt
import pyqed_tpu_torch.ops.math as tmath
from pyqed_tpu_torch.models.mol import Mol, SESolver, mls
from pyqed_tpu_torch.open.bath import DrudeBath
from pyqed_tpu_torch.open.heom import HEOMSolver
from pyqed_tpu_torch.signal import sos as tsos, tdes as ttdes

CPU = dict(device="cpu")
RTOL = 1e-12
MATH_TOL = 1e-14

RNG = np.random.default_rng(5)
E = np.array([0.0, 1.0, 1.1, 1.25, 2.1, 2.3])
DIP = RNG.random((6, 6))
DIP = DIP + DIP.T
GAMMA = np.array([0.0, 0.02, 0.03, 0.025, 0.05, 0.06])
EDIP3 = RNG.standard_normal((6, 6, 3)) + 1j * RNG.standard_normal((6, 6, 3))
W = np.linspace(0.8, 1.4, 41)
W2 = 2.0 * W
T2S = np.array([0.0, 3.0, 10.0])
G_IDX, E_IDX, F_IDX = [0], [1, 2, 3], [4, 5]
T1 = 0.5 * np.arange(24)
T2 = np.linspace(0.0, 30.0, 4)
T3 = 0.7 * np.arange(20)
DEPHASING = 0.01
X = np.linspace(-2.3, 2.1, 37)       # math-helper input, 0 excluded
OMEGAPS = np.linspace(0.9, 1.5, 5) / au2ev


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


def abs_err(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b))


def port_mol():
    m = Mol(np.diag(E), DIP)
    m.gamma = GAMMA
    m.set_dephasing(DEPHASING)
    return m


class JTA:
    """Anything with get_jta() -> (t1, t2, jta) drives etpa."""

    def __init__(self, t1, t2, jta):
        self.arrays = (t1, t2, jta)

    def get_jta(self):
        return self.arrays


def _biphoton_arrays():
    """(t1, t2, jta) of a JAX Biphoton, its joint spectral amplitude
    traced once instead of op by op."""
    epp = Biphoton(0.0, 0.04 / au2ev, Te=10.0 * 41.341)
    p = jnp.asarray(np.linspace(-0.5, 0.5, 32) / au2ev)
    epp.set_grid(p, p)
    epp.jsa = jax.jit(lambda p, q: jpulse.jsa(
        p, q, epp.pump_bandwidth, model=epp.phase_matching,
        Te=epp.entanglement_time))(p, p)
    return tuple(np.array(a) for a in epp.get_jta())


@pytest.fixture(scope="module")
def biphoton_jta():
    return _biphoton_arrays()


# ------------------------------------------------------------ the cases
# name -> (port call, JAX call on the traced arrays `a` and the stand-in
# molecules `jm` (the 6-level system) and `jm3` (3-D complex dipoles))

SOS = {
    "absorption": (lambda: tsos.absorption(port_mol(), W, **CPU),
                   lambda a, jm, jm3: jsos.absorption(jm, a.w)),
    "absorption_normalized": (
        lambda: tsos.absorption(port_mol(), W, linewidth=0.03,
                                normalize=True, **CPU),
        lambda a, jm, jm3: jsos.absorption(jm, a.w, linewidth=0.03,
                                           normalize=True)),
    "linear_absorption": (
        lambda: tsos.linear_absorption(W, E[1:], DIP[0, 1:], normalize=True,
                                       **CPU),
        lambda a, jm, jm3: jsos.linear_absorption(a.w, a.E[1:], a.dip[0, 1:],
                                                  normalize=True)),
    "TPA": (lambda: tsos.TPA(E, DIP, W2, None, E_IDX, F_IDX, GAMMA, **CPU),
            lambda a, jm, jm3: jsos.TPA(a.E, a.dip, a.w2, None, E_IDX, F_IDX,
                                        a.gamma)),
    "TPA2D": (lambda: tsos.TPA2D(E, DIP, W2, W, None, E_IDX, F_IDX, GAMMA,
                                 **CPU),
              lambda a, jm, jm3: jsos.TPA2D(a.E, a.dip, a.w2, a.w, None,
                                            E_IDX, F_IDX, a.gamma)),
    "TPA2D_time_order": (
        lambda: tsos.TPA2D_time_order(E, DIP, W2, W, None, E_IDX, F_IDX,
                                      GAMMA, **CPU),
        lambda a, jm, jm3: jsos.TPA2D_time_order(a.E, a.dip, a.w2, a.w, None,
                                                 E_IDX, F_IDX, a.gamma)),
    "ESA": (lambda: tsos.ESA(E, DIP, -W, W, 3.0, G_IDX, E_IDX, F_IDX, GAMMA,
                             **CPU),
            lambda a, jm, jm3: jsos.ESA(a.E, a.dip, -a.w, a.w, 3.0, G_IDX,
                                        E_IDX, F_IDX, a.gamma)),
    "GSB": (lambda: tsos.GSB(E, DIP, -W, W, 3.0, G_IDX, E_IDX, GAMMA, **CPU),
            lambda a, jm, jm3: jsos.GSB(a.E, a.dip, -a.w, a.w, 3.0, G_IDX,
                                        E_IDX, a.gamma)),
    "SE": (lambda: tsos.SE(E, DIP, -W, W, 3.0, G_IDX, E_IDX, GAMMA, **CPU),
           lambda a, jm, jm3: jsos.SE(a.E, a.dip, -a.w, a.w, 3.0, G_IDX,
                                      E_IDX, a.gamma)),
    "_photon_echo": (
        lambda: tsos._photon_echo(E, DIP, -W, W, 7.0, G_IDX, E_IDX, F_IDX,
                                  GAMMA, **CPU),
        lambda a, jm, jm3: jsos._photon_echo(a.E, a.dip, -a.w, a.w, 7.0,
                                             G_IDX, E_IDX, F_IDX, a.gamma)),
    "photon_echo": (
        lambda: tsos.photon_echo(port_mol(), W, W, t2=5.0, e_idx=E_IDX,
                                 f_idx=F_IDX, **CPU),
        lambda a, jm, jm3: jsos.photon_echo(jm, a.w, a.w, t2=5.0,
                                            e_idx=E_IDX, f_idx=F_IDX)),
    "photon_echo_default_idx": (
        lambda: tsos.photon_echo(port_mol(), W, W, t2=5.0, **CPU),
        lambda a, jm, jm3: jsos.photon_echo(jm, a.w, a.w, t2=5.0)),
    "_ESA_t3": (
        lambda: tsos._ESA_t3(E, DIP, -W, W, 4.0, G_IDX, E_IDX, F_IDX, GAMMA,
                             **CPU),
        lambda a, jm, jm3: jsos._ESA_t3(a.E, a.dip, -a.w, a.w, 4.0, G_IDX,
                                        E_IDX, F_IDX, a.gamma)),
    "_SE_t3": (
        lambda: tsos._SE_t3(E, DIP, -W, W, 4.0, G_IDX, E_IDX, GAMMA, **CPU),
        lambda a, jm, jm3: jsos._SE_t3(a.E, a.dip, -a.w, a.w, 4.0, G_IDX,
                                       E_IDX, a.gamma)),
    "photon_echo_t3": (
        lambda: tsos.photon_echo_t3(port_mol(), W, W, 4.0, **CPU),
        lambda a, jm, jm3: jsos.photon_echo_t3(jm, a.w, a.w, 4.0)),
    "photon_echo_t3_separate": (
        lambda: tsos.photon_echo_t3(port_mol(), W, W, 4.0, e_idx=E_IDX,
                                    f_idx=F_IDX, separate=True, **CPU),
        lambda a, jm, jm3: jsos.photon_echo_t3(jm, a.w, a.w, 4.0,
                                               e_idx=E_IDX, f_idx=F_IDX,
                                               separate=True)),
    "DQC_R1_tau3": (
        lambda: tsos.DQC_R1(E, DIP, omega1=W, omega2=W2, tau3=4.0,
                            e_idx=E_IDX, f_idx=F_IDX, gamma=GAMMA, **CPU),
        lambda a, jm, jm3: jsos.DQC_R1(a.E, a.dip, omega1=a.w, omega2=a.w2,
                                       tau3=4.0, e_idx=E_IDX, f_idx=F_IDX,
                                       gamma=a.gamma)),
    "DQC_R1_tau1": (
        lambda: tsos.DQC_R1(E, DIP, omega2=W2, omega3=W, tau1=4.0,
                            e_idx=E_IDX, f_idx=F_IDX, gamma=GAMMA, **CPU),
        lambda a, jm, jm3: jsos.DQC_R1(a.E, a.dip, omega2=a.w2, omega3=a.w,
                                       tau1=4.0, e_idx=E_IDX, f_idx=F_IDX,
                                       gamma=a.gamma)),
    "DQC_R2_tau3": (
        lambda: tsos.DQC_R2(E, DIP, omega1=W, omega2=W2, tau3=4.0,
                            e_idx=E_IDX, f_idx=F_IDX, gamma=GAMMA, **CPU),
        lambda a, jm, jm3: jsos.DQC_R2(a.E, a.dip, omega1=a.w, omega2=a.w2,
                                       tau3=4.0, e_idx=E_IDX, f_idx=F_IDX,
                                       gamma=a.gamma)),
    "DQC_R2_tau1": (
        lambda: tsos.DQC_R2(E, DIP, omega2=W2, omega3=W, tau1=4.0,
                            e_idx=E_IDX, f_idx=F_IDX, gamma=GAMMA, **CPU),
        lambda a, jm, jm3: jsos.DQC_R2(a.E, a.dip, omega2=a.w2, omega3=a.w,
                                       tau1=4.0, e_idx=E_IDX, f_idx=F_IDX,
                                       gamma=a.gamma)),
    "cars": (lambda: tsos.cars(E, DIP, W - 0.8, W, **CPU),
             lambda a, jm, jm3: jsos.cars(a.E, a.dip, a.w - 0.8, a.w)),
    "mcd": (lambda: tsos.mcd(Mol(np.diag(E), EDIP3, edip_rms=None,
                                 gamma=GAMMA + 0.01), W, **CPU),
            lambda a, jm, jm3: jsos.mcd(jm3, a.w)),
    "polarizability": (
        lambda: tsos.polarizability(0.3, E[:2], E[2:], DIP[2:, :2], **CPU),
        lambda a, jm, jm3: jsos.polarizability(0.3, a.E[:2], a.E[2:],
                                               a.dip[2:, :2])),
    "photon_echo_t2series": (
        lambda: tsos.photon_echo_t2series(port_mol(), W, W, T2S,
                                          e_idx=E_IDX, f_idx=F_IDX, **CPU),
        lambda a, jm, jm3: jsos.photon_echo_t2series(jm, a.w, a.w, a.t2s,
                                                     e_idx=E_IDX,
                                                     f_idx=F_IDX)),
    "_photon_echo_factors": (
        lambda: tsos._photon_echo_factors(E, DIP, GAMMA, W, W, T2S, G_IDX,
                                          E_IDX, F_IDX, **CPU),
        lambda a, jm, jm3: jsos._photon_echo_factors(
            a.E, a.dip, a.gamma, a.w, a.w, a.t2s, G_IDX, E_IDX, F_IDX)),
    "_photon_echo_factored": (
        lambda: tsos._photon_echo_factored(E, DIP, GAMMA, W, W, T2S, G_IDX,
                                           E_IDX, F_IDX, **CPU),
        lambda a, jm, jm3: jsos._photon_echo_factored(
            a.E, a.dip, a.gamma, a.w, a.w, a.t2s, G_IDX, E_IDX, F_IDX)),
    "photon_echo_t2series_factored": (
        lambda: tsos.photon_echo_t2series_factored(port_mol(), W, W, T2S,
                                                   e_idx=E_IDX, f_idx=F_IDX,
                                                   **CPU),
        lambda a, jm, jm3: jsos.photon_echo_t2series_factored(
            jm, a.w, a.w, a.t2s, e_idx=E_IDX, f_idx=F_IDX)),
    "vacuum_efield": (lambda: tsos.vacuum_efield(W, **CPU),
                      lambda a, jm, jm3: jsos.vacuum_efield(a.w)),
    "_h_exp": (lambda: tsos._h_exp(torch.as_tensor(W - 1j * 0.01), 3.0),
               lambda a, jm, jm3: jsos._h_exp(a.w - 1j * 0.01, 3.0)),
    "etpa_amplitude": (
        lambda: tsos.etpa_amplitude(E, DIP, 100.0, 2.2, 0.01, 0, E_IDX, F_IDX,
                                    **CPU),
        lambda a, jm, jm3: jsos.etpa_amplitude(a.E, a.dip, 100.0, 2.2, 0.01,
                                               0, E_IDX, F_IDX)),
}

TDES = {
    "_U": (lambda: ttdes._U(E, GAMMA, [0, 2], E_IDX, T1, **CPU),
           lambda a, jm: jtdes._U(a.E, a.gamma, [0, 2], E_IDX, T1)),
    "ESA": (lambda: ttdes.ESA(E, DIP, G_IDX, E_IDX, F_IDX, GAMMA, T1, T2, T3,
                              **CPU),
            lambda a, jm: jtdes.ESA(a.E, a.dip, G_IDX, E_IDX, F_IDX, a.gamma,
                                    T1, T2, T3)),
    "GSB": (lambda: ttdes.GSB(E, DIP, G_IDX, E_IDX, GAMMA, T1, T2, T3, **CPU),
            lambda a, jm: jtdes.GSB(a.E, a.dip, G_IDX, E_IDX, a.gamma, T1, T2,
                                    T3)),
    "SE": (lambda: ttdes.SE(E, DIP, G_IDX, E_IDX, GAMMA, T1, T2, T3, **CPU),
           lambda a, jm: jtdes.SE(a.E, a.dip, G_IDX, E_IDX, a.gamma, T1, T2,
                                  T3)),
    "twodes": (lambda: ttdes.twodes(port_mol(), T1, T2, T3, **CPU),
               lambda a, jm: jtdes.twodes(jm, T1, T2, T3)),
    "twodes_idx": (lambda: ttdes.twodes(port_mol(), T1, T2, T3, e_idx=E_IDX,
                                        f_idx=F_IDX, **CPU),
                   lambda a, jm: jtdes.twodes(jm, T1, T2, T3, e_idx=E_IDX,
                                              f_idx=F_IDX)),
    "response_to_spectrum_nonrephasing": (
        lambda: ttdes.response_to_spectrum(
            ttdes.SE(E, DIP, G_IDX, E_IDX, GAMMA, T1, T2, T3, **CPU), T1, T3,
            rephasing=False),
        lambda a, jm: jtdes.response_to_spectrum(
            jtdes.SE(a.E, a.dip, G_IDX, E_IDX, a.gamma, T1, T2, T3), T1, T3,
            rephasing=False)),
}

# elementwise helpers on X (JAX side traced)
MATH = {
    "lorentzian": (lambda x: tmath.lorentzian(x, 0.3),
                   lambda x: jmath.lorentzian(x, 0.3)),
    "gaussian": (lambda x: tmath.gaussian(x, 0.7),
                 lambda x: jmath.gaussian(x, 0.7)),
    "coth": (tmath.coth, jmath.coth),
    "heaviside": (lambda x: tmath.heaviside(torch.round(x)),
                  lambda x: jmath.heaviside(jnp.round(x))),
    "fermi": (lambda x: tmath.fermi(x, 0.2, 0.5),
              lambda x: jmath.fermi(x, 0.2, 0.5)),
    "sinc": (tmath.sinc, jmath.sinc),
    "rect": (tmath.rect, jmath.rect),
    "morse": (lambda x: tmath.morse(x, 0.2, 1.1, 0.3),
              lambda x: jmath.morse(x, 0.2, 1.1, 0.3)),
    "pdf_normal": (lambda x: tmath.pdf_normal(x, 0.1, 0.8),
                   lambda x: jmath.pdf_normal(x, 0.1, 0.8)),
    "logarithmic_discretize": (lambda x: tmath.logarithmic_discretize(9, 2.5),
                               lambda x: jmath.logarithmic_discretize(9, 2.5)),
    "polar2cartesian": (lambda x: tmath.polar2cartesian(x, 0.5 * x),
                        lambda x: jmath.polar2cartesian(x, 0.5 * x)),
    "cartesian2polar": (lambda x: tmath.cartesian2polar(x, x.flip(0)),
                        lambda x: jmath.cartesian2polar(x, x[::-1])),
    "polar": (lambda x: tmath.polar(x, x.flip(0) + 0.1),
              lambda x: jmath.polar(x, x[::-1] + 0.1)),
    "nlargest": (lambda x: tmath.nlargest(torch.round(x), 5, with_index=True),
                 lambda x: jmath.nlargest(jnp.round(x), 5, with_index=True)),
    "nlargest_values": (lambda x: tmath.nlargest(x, 3),
                        lambda x: jmath.nlargest(x, 3)),
    "meshgrid": (lambda x: tmath.meshgrid(x[:5], x[5:12]),
                 lambda x: jmath.meshgrid(x[:5], x[5:12])),
    "rotate": (lambda x: tmath.rotate(0.37), lambda x: jmath.rotate(0.37)),
    "square_barrier": (lambda x: tmath.square_barrier(torch.round(x), 1.0,
                                                      0.4),
                       lambda x: jmath.square_barrier(jnp.round(x), 1.0,
                                                      0.4)),
}

# helpers whose JAX versions return host values (called eagerly)
MATH_HOST = {
    "interval": (lambda: tmath.interval(torch.as_tensor(X)),
                 lambda: jmath.interval(X)),
    "stepsize": (lambda: tmath.stepsize(torch.as_tensor(X)),
                 lambda: jmath.stepsize(X)),
    "fftfreq": (lambda: tmath.fftfreq(X), lambda: jmath.fftfreq(X)),
    "discretize": (lambda: tmath.discretize(-1.0, 2.0, 4),
                   lambda: jmath.discretize(-1.0, 2.0, 4)),
    "discretize_midpoints": (lambda: tmath.discretize(-1.0, 2.0, 3, False),
                             lambda: jmath.discretize(-1.0, 2.0, 3, False)),
    "cartesian_product": (
        lambda: tmath.cartesian_product([X[:3], X[3:7], X[7:9]]),
        lambda: jmath.cartesian_product([X[:3], X[3:7], X[7:9]])),
    "get_index": (lambda: tmath.get_index(X, 0.31),
                  lambda: jmath.get_index(X, 0.31)),
    "polarization_vector": (
        lambda: [tmath.polarization_vector(p) for p in
                 ("x", "y", "z", "lcp", "rcp")],
        lambda: [jmath.polarization_vector(p) for p in
                 ("x", "y", "z", "lcp", "rcp")]),
}


def _arrays(jta):
    return SimpleNamespace(E=jnp.asarray(E), dip=jnp.asarray(DIP),
                           gamma=jnp.asarray(GAMMA), w=jnp.asarray(W),
                           w2=jnp.asarray(W2), t2s=jnp.asarray(T2S),
                           edip3=jnp.asarray(EDIP3), x=jnp.asarray(X),
                           jt1=jnp.asarray(jta[0]), jt2=jnp.asarray(jta[1]),
                           jta=jnp.asarray(jta[2]),
                           omegaps=jnp.asarray(OMEGAPS))


def _jax_refs(jta):
    """Every traced JAX reference of this module, from one jit."""
    def stand_in(a, edip, gamma):
        # the attributes the signal functions read from a JAX Mol with a
        # diagonal H (its eigvals() is the diagonal)
        return SimpleNamespace(eigvals=lambda: a.E, edip=edip,
                               edip_rms=jnp.abs(edip), gamma=gamma,
                               nstates=len(E), dephasing=DEPHASING)

    def everything(leaves):
        a = SimpleNamespace(**leaves)
        jm = stand_in(a, a.dip, a.gamma)
        jm3 = stand_in(a, a.edip3, a.gamma + 0.01)
        out = {f"sos/{k}": ref(a, jm, jm3) for k, (_, ref) in SOS.items()}
        out.update({f"tdes/{k}": ref(a, jm) for k, (_, ref) in TDES.items()})
        out.update({f"math/{k}": ref(a.x) for k, (_, ref) in MATH.items()})
        epp = JTA(a.jt1, a.jt2, a.jta)
        out["sos/etpa"] = jsos.etpa(a.omegaps, jm, epp, g_idx=0, e_idx=[1],
                                    f_idx=[2, 3])
        out["sos/_etpa"] = jsos._etpa(a.omegaps, a.E, a.dip, a.jta, a.jt1,
                                      a.jt2, 0, [1, 2], [3, 4, 5])
        return out

    out = jax.jit(everything)(vars(_arrays(jta)))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def refs(biphoton_jta):
    return _jax_refs(biphoton_jta)


def _compare(port, ref, tol, err=rel_err):
    if isinstance(ref, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _compare(p, r, tol, err)
        return
    assert err(port, ref) <= tol


# ----------------------------------------------------------------- math
@pytest.mark.parametrize("name", sorted(MATH))
def test_math_matches_jax(name, refs):
    port, _ = MATH[name]
    _compare(port(torch.as_tensor(X)), refs[f"math/{name}"], MATH_TOL,
             abs_err)


@pytest.mark.parametrize("name", sorted(MATH_HOST))
def test_math_host_helpers_match_jax(name):
    port, ref = MATH_HOST[name]
    p, r = port(), ref()
    if isinstance(r, int):
        assert p == r
    else:
        _compare(p, r, MATH_TOL, abs_err)


def test_math_python_helpers_match_jax():
    assert tmath.cartesian([1, 2], "ab", [0.5]) == \
        jmath.cartesian([1, 2], "ab", [0.5])
    spd = DIP @ DIP.T + np.eye(6)
    for A in (spd, -spd, DIP):
        assert tmath.is_positive_def(torch.as_tensor(A)) == \
            jmath.is_positive_def(A)
    with pytest.raises(ValueError):
        tmath.polarization_vector("q")


# ------------------------------------------------------------------ sos
@pytest.mark.parametrize("name", sorted(SOS))
def test_sos_matches_jax(name, refs):
    port, _ = SOS[name]
    _compare(port(), refs[f"sos/{name}"], RTOL)


def test_etpa_matches_jax(refs, biphoton_jta):
    out = tsos.etpa(OMEGAPS, port_mol(), JTA(*biphoton_jta), g_idx=0,
                    e_idx=[1], f_idx=[2, 3], **CPU)
    assert rel_err(out, refs["sos/etpa"]) <= RTOL
    out = tsos._etpa(OMEGAPS, E, DIP, biphoton_jta[2], biphoton_jta[0],
                     biphoton_jta[1], 0, [1, 2], [3, 4, 5], **CPU)
    assert rel_err(out, refs["sos/_etpa"]) <= RTOL


def test_etpa_with_port_biphoton_matches_jax(refs):
    """The port's own Biphoton (its joint temporal amplitude from its
    joint spectral amplitude) drives etpa as the JAX Biphoton does."""
    epp = pt.Biphoton(0.0, 0.04 / au2ev, Te=10.0 * 41.341, **CPU)
    p = np.linspace(-0.5, 0.5, 32) / au2ev
    epp.set_grid(p, p)
    epp.get_jsa()
    out = tsos.etpa(OMEGAPS, port_mol(), epp, g_idx=0, e_idx=[1],
                    f_idx=[2, 3], **CPU)
    assert rel_err(out, refs["sos/etpa"]) <= RTOL


def test_photon_echo_t2series_mesh_not_yet_ported():
    """Ported since: mesh= takes a DeviceMesh (the sharded cube is held to
    JAX's in tests/test_torch_distributed.py) and refuses anything else."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsos.photon_echo_t2series(port_mol(), W, W, T2S, mesh=object(),
                                  **CPU)


# ----------------------------------------------------------------- tdes
@pytest.mark.parametrize("name", sorted(TDES))
def test_tdes_matches_jax(name, refs):
    port, _ = TDES[name]
    _compare(port(), refs[f"tdes/{name}"], RTOL)


# ------------------------------------------------------------------ Mol
def _jax_mol(H=np.diag(E), dip=DIP):
    m = JMol(jnp.asarray(H), edip=jnp.asarray(dip))
    m.gamma = GAMMA
    m.set_dephasing(DEPHASING)
    return m


def test_mol_spectroscopy_methods_match_jax(refs):
    m = port_mol()
    _compare(m.absorption(W, **CPU), refs["sos/absorption"], RTOL)
    _compare(m.PE(W, W, t2=5.0, e_idx=E_IDX, f_idx=F_IDX, **CPU),
             refs["sos/photon_echo"], RTOL)
    _compare(m.photon_echo(W, W, t2=5.0, **CPU),
             refs["sos/photon_echo_default_idx"], RTOL)
    _compare(m.PE2(W, W, t3=4.0, **CPU), refs["sos/photon_echo_t3"], RTOL)


PSI = np.linspace(0.1, 0.6, 6) + 0.2j


def _mol_cases():
    rng = np.random.default_rng(11)
    A = rng.standard_normal((6, 6))
    return {"diagonal": (np.diag(E), DIP), "dense": (A + A.T, EDIP3)}


def _jax_mol_properties(jms):
    """The JAX Mols' traceable properties, one jit for all of them (its
    isdiag check runs in __init__ and eigvals, eagerly)."""
    def props():
        out = {}
        for key, jm in jms.items():
            w, v = jm.eigenstates(k=3)
            out[key] = dict(
                eigenenergies=jm.eigenenergies(), get_dm=jm.get_dm(),
                get_nonhermH=jm.H - 1j * jnp.diag(jnp.asarray(GAMMA)),
                eigenstates=w, projector=v @ v.conj().T,
                groundstate=jnp.abs(jm.groundstate("eig")),
                energy=jm.energy(jnp.asarray(PSI)))
        out["multi"] = jms["diagonal"].multi(2)
        out["get_p_from_r"] = jms["diagonal"].get_p_from_r()
        return out
    return jax.tree_util.tree_map(np.asarray, jax.jit(props)())


def test_mol_properties_match_jax():
    cases = _mol_cases()
    jms = {k: _jax_mol(H, dip) for k, (H, dip) in cases.items()}
    ref = _jax_mol_properties(jms)
    for key, (H, dip) in cases.items():
        m, jm = Mol(H, dip), jms[key]
        m.gamma = GAMMA
        r = ref[key]
        for name in ("eigenenergies", "get_dm", "get_nonhermH"):
            assert abs_err(getattr(m, name)(), r[name]) <= 1e-13, name
        assert abs_err(m.eigvals(), jm.eigvals()) <= 1e-13
        for name in ("getH", "get_edip"):
            assert abs_err(getattr(m, name)(), getattr(jm, name)()) == 0
        for name in ("edip_rms", "lowering", "raising", "idm", "H"):
            assert abs_err(getattr(m, name), getattr(jm, name)) <= 1e-15
        assert (m.E is None) == (jm.E is None)
        w, v = m.eigenstates(k=3)
        assert abs_err(w, r["eigenstates"]) <= 1e-13
        # eigenvectors up to phase: compare the projectors
        assert abs_err(v @ v.conj().T, r["projector"]) <= 1e-13
        assert abs_err(m.groundstate("eig").abs(), r["groundstate"]) <= 1e-13
        assert abs_err(m.energy(PSI), r["energy"]) <= 1e-13
        assert (m.nstates, m.dim, m.size) == (jm.nstates, jm.dim, jm.size)
    m, jm = Mol(np.diag(E), DIP), jms["diagonal"]
    assert abs_err(m.get_p_from_r(), ref["get_p_from_r"]) <= 1e-15
    _compare(m.multi(2), ref["multi"], 1e-15, abs_err)
    m.set_decay_for_all(0.05)
    jm.set_decay_for_all(0.05)
    np.testing.assert_array_equal(m.gamma, jm.gamma)
    m.set_edip(DIP + 1.0)
    jm.set_edip(DIP + 1.0)
    assert abs_err(m.edip_rms, jm.edip_rms) == 0
    # mls (pyqed/mol.py:1988), the JAX package's values
    dip = np.zeros((3, 3))
    dip[1, 2] = dip[2, 1] = dip[0, 1] = dip[1, 0] = 1.0
    assert abs_err(mls().H, np.diag([0.0, 0.6, 10.0]) / au2ev) == 0
    assert abs_err(mls().edip, dip) == 0


def test_mol_deom_returns_the_ports_heom_solver():
    H = np.diag([0.0, 1.0])
    dip = np.array([[0.0, 1.0], [1.0, 0.0]])
    sol = Mol(H, dip).deom(DrudeBath(0.5, 0.5, 0.05), lmax=3, nexp=2,
                           device="cpu")
    jsol = JMol(jnp.asarray(H), edip=jnp.asarray(dip)).deom(
        JDrudeBath(0.5, 0.5, 0.05), lmax=3, nexp=2)
    assert isinstance(sol, HEOMSolver) and not isinstance(sol, JHEOMSolver)
    assert len(sol._modes) == len(jsol._modes)
    for (Q, c, nu), (jQ, jc, jnu) in zip(sol._modes, jsol._modes):
        assert abs_err(Q, jQ) == 0 and abs(c - jc) <= 1e-15 * abs(jc)
        assert abs(nu - jnu) <= 1e-15 * abs(jnu)
    assert abs_err(sol._H_np, jsol._H_np) == 0


def test_mol_cars_and_tpa_raise():
    """The JAX methods hand the molecule to functions that take energies
    (a TypeError there); the port raises NotImplementedError instead."""
    jm = _jax_mol()
    with pytest.raises(TypeError):
        jm.cars(W, W)
    with pytest.raises(TypeError):
        jm.tpa(W)
    m = port_mol()
    with pytest.raises(NotImplementedError, match="mol.py:267"):
        m.cars(W, W)
    with pytest.raises(NotImplementedError, match="mol.py:271"):
        m.tpa(W)


@pytest.mark.parametrize("name", ["run", "evolve", "quantum_dynamics",
                                  "driven_dynamics", "Floquet"])
def test_mol_dynamics_not_yet_ported(name):
    """Ported with the driven-dynamics slice: each method hands the
    molecule to SESolver (or Floquet) on the device asked for and equals
    that call (their parity with JAX is in tests/test_torch_polariton.py)."""
    m = port_mol()
    psi0 = pt.basis(6, 1)
    pulse = pt.GaussianPulse(omegac=1.0, tau=5.0, tc=10.0, amplitude=0.05)
    se = SESolver(m.H, device="cpu")
    kw = dict(dt=0.05, Nt=40)
    if name == "Floquet":
        got = m.Floquet(1.0, 0.02, nt=11, device="cpu").quasienergies()
        ref = pt.floquet.Floquet(m.H, m.edip, 1.0, 0.02, nt=11,
                                 device="cpu").quasienergies()
    else:
        got = {"run": lambda: m.run(psi0, device="cpu", **kw),
               "evolve": lambda: m.evolve(psi0, pulse=pulse, device="cpu",
                                          **kw),
               "quantum_dynamics": lambda: m.quantum_dynamics(
                   psi0, device="cpu", **kw),
               "driven_dynamics": lambda: m.driven_dynamics(
                   psi0, pulse, device="cpu", **kw)}[name]().states
        driven = name in ("evolve", "driven_dynamics")
        ref = se.run(psi0=psi0, pulse=pulse if driven else None,
                     edip=m.edip if driven else None, **kw).states
    assert torch.equal(got, ref)


def test_sesolver_not_yet_ported():
    """Ported with the driven-dynamics slice: a Rabi oscillation on the
    CPU against sin^2(Omega t / 2)."""
    _, sx, _, _ = pt.pauli()
    res = SESolver(0.1 * sx, device="cpu").run(
        psi0=pt.basis(2, 0), dt=0.01, Nt=2000,
        e_ops=[pt.ket2dm(pt.basis(2, 1))])
    p1 = res.observables[:, 0].real.numpy()
    assert np.max(np.abs(p1 - np.sin(0.1 * res.times.numpy()) ** 2)) < 1e-8


def test_signal_device_none_without_card_raises():
    if torch.cuda.is_available():
        return          # device=None runs on the card there
    for call in (lambda: tsos.photon_echo(port_mol(), W, W),
                 lambda: ttdes.twodes(port_mol(), T1, T2, T3),
                 lambda: port_mol().absorption(W)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_root_exports():
    assert pt.Mol is Mol and pt.signal.tdes is ttdes
    assert pt.signal.photon_echo is tsos.photon_echo

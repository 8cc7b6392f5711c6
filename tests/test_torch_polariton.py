"""Parity of the PyTorch port's closed-system driven slice
(pyqed_tpu_torch: models/pulse, SESolver and the dynamics of Mol,
models/cavity, floquet/) with the JAX package, on the CPU at complex128.

Inputs are made with numpy from a seed. Every JAX reference that can be
traced is computed in ONE jitted function (the `refs` fixture), so XLA
compiles once; JAX objects whose constructors need concrete arrays (Mol,
Polariton) are built before the jit, and the few references that read
values on the host (Schmidt numbers, FROG delays, Floquet-state selection,
winding numbers) run eagerly. Tolerances: the pulse fields and the model
operators rel 1e-14; propagations, spectra and Floquet quantities rel
1e-12 (eigendecomposition-based ones 1e-10); eigenvectors are compared
only through quantities that do not depend on their phases.
"""
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyqed_tpu.models.pulse as jpulse
from pyqed_tpu.models import mol as jmol
from pyqed_tpu.models.cavity import Cavity as JCavity
from pyqed_tpu.models.cavity import Polariton as JPolariton
from pyqed_tpu.models.cavity import Composite as JComposite
from pyqed_tpu.models.cavity import QRM as JQRM
import pyqed_tpu.floquet as jfloquet
from pyqed_tpu.units import au2ev, au2fs

import pyqed_tpu_torch as pt
import pyqed_tpu_torch.models.pulse as tpulse
from pyqed_tpu_torch.models import mol as tmol
from pyqed_tpu_torch.models.cavity import Cavity, Composite, Polariton, QRM
import pyqed_tpu_torch.floquet as tfloquet

CPU = dict(device="cpu")
FIELD_TOL = 1e-14
RTOL = 1e-12
EIG_TOL = 1e-10

RNG = np.random.default_rng(7)
N = 5
H5 = RNG.standard_normal((N, N))
H5 = 0.5 * (H5 + H5.T)
MU5 = RNG.standard_normal((N, N))
MU5 = 0.5 * (MU5 + MU5.T)
MU5B = np.diag(RNG.standard_normal(N))
PSI5 = RNG.standard_normal(N) + 1j * RNG.standard_normal(N)
PSI5 = PSI5 / np.linalg.norm(PSI5)
EOP5 = np.diag(RNG.standard_normal(N)).astype(complex)
A5, B5, C5, D5 = [RNG.standard_normal((N, N)) for _ in range(4)]
T = np.linspace(-10.0, 10.0, 201)
W = np.linspace(0.0, 2.0, 101)
PULSE_KW = dict(omegac=0.9, tau=3.0, tc=1.0, amplitude=0.02, beta=0.3,
                polarization=[1.0, 0.5, 0.0])
PULSES = {"Pulse": (jpulse.Pulse, tpulse.Pulse),
          "GaussianPulse": (jpulse.GaussianPulse, tpulse.GaussianPulse),
          "ChirpedPulse": (jpulse.ChirpedPulse, tpulse.ChirpedPulse)}
# the entangled pair: a 24-point frequency grid around the pump
P = np.linspace(-0.5, 0.5, 24) / au2ev
Q = np.linspace(-0.45, 0.55, 24) / au2ev
BW, TE, OMP = 0.04 / au2ev, 10.0 * 41.341, 2.0 / au2ev
TAUS = np.linspace(-400.0, 400.0, 9)
# SESolver cases
SE = dict(dt=0.005, Nt=200, nout=10)
DRIVE = dict(dt=0.5, Nt=400, t0=-10.0 / au2fs)
H2 = np.diag([0.0, 1.0 / au2ev]).astype(complex)
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SZ = np.diag([1.0, -1.0])
# Floquet cases
FL_OMEGA, FL_E0 = 0.8, 0.3
KS = np.linspace(-np.pi, np.pi, 15, endpoint=False)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def rel_err(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def tls(omega0=1.0):
    """tests/test_cavity_floquet.py's two-level molecule (sigma_x dipole,
    sigma_- lowering), for either package."""
    return (jmol.Mol(jnp.diag(jnp.array([0.0, omega0])),
                     edip=jnp.asarray(SX), lowering=jnp.asarray([[0, 1.0],
                                                                [0, 0]])),
            tmol.Mol(np.diag([0.0, omega0]), edip=SX,
                     lowering=np.array([[0, 1.0], [0, 0]])))


def polaritons():
    """(JAX, port) polaritons: the two-level molecule in a 4-level cavity,
    in the length gauge (RWA or not) and in the velocity gauge."""
    out = {}
    for gauge in ("length", "velocity"):
        jm, tm = tls(1.1)
        jm.set_decay_for_all(0.02)
        tm.set_decay_for_all(0.02)
        kw = dict(freq=1.0, n_cav=4, decay=0.01, quality_factor=50.0)
        out[gauge] = (JPolariton(jm, JCavity(**kw), g=0.07, gauge=gauge),
                      Polariton(tm, Cavity(**kw), g=0.07, gauge=gauge))
    return out


def peierls():
    hops, _ = jfloquet.gomez_leon_model(b=0.4, t=1.0, a=1.0)
    return hops


def _jax_refs():
    """Every traced JAX reference of this module, from one jit."""
    jpols = polaritons()
    jmols = {"diag": jmol.Mol(jnp.asarray(np.diag(np.arange(N) * 0.3))),
             "dense": jmol.Mol(jnp.asarray(H5), edip=jnp.asarray(MU5))}
    jqrm = JQRM(0.9, 1.0, ncav=5)
    jqrm.g = 0.05

    def everything(a):
        a = SimpleNamespace(**a)
        out = {}
        for name, (cls, _) in PULSES.items():
            p = cls(**PULSE_KW)
            for m in ("efield", "efield_complex", "envelop", "field"):
                out[f"pulse/{name}/{m}"] = getattr(p, m)(a.T)
            out[f"pulse/{name}/spectrum"] = p.spectrum(a.W)
            out[f"pulse/{name}/E"] = p.E(a.T[37])
        out["jsa/sinc"] = jpulse.jsa(a.P, a.Q, BW, model="sinc", Te=TE)
        out["jsa/Gaussian"] = jpulse.jsa(a.P, a.Q, BW, model="Gaussian",
                                         Te=TE)
        out["jta"] = jpulse.jta(a.P * 50, a.Q * 40, OMP, BW, TE)
        f = out["jsa/sinc"]
        out["rdm/x"] = jpulse.rdm(f, 0.3, 0.7, "x")
        out["rdm/y"] = jpulse.rdm(f, 0.3, 0.7, "y")
        out["hom"] = jpulse.hom(a.P, a.Q, f, a.TAUS)
        s, phi, chi = jpulse.schmidt_decompose(f, 0.3, 0.7, nmodes=6)
        out["schmidt/svd"] = (s, jnp.einsum("a, pa, qa -> pq", s, phi, chi))
        s, phi, chi = jpulse.schmidt_decompose(f, 0.3, 0.7, nmodes=6,
                                               method="rdm")
        out["schmidt/rdm"] = (s, jnp.einsum("a, pa, qa -> pq", s, phi, chi))
        bp = jpulse.Biphoton(OMP, BW, TE, p=a.P, q=a.Q)
        out["biphoton/jsa"] = bp.get_jsa()
        out["biphoton/jta"] = bp.get_jta()
        out["biphoton/detect"] = bp.detect()
        out["biphoton/pump"] = bp.pump()
        for w in ("signal", "idler"):
            out[f"biphoton/bandwidth/{w}"] = bp.bandwidth(w)
            out[f"biphoton/rdm/{w}"] = bp.rdm(w)

        se = jmol.SESolver(jnp.asarray(H5))
        r = se.run(psi0=a.PSI, e_ops=[jnp.asarray(EOP5)], **SE)
        out["se/rk4"] = (r.times, r.observables, r.states, r.psi)
        r = se.run(psi0=a.PSI, e_ops=[jnp.asarray(EOP5)], method="expm",
                   **SE)
        out["se/expm"] = (r.observables, r.psi)
        pulse = jpulse.Pulse(omegac=1.0 / au2ev, tau=2.0 / au2fs,
                             amplitude=0.01)
        r = jmol.SESolver(jnp.asarray(H2)).run(
            psi0=jnp.asarray([1.0, 0.0j]), pulse=pulse, edip=jnp.asarray(SX),
            e_ops=[jnp.asarray(np.diag([0.0, 1.0]))], **DRIVE)
        out["se/driven"] = (r.times, r.observables, r.psi)
        pulses = [jpulse.GaussianPulse(omegac=1.2, tau=0.3, amplitude=0.5),
                  lambda t: 0.2 * jnp.sin(0.7 * t)]
        r = se.run(psi0=a.PSI, pulse=pulses,
                   edip=[jnp.asarray(MU5), jnp.asarray(MU5B)], t0=-0.5, **SE)
        out["se/driven2"] = (r.times, r.states)
        kw = dict(dt=0.02, Nt=30)
        out["se/c3_1t"] = se.correlation_3op_1t(a.PSI, [A5, B5, C5], **kw)
        out["se/c2_1t"] = se.correlation_2op_1t(a.PSI, [A5, B5], **kw)
        out["se/c4_1t"] = se.correlation_4op_1t(a.PSI, [A5, B5, C5, D5],
                                                **kw)
        out["se/c3_2t"] = se.correlation_3op_2t(a.PSI, [A5, B5, C5], 0.02,
                                                4, 6)
        out["se/c4_2t"] = se.correlation_4op_2t(a.PSI, [A5, B5, C5, D5],
                                                0.02, 3, 5)
        out["se/prop/diag"] = se.propagator(0.1, 6)
        out["se/prop/rk4"] = se.propagator(0.1, 6, method="rk4")
        out["se/tdse"] = jmol.tdse(a.PSI, jnp.asarray(H5))
        jm = jmols["dense"]
        gp = jpulse.GaussianPulse(omegac=1.0, tau=2.0, tc=3.0, amplitude=0.1)
        out["mol/run"] = jm.run(a.PSI, dt=0.05, nt=40, pulse=gp).states
        out["mol/quantum_dynamics"] = jm.quantum_dynamics(
            a.PSI, dt=0.05, Nt=40, e_ops=[EOP5]).observables
        out["mol/driven_dynamics"] = jm.driven_dynamics(
            a.PSI, gp, dt=0.05, Nt=40, e_ops=[EOP5]).observables
        out["quantum_dynamics"] = jmol.quantum_dynamics(
            jnp.asarray(H5), a.PSI, dt=0.05, Nt=40).psi
        out["driven_dynamics"] = jmol.driven_dynamics(
            jnp.asarray(H5), jnp.asarray(MU5), a.PSI, gp, dt=0.05, Nt=40,
            obs_ops=[EOP5]).observables
        out["mol/floquet"] = jm.Floquet(0.9, 0.2, nt=7).quasienergies()

        for gauge, (jp, _) in jpols.items():
            H = jp.getH()
            w, v, nph = jp.eigenstates()
            out[f"pol/{gauge}/H"] = H
            out[f"pol/{gauge}/eig"] = (w, nph)
            out[f"pol/{gauge}/nonherm"] = jp.get_nonhermitianH()
            out[f"pol/{gauge}/rdm_photon"] = jp.rdm_photon(v[:, 3])
            out[f"pol/{gauge}/purity"] = jp.purity(v[:, 3])
            out[f"pol/{gauge}/driven"] = jp.driven_dynamics(
                a.PSIP, gp, dt=0.05, nt=60, e_ops=[jp.get_edip()]).observables
        jp = jpols["length"][0]
        out["pol/rwa/H"] = jp.getH(RWA=True)
        out["pol/rwa/nonherm"] = jp.get_nonhermitianH(RWA=True)
        out["pol/get_dm"] = jp.get_dm()
        out["pol/cav_leak"] = jp.get_cav_leak()
        out["qrm"] = jqrm.getH(RWA=False)

        out["floquet/matrix"] = jfloquet.floquet_matrix(a.BLOCKS, 2.5, 7)
        fl = jfloquet.Floquet(jnp.asarray(H5), jnp.asarray(MU5), FL_OMEGA,
                              FL_E0, nt=9)
        out["floquet/qe"] = fl.quasienergies(first_bz=False)
        out["floquet/ext"] = fl.extended_hamiltonian()
        tb = jfloquet.TightBinding(coords=[[0.0], [0.35]], nk=17)
        out["tb"] = tb.run()
        hops, Hk = jfloquet.gomez_leon_model(b=0.4, t=1.0, a=1.0)
        blocks = jfloquet.make_peierls_blocks_fn(hops, 3.0, nmax=2)
        out["peierls"] = blocks(0.7, 1.5)
        fb = jfloquet.FloquetBloch(blocks, 3.0, nt=5, norbs=2, Hk_func=Hk)
        out["fb/qe"] = fb.quasienergies(KS, 1.5)
        out["fb/run"] = fb.run(KS, E0=1.5, nE_steps=4)
        out["free"] = jfloquet.light_driven_free_electron(
            tf=8.0, nt=200, E0=0.8, omega=1.3, cep=0.4, omega0=0.2)
        out["cep"] = jfloquet.cep_scan(jnp.asarray([0.0, 0.7]), tf=5.0,
                                       nt=100, polarization="linear")
        return out

    arrays = dict(T=T, W=W, P=P, Q=Q, TAUS=TAUS, PSI=PSI5,
                  PSIP=np.eye(8)[2].astype(complex),
                  BLOCKS=RNG.standard_normal((3, 2, 2)) + 0j)
    out = jax.jit(everything)({k: jnp.asarray(v) for k, v in arrays.items()})
    return jax.tree_util.tree_map(np.asarray, out), arrays


@pytest.fixture(scope="module")
def refs():
    return _jax_refs()


def _compare(port, ref, tol):
    if isinstance(ref, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _compare(p, r, tol)
        return
    assert rel_err(port, ref) <= tol


# ---------------------------------------------------------------- pulses
@pytest.mark.parametrize("name", sorted(PULSES))
def test_pulse_fields_match_jax(refs, name):
    ref, _ = refs
    p = PULSES[name][1](**PULSE_KW)
    for m in ("efield", "efield_complex", "envelop", "field"):
        # NumPy in, NumPy out; a tensor in, a tensor out
        assert rel_err(getattr(p, m)(T), ref[f"pulse/{name}/{m}"]) \
            <= FIELD_TOL, m
        out = getattr(p, m)(torch.as_tensor(T))
        assert isinstance(out, torch.Tensor)
        assert rel_err(out, ref[f"pulse/{name}/{m}"]) <= FIELD_TOL, m
    assert rel_err(p.spectrum(W), ref[f"pulse/{name}/spectrum"]) <= FIELD_TOL
    # the polarized field at one time (3,)
    assert rel_err(p.E(T[37]), ref[f"pulse/{name}/E"]) <= FIELD_TOL
    assert rel_err(p.E(torch.tensor(T[37])), ref[f"pulse/{name}/E"]) \
        <= FIELD_TOL
    # a float in, a float out: what the solvers read on the host
    e = p.efield(0.37)
    assert isinstance(e, float) and e == pytest.approx(
        float(np.interp(0.37, T, ref[f"pulse/{name}/efield"])), abs=1e-3)


def test_pulse_from_reference_and_helpers():
    jp = jpulse.ChirpedPulse(intensity=1e12, omegac=0.5, tau=4.0, beta=0.2)
    tp = tpulse.Pulse.from_reference(jp)
    assert type(tp) is tpulse.ChirpedPulse
    assert rel_err(tp.efield(T), np.asarray(jp.efield(T))) <= FIELD_TOL
    assert tp.amplitude == jp.amplitude
    for name in ("intensity_to_field", "field_to_intensity", "std_to_fwhm",
                 "fwhm_to_std"):
        x = np.array([0.3, 1e13])
        assert rel_err(getattr(tpulse, name)(x),
                       getattr(jpulse, name)(x)) <= FIELD_TOL, name


# -------------------------------------------------------------- biphoton
def test_amplitudes_match_jax(refs):
    ref, _ = refs
    assert rel_err(tpulse.jsa(P, Q, BW, model="sinc", Te=TE, **CPU),
                   ref["jsa/sinc"]) <= FIELD_TOL
    assert rel_err(tpulse.jsa(P, Q, BW, model="Gaussian", Te=TE, **CPU),
                   ref["jsa/Gaussian"]) <= FIELD_TOL
    assert rel_err(tpulse.jta(P * 50, Q * 40, OMP, BW, TE, **CPU),
                   ref["jta"]) <= FIELD_TOL
    f = tpulse.jsa(P, Q, BW, model="sinc", Te=TE, **CPU)
    assert rel_err(tpulse.rdm(f, 0.3, 0.7, "x", **CPU), ref["rdm/x"]) <= RTOL
    assert rel_err(tpulse.rdm(f, 0.3, 0.7, "y", **CPU), ref["rdm/y"]) <= RTOL
    assert rel_err(tpulse.hom(P, Q, f, TAUS, **CPU), ref["hom"]) <= RTOL


@pytest.mark.parametrize("method", ["svd", "rdm"])
def test_schmidt_decompose_matches_jax(refs, method):
    """Singular values and the reconstructed kernel sum_a s_a phi_a chi_a,
    not the singular vectors."""
    ref, _ = refs
    f = tpulse.jsa(P, Q, BW, model="sinc", Te=TE, **CPU)
    s, phi, chi = tpulse.schmidt_decompose(f, 0.3, 0.7, nmodes=6,
                                           method=method, **CPU)
    rs, rk = ref[f"schmidt/{method}"]
    assert rel_err(s, rs) <= EIG_TOL
    assert rel_err(torch.einsum("a, pa, qa -> pq", s.to(phi.dtype), phi,
                                chi), rk) <= EIG_TOL


def test_schmidt_numbers_and_hom_schmidt_match_jax():
    f = np.array(jpulse.jsa(P, Q, BW, model="sinc", Te=TE))
    dp, dq = P[1] - P[0], Q[1] - Q[0]
    assert tpulse.schmidt_number(torch.as_tensor(f), dp, dq, **CPU) == \
        pytest.approx(jpulse.schmidt_number(f, dp, dq), rel=EIG_TOL)
    assert rel_err(tpulse.hom_schmidt(P, Q, f, TAUS, nmodes=6, **CPU),
                   jpulse.hom_schmidt(P, Q, f, TAUS, nmodes=6)) <= EIG_TOL
    jb = jpulse.Biphoton(OMP, BW, TE, p=P, q=Q)
    tb = tpulse.Biphoton(OMP, BW, TE, p=P, q=Q, **CPU)
    assert tb.g2() == pytest.approx(jb.g2(), rel=EIG_TOL)
    assert tb.schmidt_number() == pytest.approx(jb.schmidt_number(),
                                                rel=EIG_TOL)


def test_biphoton_matches_jax(refs):
    ref, _ = refs
    b = tpulse.Biphoton(OMP, BW, TE, p=P, q=Q, **CPU)
    assert rel_err(b.get_jsa(), ref["biphoton/jsa"]) <= FIELD_TOL
    _compare(b.get_jta(), ref["biphoton/jta"], RTOL)
    _compare(b.detect(), ref["biphoton/detect"], RTOL)
    assert rel_err(b.pump(), ref["biphoton/pump"]) <= FIELD_TOL
    for w in ("signal", "idler"):
        assert rel_err(b.bandwidth(w), ref[f"biphoton/bandwidth/{w}"]) <= RTOL
        assert rel_err(b.rdm(w), ref[f"biphoton/rdm/{w}"]) <= RTOL
    assert b.p.device.type == "cpu" and tuple(b.grid[0].shape) == P.shape


@pytest.mark.parametrize("gate", [None, "spectrogram"])
def test_analyser_matches_jax(gate):
    t = np.linspace(-20.0, 20.0, 64)
    E = np.array(jpulse.GaussianPulse(omegac=0.6, tau=4.0).efield(t))
    ja, ta = jpulse.Analyser(E, t), tpulse.Analyser(E, t, **CPU)
    fn = (lambda a: a.frog()) if gate is None else (lambda a: a.spectrogram())
    (jw, jt, jtr), (tw, tt, ttr) = fn(ja), fn(ta)
    np.testing.assert_array_equal(tw, jw)
    assert np.max(np.abs(tt - jt)) == 0
    assert rel_err(ttr, jtr) <= RTOL


# -------------------------------------------------------------- SESolver
def test_sesolver_rk4_and_expm_match_jax(refs):
    ref, a = refs
    se = tmol.SESolver(H5, **CPU)
    r = se.run(psi0=PSI5, e_ops=[EOP5], **SE)
    _compare((r.times, r.observables, r.states, r.psi), ref["se/rk4"], RTOL)
    r = se.run(psi0=PSI5, e_ops=[EOP5], method="expm", **SE)
    _compare((r.observables, r.psi), ref["se/expm"], EIG_TOL)
    assert rel_err(tmol.tdse(torch.as_tensor(PSI5), torch.as_tensor(H5)
                             .to(torch.complex128)), ref["se/tdse"]) <= RTOL


def test_sesolver_driven_matches_jax(refs):
    """H(t) = H0 - E(t) mu: one Pulse from t0 < 0 (tests/test_sesolver.py:
    72), and two fields (a pulse and a plain function) on two dipoles."""
    ref, _ = refs
    pulse = tpulse.Pulse(omegac=1.0 / au2ev, tau=2.0 / au2fs, amplitude=0.01)
    r = tmol.SESolver(H2, **CPU).run(
        psi0=np.array([1.0, 0.0j]), pulse=pulse, edip=SX,
        e_ops=[np.diag([0.0, 1.0])], **DRIVE)
    _compare((r.times, r.observables, r.psi), ref["se/driven"], RTOL)
    pulses = [tpulse.GaussianPulse(omegac=1.2, tau=0.3, amplitude=0.5),
              lambda t: 0.2 * np.sin(0.7 * t)]
    r = tmol.SESolver(H5, **CPU).run(psi0=PSI5, pulse=pulses,
                                     edip=[MU5, MU5B], t0=-0.5, **SE)
    _compare((r.times, r.states), ref["se/driven2"], RTOL)


@pytest.mark.parametrize("name", ["c3_1t", "c2_1t", "c4_1t", "c3_2t",
                                  "c4_2t"])
def test_sesolver_correlations_match_jax(refs, name):
    ref, _ = refs
    se = tmol.SESolver(H5, **CPU)
    kw = dict(dt=0.02, Nt=30)
    got = {"c3_1t": lambda: se.correlation_3op_1t(PSI5, [A5, B5, C5], **kw),
           "c2_1t": lambda: se.correlation_2op_1t(PSI5, [A5, B5], **kw),
           "c4_1t": lambda: se.correlation_4op_1t(PSI5, [A5, B5, C5, D5],
                                                  **kw),
           "c3_2t": lambda: se.correlation_3op_2t(PSI5, [A5, B5, C5], 0.02,
                                                  4, 6),
           "c4_2t": lambda: se.correlation_4op_2t(PSI5, [A5, B5, C5, D5],
                                                  0.02, 3, 5)}[name]()
    assert rel_err(got, ref[f"se/{name}"]) <= RTOL


@pytest.mark.parametrize("method", ["diag", "rk4"])
def test_sesolver_propagator_matches_jax(refs, method):
    ref, _ = refs
    U = tmol.SESolver(H5, **CPU).propagator(0.1, 6, method=method)
    assert rel_err(U, ref[f"se/prop/{method}"]) <= EIG_TOL


def test_mol_dynamics_match_jax(refs):
    ref, _ = refs
    m = tmol.Mol(H5, edip=MU5)
    gp = tpulse.GaussianPulse(omegac=1.0, tau=2.0, tc=3.0, amplitude=0.1)
    assert rel_err(m.run(PSI5, dt=0.05, nt=40, pulse=gp, **CPU).states,
                   ref["mol/run"]) <= RTOL
    assert rel_err(m.quantum_dynamics(PSI5, dt=0.05, Nt=40, e_ops=[EOP5],
                                      **CPU).observables,
                   ref["mol/quantum_dynamics"]) <= RTOL
    assert rel_err(m.driven_dynamics(PSI5, gp, dt=0.05, Nt=40, e_ops=[EOP5],
                                     **CPU).observables,
                   ref["mol/driven_dynamics"]) <= RTOL
    assert rel_err(tmol.quantum_dynamics(H5, PSI5, dt=0.05, Nt=40,
                                         **CPU).psi,
                   ref["quantum_dynamics"]) <= RTOL
    assert rel_err(tmol.driven_dynamics(H5, MU5, PSI5, gp, dt=0.05, Nt=40,
                                        obs_ops=[EOP5], **CPU).observables,
                   ref["driven_dynamics"]) <= RTOL
    assert rel_err(m.Floquet(0.9, 0.2, nt=7, **CPU).quasienergies(),
                   ref["mol/floquet"]) <= EIG_TOL


def test_mol_from_reference_and_read_input(tmp_path):
    jm = jmol.Mol(jnp.asarray(H5), edip=jnp.asarray(MU5))
    jm.set_decay_for_all(0.1)
    tm = tmol.Mol.from_reference(jm)
    for name in ("H", "edip", "lowering", "raising"):
        assert rel_err(getattr(tm, name), getattr(jm, name)) == 0, name
    np.testing.assert_array_equal(tm.gamma, jm.gamma)
    names = []
    for k in range(3):
        names.append(str(tmp_path / f"d{k}.dat"))
        np.savetxt(names[-1], RNG.standard_normal((4, 4)))
    for g, E in ((True, [0.0, 0.1, 0.5, 0.9]), (False, [0.1, 0.5, 0.9])):
        np.savetxt(tmp_path / "E.dat", E)
        got = tmol.read_input(str(tmp_path / "E.dat"), names, g_included=g)
        ref = jmol.read_input(str(tmp_path / "E.dat"), names, g_included=g)
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x, y)


def test_sesolver_rabi_and_device_default():
    """tests/test_sesolver.py:22 on the port; SESolver() takes the card
    unless told otherwise."""
    _, sx, _, _ = pt.pauli()
    res = tmol.SESolver(0.1 * sx, **CPU).run(
        psi0=pt.basis(2, 0), dt=0.01, Nt=2000,
        e_ops=[pt.ket2dm(pt.basis(2, 1))])
    p1 = host(res.observables[:, 0].real)
    assert np.max(np.abs(p1 - np.sin(0.1 * host(res.times)) ** 2)) < 1e-8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tmol.SESolver(np.eye(2))


def _qrm_eigenstates(**kw):
    qrm = QRM(0.9, 1.0, ncav=3)
    qrm.g = 0.05
    qrm.getH()
    return qrm.eigenstates(**kw)


def _composite_spectrum(**kw):
    comp = Composite(tls(1.0)[1], Cavity(freq=0.8, n_cav=3))
    comp.getH()
    return comp.spectrum(**kw)


DEVICE_DEFAULT = {
    "jsa": lambda **kw: tpulse.jsa(P, Q, BW, Te=TE, **kw),
    "jta": lambda **kw: tpulse.jta(P, Q, OMP, BW, TE, **kw),
    "rdm": lambda **kw: tpulse.rdm(A5, **kw),
    "hom": lambda **kw: tpulse.hom(P[:5], Q[:5], A5, TAUS, **kw),
    "schmidt_decompose": lambda **kw: tpulse.schmidt_decompose(
        A5, 0.3, 0.7, **kw),
    "schmidt_number": lambda **kw: tpulse.schmidt_number(A5, 0.3, 0.7, **kw),
    "hom_schmidt": lambda **kw: tpulse.hom_schmidt(
        P[:5], Q[:5], A5, TAUS, nmodes=3, **kw),
    "QRM.eigenstates": _qrm_eigenstates,
    "Composite.spectrum": _composite_spectrum,
    "floquet_matrix": lambda **kw: tfloquet.floquet_matrix(
        np.stack([MU5, H5, MU5]), 0.8, 3, **kw),
}


@pytest.mark.parametrize("name", sorted(DEVICE_DEFAULT))
def test_entry_point_takes_the_card_by_default(name):
    """Every entry point runs on the card unless told otherwise: without a
    card, device=None raises; device='cpu' runs."""
    call = DEVICE_DEFAULT[name]
    out = call(**CPU)
    leaf = out[0] if isinstance(out, tuple) else out
    assert not isinstance(leaf, torch.Tensor) or leaf.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            call()


# --------------------------------------------------------------- cavity
@pytest.mark.parametrize("gauge", ["length", "velocity"])
def test_polariton_matches_jax(refs, gauge):
    ref, _ = refs
    tp = polaritons()[gauge][1]
    assert rel_err(tp.getH(), ref[f"pol/{gauge}/H"]) <= FIELD_TOL
    w, v, nph = tp.eigenstates(**CPU)
    _compare((w, nph), ref[f"pol/{gauge}/eig"], EIG_TOL)
    assert rel_err(tp.get_nonhermitianH(), ref[f"pol/{gauge}/nonherm"]) \
        <= FIELD_TOL
    assert rel_err(tp.rdm_photon(v[:, 3]), ref[f"pol/{gauge}/rdm_photon"]) \
        <= EIG_TOL
    assert rel_err(tp.purity(v[:, 3]), ref[f"pol/{gauge}/purity"]) <= EIG_TOL
    gp = tpulse.GaussianPulse(omegac=1.0, tau=2.0, tc=3.0, amplitude=0.1)
    r = tp.driven_dynamics(np.eye(8)[2].astype(complex), gp, dt=0.05, nt=60,
                           e_ops=[tp.get_edip()], **CPU)
    assert rel_err(r.observables, ref[f"pol/{gauge}/driven"]) <= RTOL
    # H in its own eigenbasis is diagonal with the spectrum
    assert rel_err(tp.transform_basis(tp.H), np.diag(host(w))) <= EIG_TOL


def test_polariton_rwa_operators_and_qrm_match_jax(refs):
    ref, _ = refs
    tp = polaritons()["length"][1]
    assert rel_err(tp.getH(RWA=True), ref["pol/rwa/H"]) <= FIELD_TOL
    assert rel_err(tp.get_nonhermitianH(RWA=True), ref["pol/rwa/nonherm"]) \
        <= FIELD_TOL
    assert rel_err(tp.get_dm(), ref["pol/get_dm"]) <= FIELD_TOL
    assert rel_err(tp.get_cav_leak(), ref["pol/cav_leak"]) <= FIELD_TOL
    qrm = QRM(0.9, 1.0, ncav=5)
    qrm.g = 0.05
    assert rel_err(qrm.getH(RWA=False), ref["qrm"]) <= FIELD_TOL


def test_cavity_and_composite_match_jax():
    kw = dict(freq=0.8, n_cav=4, decay=0.02, quality_factor=30.0)
    jc, tc = JCavity(**kw), Cavity(**kw)
    for name in ("getH", "nonhermH", "get_nonhermitianH", "num", "quadrature",
                 "vacuum_dm", "annihilate", "create"):
        assert rel_err(getattr(tc, name)(), getattr(jc, name)()) \
            <= FIELD_TOL, name
    assert rel_err(Cavity.from_reference(jc).getH(), jc.getH()) == 0
    jm, tm = tls(1.0)
    jm.gamma = tm.gamma = np.array([0.0, 0.05])
    jcomp, tcomp = JComposite(jm, jc), Composite(tm, tc)
    ops = dict(a_ops=[SX.astype(complex)], b_ops=[np.asarray(jc.quadrature())],
               g=[0.1])
    assert rel_err(tcomp.getH(**ops), jcomp.getH(**ops)) <= FIELD_TOL
    assert rel_err(tcomp.get_nonhermH(**ops), jcomp.get_nonhermH(**ops)) \
        <= FIELD_TOL
    assert rel_err(tcomp.promote(SZ, "A"),
                   jcomp.promote(SZ, "A")) == 0
    psi = RNG.standard_normal(8) + 1j * RNG.standard_normal(8)
    for which in ("A", "B"):
        assert rel_err(tcomp.rdm(psi, which), jcomp.rdm(psi, which)) <= RTOL
    jpol = JPolariton(jm, jc, g=0.05)
    jpol.getH()
    tpol = Polariton.from_reference(jpol)
    assert rel_err(tpol.H, jpol.H) == 0 and tpol.gauge == jpol.gauge


def test_jaynes_cummings_and_vacuum_rabi():
    """tests/test_cavity_floquet.py:29 and :63 on the port: the resonant
    doublet at omega -+ g with half photon character, and |e, 0> -> |g, 1>
    at frequency 2g."""
    _, tm = tls(1.0)
    pol = Polariton(tm, Cavity(freq=1.0, n_cav=5), g=0.1)
    pol.getH(RWA=True)
    evals, _, nph = pol.eigenstates(**CPU)
    E = np.sort(host(evals))
    assert abs(E[0]) < 1e-12 and abs(E[1] - 0.9) < 1e-10
    assert abs(E[2] - 1.1) < 1e-10
    nph = host(nph)[np.argsort(host(evals))]
    assert abs(nph[1] - 0.5) < 1e-8 and abs(nph[2] - 0.5) < 1e-8
    _, tm = tls(1.0)
    pol = Polariton(tm, Cavity(freq=1.0, n_cav=3), g=0.05)
    H = pol.getH(RWA=True)
    psi0 = torch.kron(pt.basis(2, 1), pt.basis(3, 0))
    num = pol.promote_op(pol.cav.num(), kind="cav")
    res = tmol.SESolver(H, **CPU).run(psi0=psi0, dt=0.05, Nt=2000,
                                      e_ops=[num], method="expm")
    assert np.max(np.abs(host(res.observables[:, 0].real)
                         - np.sin(0.05 * host(res.times)) ** 2)) < 1e-10


def test_cavity_leak_lindblad():
    """tests/test_cavity_floquet.py:79: the photon leaks at kappa through
    the port's LindbladSolver."""
    _, tm = tls(1.0)
    pol = Polariton(tm, Cavity(freq=1.0, n_cav=3, decay=0.1), g=0.0)
    H = pol.getH(RWA=True)
    c = np.sqrt(0.1) * pol.get_cav_leak()
    rho0 = pt.ket2dm(torch.kron(pt.basis(2, 0), pt.basis(3, 1)))
    num = pol.promote_op(pol.cav.num(), kind="cav")
    res = pt.LindbladSolver(H, c_ops=[c], **CPU).run(rho0, dt=0.05, Nt=400,
                                                     e_ops=[num])
    assert np.max(np.abs(host(res.observables[:, 0].real)
                         - np.exp(-0.1 * host(res.times)))) < 1e-8


# -------------------------------------------------------------- floquet
def test_floquet_matrix_and_finite_floquet_match_jax(refs):
    ref, a = refs
    assert rel_err(tfloquet.floquet_matrix(a["BLOCKS"], 2.5, 7, **CPU),
                   ref["floquet/matrix"]) <= FIELD_TOL
    fl = tfloquet.Floquet(H5, MU5, FL_OMEGA, FL_E0, nt=9, **CPU)
    assert rel_err(fl.extended_hamiltonian(), ref["floquet/ext"]) \
        <= FIELD_TOL
    assert rel_err(fl.quasienergies(first_bz=False), ref["floquet/qe"]) \
        <= EIG_TOL
    w = host(fl.quasienergies())
    assert np.all((w >= -FL_OMEGA / 2) & (w < FL_OMEGA / 2))


def test_floquet_states_and_evolution_match_jax():
    """The physical Floquet states (their quasienergies) and psi(t), which
    do not depend on the eigenvectors' phases."""
    H = np.diag([0.0, 1.0]).astype(complex)
    jf = jfloquet.Floquet(jnp.asarray(H), jnp.asarray(SX + 0j), 0.8, 0.3,
                          nt=21)
    tf = tfloquet.Floquet.from_reference(jf, **CPU)
    eps_j, _ = jf.states()
    eps_t, modes = tf.states()
    assert rel_err(np.sort(host(eps_t)), np.sort(np.asarray(eps_j))) \
        <= EIG_TOL
    assert tuple(modes.shape) == (21, 2, 2)
    times = np.linspace(0.0, 25.0, 6)[1:]
    psi0 = np.array([1.0, 0.0], complex)
    assert rel_err(tf.run(psi0, times), jf.run(psi0, times)) <= EIG_TOL


def test_floquet_evolution_chiral_drive_amplitudes():
    """tests/test_cavity_floquet.py:267 on the port: complex amplitudes of
    a circularly polarized drive against direct RK4."""
    delta, A, w = 1.0, 0.3, 2.5
    sy = np.array([[0.0, -1j], [1j, 0.0]])
    H0 = 0.5 * delta * SZ
    blocks = np.stack([A * (SX + 1j * sy) / 2, H0, A * (SX - 1j * sy) / 2])
    psi0 = np.array([1.0, 0.0], complex)
    ts = np.linspace(0, 5, 11)
    psis = host(tfloquet.floquet_evolution(blocks, w, 31, psi0, ts, **CPU))

    def rhs(p, t):
        return -1j * ((H0 + A * (SX * np.cos(w * t) + sy * np.sin(w * t)))
                      @ p)

    p, dt, out = psi0.copy(), 0.0005, [psi0.copy()]
    for k in range(int(5 / dt)):
        t = k * dt
        k1 = rhs(p, t)
        k2 = rhs(p + k1 * dt / 2, t + dt / 2)
        k3 = rhs(p + k2 * dt / 2, t + dt / 2)
        k4 = rhs(p + k3 * dt, t + dt)
        p = p + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(p.copy())
    assert np.max(np.abs(psis - np.array(out)[(ts / dt).round().astype(int)])) \
        < 1e-8


def test_bloch_floquet_match_jax(refs):
    ref, a = refs
    tb = tfloquet.TightBinding(coords=[[0.0], [0.35]], nk=17, **CPU)
    _compare(tb.run(), ref["tb"], EIG_TOL)
    hops, Hk = tfloquet.gomez_leon_model(b=0.4, t=1.0, a=1.0)
    blocks = tfloquet.make_peierls_blocks_fn(hops, 3.0, nmax=2)
    assert rel_err(blocks(0.7, 1.5), ref["peierls"]) <= FIELD_TOL
    fb = tfloquet.FloquetBloch(blocks, 3.0, nt=5, norbs=2, Hk_func=Hk, **CPU)
    assert rel_err(fb.quasienergies(KS, 1.5), ref["fb/qe"]) <= EIG_TOL
    qe, states = fb.run(KS, E0=1.5, nE_steps=4)
    assert rel_err(qe, ref["fb/run"][0]) <= EIG_TOL
    assert tuple(states.shape) == ref["fb/run"][1].shape
    # Berry phases of the tracked bands, as e^{i pi w}: w is taken mod 2
    # (a phase of -1e-16 reads 2), and the port's own states are in
    # another gauge
    jfb = jfloquet.FloquetBloch(None, 3.0, 5, 2)
    jstates = ref["fb/run"][1]
    for band in (0, 1):
        w_j = np.exp(1j * np.pi * jfb.winding_number(band, states=jstates))
        for states in (jstates, None):
            assert abs(np.exp(1j * np.pi * fb.winding_number(
                band, states=states)) - w_j) < 1e-8


def _loop(theta, nk=64):
    """A closed loop of two-level states (cos theta, sin theta e^{ik}),
    Berry phase -2 pi sin^2(theta) (a generic value, away from 0 and pi,
    where the rounding of subspace_winding is well defined)."""
    ks = np.linspace(0.0, 2 * np.pi, nk, endpoint=False)
    return np.stack([np.full(nk, np.cos(theta)),
                     np.sin(theta) * np.exp(1j * ks)], axis=1)


@pytest.mark.parametrize("theta", [0.6, 1.0])
def test_subspace_winding_matches_jax(theta):
    states = [_loop(theta)]
    jfb = jfloquet.FloquetBloch(None, 1.0, 1, 2)
    fb = tfloquet.FloquetBloch(None, 1.0, 1, 2, **CPU)
    assert fb.subspace_winding([0], states=states) == \
        jfb.subspace_winding([0], states=states)
    assert fb.winding_number(0, states=states) == pytest.approx(
        jfb.winding_number(0, states=states), abs=1e-12)


def test_ssh_berry_phase():
    """tests/test_cavity_floquet.py:156 on the port: the lower SSH band's
    Berry phase is 0 below the transition and pi above it. It is read as
    e^{i pi w}: at these quantised phases the rounding in winding_number
    and subspace_winding (the JAX package's, reproduced) turns on the sign
    of a 1e-16 residue."""
    ks = np.linspace(-np.pi, np.pi, 101, endpoint=False)
    fb = tfloquet.FloquetBloch(lambda k, E: None, 1.0, 1, 2, **CPU)
    for (t1, t2, sign) in [(1.0, 0.5, 1.0), (0.5, 1.0, -1.0)]:
        h01 = t1 + t2 * np.exp(-1j * ks)
        Hk = np.zeros((101, 2, 2), complex)
        Hk[:, 0, 1], Hk[:, 1, 0] = h01, h01.conj()
        lower = torch.linalg.eigh(torch.as_tensor(Hk))[1][:, :, 0]
        w = fb.winding_number(0, states=[lower])
        assert abs(np.exp(1j * np.pi * w) - sign) < 1e-8


def test_free_electron_matches_jax(refs):
    ref, _ = refs
    got = tfloquet.light_driven_free_electron(tf=8.0, nt=200, E0=0.8,
                                              omega=1.3, cep=0.4, omega0=0.2,
                                              **CPU)
    _compare(got, ref["free"], RTOL)
    got = tfloquet.cep_scan([0.0, 0.7], tf=5.0, nt=100,
                            polarization="linear", **CPU)
    _compare(got, ref["cep"], RTOL)


def test_root_exports():
    for name in ("SESolver", "tdse", "Cavity", "Composite", "Polariton", "QRM",
                 "HEOMSolverDrude", "Pulse", "GaussianPulse", "ChirpedPulse",
                 "Biphoton", "intensity_to_field", "Analyser",
                 "schmidt_decompose", "schmidt_number", "hom_schmidt",
                 "field_to_intensity", "fwhm_to_std", "std_to_fwhm",
                 "quantum_dynamics", "driven_dynamics", "floquet"):
        assert hasattr(pt, name), name
    assert pt.floquet.Floquet is tfloquet.Floquet

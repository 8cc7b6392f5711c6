"""Parity of the PyTorch port's beam layer with the JAX package, on the CPU
at complex128: the fields and propagators of beam/beam.py (angular
spectrum, Rayleigh-Sommerfeld, BPM, WPM, PWD, inverse BPM, vector fields),
its sources and field masks, beam/fieldutils.py, beam/vector.py,
beam/zoom.py and beam/photonic.py.

Every case is one function of a package namespace ``P`` (the JAX package
or the port, with the port on ``device="cpu"``), run on the same NumPy
inputs from a seed. The JAX outputs of all cases are computed once, in
the module fixture ``jref``. Tolerances (max abs difference over the
reference's max abs): propagation, vector optics, zoom transforms and
photonics 1e-10; sources, masks and field analysis 1e-12; the float
outputs of the host analyses (edges, point clouds, MTF) exactly.
"""
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyqed_tpu.beam as jbeam
from pyqed_tpu.beam import beam as jbeam_mod
from pyqed_tpu.beam import fieldutils as jfu
from pyqed_tpu.beam import photonic as jph
from pyqed_tpu.beam import vector as jvec
from pyqed_tpu.beam import zoom as jzoom

import pyqed_tpu_torch.beam as tbeam
from pyqed_tpu_torch.beam import beam as tbeam_mod
from pyqed_tpu_torch.beam import fieldutils as tfu
from pyqed_tpu_torch.beam import photonic as tph
from pyqed_tpu_torch.beam import vector as tvec
from pyqed_tpu_torch.beam import zoom as tzoom

PROP, MASK = 1e-10, 1e-12
WL = 0.6328
RNG = np.random.default_rng(7)
X = np.linspace(-40.0, 40.0, 64)
Y = np.linspace(-36.5, 43.5, 64)
X1 = np.linspace(-60.0, 60.0, 96)
ZS = np.linspace(2.0, 64.0, 16)
ZNU = np.cumsum(RNG.uniform(1.0, 3.0, 16))      # non-uniform planes
ENV = np.exp(-(X[:, None] ** 2 + Y[None, :] ** 2) / 15.0 ** 2)
U2 = (RNG.standard_normal((64, 64)) + 1j * RNG.standard_normal((64, 64))) \
    * ENV + ENV
U1 = (RNG.standard_normal(96) + 1j * RNG.standard_normal(96)) \
    * np.exp(-X1 ** 2 / 20.0 ** 2) + np.exp(-X1 ** 2 / 12.0 ** 2)
EX = U2 * 0.7
EY = np.roll(U2, 3, axis=0) * (0.3 - 0.4j)
# index scenes: a two-level disc (XZ) and a two-level ball (XYZ), each
# with a weak random ripple on a second sheet for the BPM
DISC = (1.0 + 0.5 * ((X1[None, :] / 20.0) ** 2
                     + ((ZS[:, None] - 30.0) / 18.0) ** 2 < 1))
RIPPLE = DISC + 0.01 * RNG.standard_normal(DISC.shape)
BALL = (1.0 + 0.45 * ((X[None, :, None] / 18.0) ** 2
                      + (Y[None, None, :] / 16.0) ** 2
                      + ((ZS[:, None, None] - 30.0) / 20.0) ** 2 < 1))
ABSORB = BALL + 0.002j * (BALL > 1.2)


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def rel(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def flat(out):
    """The arrays of a (nested) tuple/list output, in order."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in flat(o)]
    return [out]


J = types.SimpleNamespace(name="jax", beam=jbeam, mod=jbeam_mod, fu=jfu,
                          ph=jph, vec=jvec, zoom=jzoom, kw={},
                          arr=jnp.asarray)
T = types.SimpleNamespace(name="torch", beam=tbeam, mod=tbeam_mod, fu=tfu,
                          ph=tph, vec=tvec, zoom=tzoom,
                          kw={"device": "cpu"},
                          arr=lambda a: torch.as_tensor(np.array(a)))


def fx(P, u=U1):
    return P.beam.ScalarFieldX(X1, WL, u=u, **P.kw)


def fxy(P, u=U2, n=1.0):
    return P.beam.ScalarFieldXY(X, Y, WL, u=u, n_background=n, **P.kw)


def fxz(P, z=ZS, u=U1, wl=WL):
    f = P.beam.ScalarFieldXZ(X1, z, wl, **P.kw)
    return f.incident_field(u)


def fxyz(P, z=ZS, n=1.0):
    f = P.beam.ScalarFieldXYZ(X, Y, z, WL, n_background=n, **P.kw)
    return f.incident_field(U2)


def _rs_x(P):
    out = []
    for z, fast, kind in ((30.0, False, "z"), (30.0, True, "z"),
                          (45.0, False, "x"), (-20.0, False, "z")):
        f = fx(P).RS(z, fast=fast, kind=kind)
        out += [f.u, np.asarray(f.quality)]
    return out


def _rs_xy(P):
    out = []
    for z, kind in ((50.0, "z"), (35.0, "0"), (-25.0, "x")):
        f = fxy(P).RS(z, kind=kind)
        out += [f.u, np.asarray(f.quality)]
    return out


def _vector_xy(P):
    f = P.beam.VectorFieldXY(X, Y, WL, **P.kw).incident_field(EX, EY)
    out = [f.Ez]
    f.propagate(30.0)
    out += [f.Ex, f.Ey, f.Ez, *f.stokes(), f.intensity()]
    g = P.beam.VectorFieldXY(X, Y, WL, **P.kw).incident_field(EX, EY)
    g.vrs(40.0)
    out += [g.Ex, g.Ey, g.Ez]
    h = P.beam.VectorFieldXY(X, Y, WL, **P.kw).incident_field(EX, EY)
    h.vfft(radius=30.0, focal=60.0)
    out += [h.Ex, h.Ey, h.Ez]
    h.ivfft(radius=30.0, focal=60.0)
    return out + [h.Ex, h.Ey, h.Ez]


def _vector_xyz(P):
    f = P.beam.VectorFieldXYZ(X, Y, ZS, WL, **P.kw).incident_field(EX, EY)
    f.propagate()
    v = f.to_xy(33.0)
    return [f.Ex, f.Ey, f.Ez, *f.on_axis(1.0, -2.0), *f.stokes(),
            f.intensity(), v.Ez]


def _xz_inverse(P):
    f = fxz(P, u=fxz(P).bpm(n_xz=RIPPLE)[-1])
    inv = f.bpm_inverse(n_xz=RIPPLE)
    g = fxz(P, u=inv[0])
    return [inv, g.bpm_back_propagation(n_xz=RIPPLE, has_edges=False)]


def _xyz_views(P):
    f = fxyz(P)
    f.bpm(n_volume=BALL)
    return [f.to_xy(30.0), f.to_xz(2.0), f.to_yz(-3.0), f.on_axis(1.0, 1.0),
            f.average_intensity(), *f.beam_widths(), f.intensity()]


PROPAGATION = {
    "x_angular_spectrum": lambda P: fx(P).angular_spectrum(25.0).u,
    "x_evanescent": lambda P: P.beam.ScalarFieldX(
        X1, 30.0, u=U1, **P.kw).angular_spectrum(5.0).u,
    "x_rs": _rs_x,
    "x_propagate_many": lambda P: fx(P).propagate_many(ZS),
    "x_fft_normalize": lambda P: (fx(P).fft(), fx(P).normalize().u,
                                  (fx(P) + fx(P, u=U1[::-1])).u,
                                  (fx(P) * fx(P, u=U1[::-1])).u),
    "xy_angular_spectrum": lambda P: fxy(P, n=1.33).angular_spectrum(40.0).u,
    "xy_rs": _rs_xy,
    "xy_propagate_many": lambda P: fxy(P).propagate_many(ZS),
    "xz_propagate": lambda P: fxz(P).propagate(),
    "xz_bpm": lambda P: fxz(P).bpm(n_xz=RIPPLE),
    "xz_bpm_nonuniform_no_edges": lambda P: fxz(P, z=ZNU).bpm(
        n_xz=RIPPLE, has_edges=False),
    "xz_bpm_uniform_background": lambda P: fxz(P).bpm(pow_edge=40),
    "xz_wpm": lambda P: fxz(P).wpm(n_xz=DISC),
    "xz_wpm_levels_nonuniform": lambda P: fxz(P, z=ZNU).wpm(
        n_xz=RIPPLE, levels=[1.0, 1.25, 1.5], has_edges=False),
    "xz_pwd": lambda P: (fxz(P).pwd(), fxz(P, z=ZNU).pwd(n=1.2)),
    "xz_inverse_and_back_propagation": _xz_inverse,
    "xz_polychromatic": lambda P: fxz(P).polychromatic(
        lambda wl: U1 * (wl / WL), [0.55, 0.6328, 0.7], [0.2, 1.0, 0.5],
        method="wpm", n_xz=DISC),
    "xyz_propagate": lambda P: fxyz(P).propagate(),
    "xyz_bpm": lambda P: fxyz(P).bpm(n_volume=BALL),
    "xyz_bpm_nonuniform_absorbing": lambda P: fxyz(P, z=ZNU).bpm(
        n_volume=ABSORB, has_edges=False),
    "xyz_wpm": lambda P: fxyz(P).wpm(n_volume=BALL),
    "xyz_wpm_absorbing_nonuniform": lambda P: fxyz(P, z=ZNU).wpm(
        n_volume=ABSORB),
    "xyz_wpm_uniform_scene": lambda P: fxyz(P, n=1.1).wpm(has_edges=False),
    "xyz_pwd": lambda P: (fxyz(P).pwd(), fxyz(P).pwd(n=1.45)),
    "xyz_views": _xyz_views,
    "vector_xy": _vector_xy,
    "vector_xyz": _vector_xyz,
}


def _sources(P):
    out = []
    for make in (lambda f: P.mod.plane_wave(f, 0.02, 1.5),
                 lambda f: P.mod.gauss_beam(f, 9.0, 1.0, -2.0, 2.0)):
        out += [make(fx(P)).u, make(fxy(P)).u]
    f = fxy(P)
    out += [P.mod.laguerre_gauss_beam(f, 10.0, l=2, p=1, x0=1.0).u,
            P.mod.spherical_wave(f, 300.0, 1.0, 2.0).u,
            P.mod.hermite_gauss_beam(f, 12.0, 2, 1).u,
            P.mod.bessel_beam(f, 0.3, l=1).u,
            P.mod.vortex_beam(f, 11.0, l=-1).u,
            P.mod.plane_waves_several_inclined(f, [-0.01, 0.0, 0.02]).u]
    return out


def _field_masks(P):
    m = P.mod
    makes = [lambda f: m.slit(f, 12.0, 1.1),
             lambda f: m.double_slit(f, 5.0, 20.0, -1.3),
             lambda f: m.circular_aperture(f, 21.0, 1.0, -2.0),
             lambda f: m.lens(f, 500.0),
             lambda f: m.square(f, 23.0, 1.3, 0.7),
             lambda f: m.ring(f, 9.3, 27.1, 0.3, -0.2),
             lambda f: m.cross(f, 7.7, 41.0),
             lambda f: m.super_gauss(f, 20.0, 6, 1.0, 0.5),
             lambda f: m.prism(f, 0.01, -0.02),
             lambda f: m.axicon(f, 0.03),
             lambda f: m.fresnel_lens(f, 400.0, levels=4),
             lambda f: m.sine_grating(f, 7.1, x0=0.3),
             lambda f: m.ronchi_grating(f, 6.3, x0=0.17),
             lambda f: m.binary_grating(f, 5.3, 0.2, 0.9, 1.0, 0.4),
             lambda f: m.blazed_grating(f, 9.1),
             lambda f: m.forked_grating(f, 6.7, l=2)]
    out = [mk(fxy(P)).u for mk in makes]
    out += [m.slit(fx(P), 12.0, 1.1).u, m.double_slit(fx(P), 5, 20).u]
    return out


def _mtf(P):
    mtf, fc = P.mod.mtf_ideal(np.linspace(-900, 900, 31), WL, 10.0, 40.0)
    m1, fc1 = P.mod.mtf_ideal(np.linspace(0, 900, 31), WL, 10.0, 40.0, "1D")
    return [mtf, np.asarray(fc), m1, np.asarray(fc1), *fx(P).MTF(),
            *fxy(P).MTF()]


def _fieldutils(P):
    fu = P.fu
    u = P.arr(U2)
    binary = P.arr(np.where(np.abs(U2) > 0.8, 1.0, 0.2) * np.exp(
        1j * np.angle(U2)))
    return [fu.get_amplitude(u), fu.get_phase(u),
            fu.get_phase(u, keep_amplitude=True), fu.remove_phase(u),
            fu.remove_phase(u, sign=True), fu.binarize(u),
            fu.binarize(u, "phase", 0.3, -1.0, 2.0),
            fu.discretize(u, num_levels=5),
            fu.discretize(u, "phase", num_levels=4, phase0=-1.0),
            *fu.search_focus(X, Y, u), *fu.search_focus(X, Y, u, "moments"),
            *fu.profile(X, Y, u, (-30.0, -20.0), (25.0, 31.0)),
            fu.profile(X, Y, u, (-50.0, 0.0), (50.0, 10.0), 77, "field")[1],
            fu.profile(X, Y, u, (-5.0, 2.0), (9.0, 4.0), 40, "phase")[1],
            fu.rotate_field(X, Y, u, 0.37), fu.rotate_field(
                X, Y, u, -1.1, position=(3.0, -4.0)),
            fu.insert_array(X, Y, u, P.arr(U2[:20, :17]), X[:20], Y[:17],
                            (3.0, -5.0)),
            fu.insert_array(X, Y, u, P.arr(U2[:20, :17]), X[:20], Y[:17],
                            (70.0, 9.0)),
            fu.rotate_image(X, Y, P.arr(np.abs(U2)), 23.0, (1.0, -2.0)),
            *fu.get_edges(X, binary[:, 30]),
            *fu.get_edges(X, binary[:, 30], "phase", 0.5),
            *fu.detect_index_variations(X1, ZS, RIPPLE.T, 1.2),
            *fu.surface_detection(X1, ZS, RIPPLE.T, 1, 0.05),
            *fu.surface_detection(X1, ZS, RIPPLE.T, 2, 0.2),
            fu.filter_edge_1D(X, 1.05, 31), fu.filter_edge_2D(X, Y)]


def _field_methods(P):
    f = fxy(P)
    g = P.beam.ScalarFieldXY(X[10:30], Y[5:25], WL, u=U2[:20, :20], **P.kw)
    out = [f.get_amplitude(), f.get_phase(), *f.search_focus(),
           *f.profile((-10.0, 0.0), (10.0, 3.0), 33),
           fxy(P).rotate(0.4).u, fxy(P).insert_mask(g, (2.0, 1.0)).u,
           fxy(P).remove_phase().u, fxy(P).binarize().u,
           fxy(P).discretize("phase", 3).u, fx(P).binarize().u,
           fx(P).discretize(num_levels=4).u, *fx(P).get_edges()]
    h = fxz(P)
    h.bpm(n_xz=RIPPLE)
    prof = h.profile_longitudinal("field", x0=2.0)
    return out + [h.profile_longitudinal(x0=2.0),
                  h.profile_longitudinal("phase"), prof.u,
                  np.asarray(prof.FWHM1D()),
                  h.profile_transversal("field", z0=31.0),
                  h.profile_transversal("amplitude"),
                  *h.surface_detection(RIPPLE, 2, 0.2),
                  *h.detect_index_variations(RIPPLE, 1.2)]


ANALYSIS = {"sources": _sources, "field_masks": _field_masks, "mtf": _mtf,
            "fieldutils": _fieldutils, "field_methods": _field_methods}


def _jones(P):
    v = P.vec
    az = np.add.outer(X, Y) / 50.0
    return [v.polarizer_linear(0.3), v.retarder(0.7, 0.2, 0.9, 0.8),
            v.quarter_waveplate(0.1), v.half_waveplate(az),
            v.jones_rotated(np.array([[1.0, 0.2j], [0.0, 0.5]]), az)]


def _vector_masks(P):
    v = P.vec
    E = P.beam.VectorFieldXY(X, Y, WL, **P.kw).incident_field(EX, EY)
    scal = P.beam.ScalarFieldXY(X, Y, WL, u=U2, **P.kw)
    masks = [lambda m: m.polarizer_linear(0.4),
             lambda m: m.quarter_waveplate(-0.3),
             lambda m: m.half_waveplate(0.2),
             lambda m: m.polarizer_retarder(0.8, 0.9, 0.7, 0.1),
             lambda m: m.q_plate(2, 0.1),
             lambda m: m.q_plate(1).apply_scalar_mask(scal),
             lambda m: m.half_waveplate(0.3).apply_circle((1.0, 2.0), 25.0),
             lambda m: m.quarter_waveplate().pupil((0.5, 0.0), (30.0, 20.0),
                                                   0.3),
             lambda m: m.complementary_masks(
                 scal, v.half_waveplate(0.1), v.polarizer_linear(0.5)),
             lambda m: m.multilevel_mask(
                 scal, [v.polarizer_linear(a) for a in (0.0, 0.5, 1.0)]),
             lambda m: m.multilevel_mask(
                 P.arr(np.abs(U2) / np.abs(U2).max()),
                 [v.half_waveplate(a) for a in (0.0, 0.7)], False)]
    out = []
    for mk in masks:
        m = mk(v.VectorMaskXY(X, Y, WL, **P.kw))
        out.append(m.M)
        r = m * E
        out += [r.Ex, r.Ey, r.Ez]
    return out


def _vector_sources(P):
    s = lambda: P.vec.VectorSourceXY(X, Y, WL, **P.kw)  # noqa: E731
    scal = P.beam.ScalarFieldXY(X, Y, WL, u=U2, **P.kw)
    fields = [s().constant_wave(U2, (1.0, 1j), normalize=True),
              s().constant_wave(2.0 + 1j),
              s().radial_wave(scal, (1.0, -1.0)), s().azimuthal_wave(U2),
              s().radial_inverse_wave(U2), s().azimuthal_inverse_wave(U2),
              s().spiral_polarized_beam(U2, alpha=0.3),
              s().local_polarized_vector_wave(U2, m=2, fi0=0.1),
              s().local_polarized_vector_wave_radial(U2, m=1.5),
              s().local_polarized_vector_wave_hybrid(U2, m=1, n=2),
              s().radial_wave(U2).mask_circle((1.0, 0.0), 20.0)]
    out = []
    for f in fields:
        out += [f.Ex, f.Ey, f.Ez]
    e = P.beam.VectorFieldXY(X, Y, WL, **P.kw).incident_field(EX, EY)
    return out + [*P.vec.polarization_states(fields[1]),
                  *P.vec.polarization_ellipse(e)]


def _zoom(P):
    z = P.zoom
    u1 = P.arr(U1)
    n = len(U1)
    fo = np.linspace(-0.05, 0.07, 41)
    out = [z.czt(u1, n, np.exp(-2j * np.pi / n)),
           z.czt(P.arr(U2), 50, np.exp(-2j * np.pi / 90), 1.02 + 0.01j,
                 axis=0),
           z.zoom_dft(u1, X1, fo), z.zoom_dft(P.arr(U2), Y, fo[:30], axis=1),
           z.zoom_dft2(P.arr(U2), X, Y, fo, fo[5:35]),
           z.fraunhofer_zoom(P.arr(U2), X, Y, WL, 5000.0,
                             np.linspace(-40, 40, 33),
                             np.linspace(-20, 30, 27))]
    return out


R1 = RNG.uniform(-1, 1, (7, 3)) + np.array([0, 0, 2.0])
R2 = RNG.uniform(-1, 1, (7, 3)) + np.array([0, 0, 1.0])
BRAGG_N = [1.5, 2.3] * 6 + [1.5]
BRAGG_L = [0.25 / 1.5, 0.25 / 2.3] * 6 + [0.25 / 1.5]
OMEGAS = np.linspace(3.0, 9.0, 301)


def _photonic(P):
    ph = P.ph
    kw = P.kw
    rz = np.linspace(0.0, 3.0, 40)
    eps = 1.0 + 2.0 * ((rz > 1.0) & (rz < 2.0)) + 0.1j * (rz > 1.5)
    w = 2 * np.pi + 0.3j
    out = [ph.propagation(w, 1.7, 0.3, **kw), ph.interface(1.0, 1.5, **kw),
           ph.transfer_matrix(w, BRAGG_N, BRAGG_L, 1.0, 1.45, **kw),
           *ph.rt_coefficients(5.2, BRAGG_N, BRAGG_L, **kw),
           ph.transmittance_spectrum(OMEGAS, BRAGG_N, BRAGG_L, 1.0, 1.45,
                                     **kw),
           ph.quasinormal_modes([2.0, 3.0], [0.7, 0.5], [3.5, 5.5, 7.0],
                                **kw),
           ph.helmholtz_g0(P.arr(rz), P.arr(rz[::-1]), 2.3)]
    ml = ph.Multilayer(rz, P.arr(eps), **kw)
    out += [ml.G(2.1), ml.ldos(2.1)]
    out += [ph.dyadic_G0(R1, R2, 0.8, **kw),
            ph.dyadic_G0(R1, R2, 0.8, 2.25, **kw),
            ph.dyadic_Gs_interface(R1, R2, 0.8, 1.0, 2.25, **kw),
            ph.dyadic_Gs_slab(R1, R2, 0.8, 2.0, 1.0, 3.0, 2.5, **kw),
            ph.dyadic_Gs_slab(R1, R2, 0.8, 2.0, 1.0, 3.0, 2.5, True, **kw),
            ph.dyadic_G_slab(R1, R2, 0.8, 2.0, 1.0, 3.0, 2.5, **kw)]
    gs = ph.dyadic_Gs_interface(R1[0], R2[0], 0.8, 1.0, 2.25, **kw)
    out.append(np.asarray(ph.purcell_factor(gs, 0.8)))
    ch = ph.ChiralMultilayer(rz, P.arr(eps), P.arr(0.05 * (rz > 1.0)),
                             mu=1.0, **kw)
    return out + [ch.green0(1.7), ch.green(1.7), ch.G(1.1), ch.n,
                  np.asarray(ch.optical_rotation(1.7))]


OPTICS = {"jones": _jones, "vector_masks": _vector_masks,
          "vector_sources": _vector_sources, "zoom": _zoom,
          "photonic": _photonic}
CASES = {**{k: (f, PROP) for k, f in PROPAGATION.items()},
         **{k: (f, MASK) for k, f in ANALYSIS.items()},
         **{k: (f, PROP) for k, f in OPTICS.items()}}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jref():
    """Every case's JAX outputs, as NumPy arrays."""
    out = {}
    for name, (fn, _) in CASES.items():
        out[name] = [host(a) for a in flat(fn(J))]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_jax(jref, name):
    fn, tol = CASES[name]
    got = flat(fn(T))
    ref = jref[name]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        err = rel(a, b)
        assert err <= tol, (name, i, err)


def test_wpm_level_gather_equals_jax_one_hot_sum():
    """The port's per-pixel level gather against JAX's one-hot partition
    summed over levels, on the same propagated levels: equal bit for
    bit."""
    scene = np.asarray(ABSORB[7])
    levels = tbeam_mod._wpm_levels(torch.as_tensor(ABSORB), None, "cpu")
    jlv = jbeam_mod._wpm_levels(np.asarray(ABSORB, dtype=complex), None)
    assert np.array_equal(levels, jlv)
    um = RNG.standard_normal((len(levels), 64, 64)) + 0j
    onehot = jbeam_mod._wpm_partition(scene[None], jlv)[0]
    summed = np.asarray(jnp.sum(jnp.asarray(onehot, dtype=jnp.float64)
                                * jnp.asarray(um), axis=0))
    idx = tbeam_mod._level_index(torch.as_tensor(scene),
                                 torch.as_tensor(levels))
    got = torch.gather(torch.as_tensor(um), 0, idx[None])[0].numpy()
    assert np.array_equal(got, summed)


def test_wpm_warns_above_32_levels():
    scene = torch.as_tensor(1.0 + np.arange(40.0)[:, None] / 100 * np.ones(
        (1, 8)))
    with pytest.warns(RuntimeWarning, match="40 distinct index levels"):
        tbeam_mod._wpm_levels(scene, None, "cpu")


def test_entry_points_default_to_the_card():
    """Without a card, every field class and entry point raises for
    device=None instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: tbeam.ScalarFieldXY(X, Y, WL),
                 lambda: tbeam.ScalarFieldXYZ(X, Y, ZS, WL),
                 lambda: tbeam.VectorFieldXYZ(X, Y, ZS, WL),
                 lambda: tbeam.transmittance_spectrum(OMEGAS, [1.5], [0.2]),
                 lambda: tbeam.masks.lens(X[:, None], Y[None, :], WL, 9.0),
                 lambda: tbeam.scenes.sphere_xyz(1.0, X, Y, ZS, (0, 0, 0),
                                                 5.0, 1.5)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()

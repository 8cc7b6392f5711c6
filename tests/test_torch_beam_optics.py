"""Parity of the PyTorch port's beam masks, scenes, host analysis and
drawing with the JAX package, on the CPU: beam/masks.py, beam/masks_x.py,
beam/scenes.py (the rough masks and ``rough_sheet`` fed the JAX package's
own ``jax.random`` draws), beam/optics.py, beam/fieldz.py and
beam/drawing.py.

Every case is one function of a package namespace ``P`` (the JAX package
or the port, whose grids are CPU tensors), run on the same NumPy inputs.
The JAX outputs of all cases are computed once, in the module fixture
``jref``. Tolerances (max abs difference over the reference's max abs):
masks, sources and scenes 1e-12; the host analyses of optics/fieldz and
the drawing transforms 1e-12 (the same NumPy code on the same arrays).
A threshold mask can flip a pixel that lies within an ulp of its
threshold where two libraries' sin/atan2 round apart, so the grids are
offset from the masks' symmetry lines. Each drawing is saved once under
``tmp_path`` with the Agg backend.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.beam import beam as jbeam
from pyqed_tpu.beam import drawing as jdraw
from pyqed_tpu.beam import fieldz as jfz
from pyqed_tpu.beam import masks as jmk
from pyqed_tpu.beam import masks_x as jmx
from pyqed_tpu.beam import optics as jop
from pyqed_tpu.beam import scenes as jsc

import pyqed_tpu_torch.beam as tb
from pyqed_tpu_torch.beam import beam as tbeam
from pyqed_tpu_torch.beam import drawing as tdraw
from pyqed_tpu_torch.beam import fieldz as tfz
from pyqed_tpu_torch.beam import masks as tmk
from pyqed_tpu_torch.beam import masks_x as tmx
from pyqed_tpu_torch.beam import optics as top
from pyqed_tpu_torch.beam import scenes as tsc

TOL = 1e-12
WL = 0.6328
RNG = np.random.default_rng(5)
X = np.linspace(-40.0, 40.0, 64) + 0.0137
Y = np.linspace(-36.0, 44.0, 60) - 0.0211
XL = np.linspace(-60.0, 60.0, 128) + 0.0091
ZL = np.linspace(0.0, 90.0, 48) + 0.0173
Z3 = np.linspace(0.0, 60.0, 20) + 0.011
U = (RNG.standard_normal((64, 60)) + 1j * RNG.standard_normal((64, 60)))
KEY = jax.random.PRNGKey(3)


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def rel(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    if a.dtype == bool or b.dtype == bool:
        return float(np.sum(a != b))
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def flat(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in flat(o)]
    return [out]


J = types.SimpleNamespace(name="jax", mk=jmk, mx=jmx, sc=jsc, op=jop,
                          fz=jfz, draw=jdraw, beam=jbeam, kw={},
                          arr=jnp.asarray,
                          grid=lambda a, b: jnp.meshgrid(
                              jnp.asarray(a), jnp.asarray(b), indexing="ij"))
T = types.SimpleNamespace(name="torch", mk=tmk, mx=tmx, sc=tsc, op=top,
                          fz=tfz, draw=tdraw, beam=tbeam,
                          kw={"device": "cpu"},
                          arr=lambda a: torch.as_tensor(np.array(a)),
                          grid=lambda a, b: torch.meshgrid(
                              torch.as_tensor(a), torch.as_tensor(b),
                              indexing="ij"))


def jax_draws():
    """The normals and uniforms JAX's rough masks draw from ``KEY``."""
    shape = (64, 60)
    d = {"surface": jax.random.normal(KEY, shape),
         "circle": jax.random.normal(KEY, shape),
         "ring": tuple(jax.random.normal(k, shape)
                       for k in jax.random.split(KEY)),
         "line": jax.random.normal(KEY, (len(XL),))}
    keys = jax.random.split(KEY, 5 + 2)         # num_rings = 5 below
    fl = [jax.random.normal(keys[0], shape)]
    for j, _ in enumerate(range(3, 5 + 2, 2)):
        fl.append(tuple(jax.random.normal(k, shape)
                        for k in jax.random.split(keys[j + 1])))
    d["fresnel"] = fl
    kp, ks = jax.random.split(KEY)
    num = int(0.3 * (XL[-1] - XL[0]) / 4.0)
    d["dust"] = (jax.random.uniform(kp, (num,)), jax.random.normal(ks, (num,)))
    return {k: jax.tree_util.tree_map(np.asarray, v) for k, v in d.items()}


DRAWS = jax_draws()


def _rough(P):
    mk, mx = P.mk, P.mx
    Xg, Yg = P.grid(X, Y)
    if P.name == "jax":
        return [mk.roughness_surface(X, Y, (3.0, 5.0), 0.4, KEY),
                mk.circle_rough(Xg, Yg, (1.0, 2.0), 20.0, 1.5, KEY),
                mk.ring_rough(Xg, Yg, (0.0, 0.0), 10.0, 25.0, 1.0, KEY),
                mk.fresnel_lens_rough(Xg, Yg, WL, (0.0, 0.0), 20.0, 126.0,
                                      0.5, KEY),
                mx.roughness(XL, 4.0, 0.3, KEY),
                *mx.dust(XL, 0.3, 4.0, KEY, std=1.0),
                *mx.dust_different_sizes(XL, 0.3, 4.0, KEY)]
    xl = torch.as_tensor(XL)
    return [mk.roughness_surface(X, Y, (3.0, 5.0), 0.4,
                                 noise=DRAWS["surface"], device="cpu"),
            mk.circle_rough(Xg, Yg, (1.0, 2.0), 20.0, 1.5,
                            normals=DRAWS["circle"]),
            mk.ring_rough(Xg, Yg, (0.0, 0.0), 10.0, 25.0, 1.0,
                          normals=DRAWS["ring"]),
            mk.fresnel_lens_rough(Xg, Yg, WL, (0.0, 0.0), 20.0, 126.0, 0.5,
                                  normals=DRAWS["fresnel"]),
            mx.roughness(xl, 4.0, 0.3, noise=DRAWS["line"]),
            *mx.dust(xl, 0.3, 4.0, std=1.0, uniforms=DRAWS["dust"][0],
                     normals=DRAWS["dust"][1]),
            *mx.dust_different_sizes(xl, 0.3, 4.0,
                                     uniforms=DRAWS["dust"][0],
                                     normals=DRAWS["dust"][1])]


def _masks_amplitude(P):
    m = P.mk
    Xg, Yg = P.grid(X, Y)
    return [m.slit(Xg, Yg, 1.0, 10.0, 0.2),
            m.double_slit(Xg, Yg, 0.5, 4.0, 15.0),
            m.square(Xg, Yg, (1.0, -2.0), (20.0, 11.0), 0.3),
            m.circle(Xg, Yg, (1.0, -2.0), (20.0, 13.0)),
            m.ring(Xg, Yg, (0.5, 0.5), 8.0, 22.0),
            m.cross(Xg, Yg, (0.0, 1.0), 30.0, 0.25),
            m.super_gauss(Xg, Yg, (1.0, 0.0), 18.0, 3),
            m.gray_scale(Xg, Yg, 5), m.gray_scale(Xg, Yg, 4, -20.0, 25.0),
            m.triangle(Xg, Yg, (0.0, 20.0), 1.5, 30.0, 0.1),
            m.super_ellipse(Xg, Yg, (0.0, 1.0), (20.0, 12.0), (3, 5), 0.2),
            m.square_circle(Xg, Yg, (0.0, 0.0), 20.0, 15.0, 0.7, 0.1),
            m.angular_aperture(Xg, Yg, [[0, 3], [20.0, 5.0]],
                               [[2], [3.0]], 0.1),
            m.rings(Xg, Yg, (0.0, 0.0), [3.0, 12.0, 25.0], [7.0, 18.0, 30.0]),
            m.edge_series(Xg, Yg, (2.0, 1.0), 30.0, [[1, 2], [3.0, 1.5]],
                          [[1], [2.0]], 0.1),
            m.slit_series(Xg, Yg, 0.0, 12.0, 25.0, 31.0, (1.0, -1.0),
                          [[1], [2.0]], [[2], [1.5]]),
            m.sinusoidal_slit(Xg, Yg, 14.0, 1.0, (2.0, 3.0), 0.4,
                              (20.0, 17.0), 0.1),
            m.crossed_slits(Xg, Yg, (1.0, -1.0), (0.5, -0.7), 0.2),
            m.crossed_slits(Xg, Yg, 0.0, 0.6),
            m.one_level(Xg, Yg, 0.4),
            m.two_levels(Xg, Yg, 0.2, 0.9, 3.0, 0.3),
            m.grating_2D(Xg, Yg, (8.0, 11.0), 0.4, (1.0, 0.5), 0.1, 0.9,
                         0.7, 0.05),
            m.grating_2D_chess(Xg, Yg, 9.0, 0.5, (0.3, 0.2), 0.2, 1.0, 1.1),
            m.axicon_binary(Xg, Yg, (0.0, 1.0), 30.0, 6.5),
            m.hammer(Xg, Yg, (1.0, 2.0), (30.0, 20.0), 4.0, 0.2)]


def _masks_phase(P):
    m = P.mk
    Xg, Yg = P.grid(X, Y)
    return [m.lens(Xg, Yg, WL, 400.0, (1.0, 0.0), 25.0),
            m.lens(Xg, Yg, WL, (300.0, 500.0)),
            m.fresnel_lens(Xg, Yg, WL, 300.0, (0.5, 0.5), 30.0),
            m.fresnel_lens(Xg, Yg, WL, 300.0, kind="amplitude"),
            m.axicon(Xg, Yg, WL, 0.02, 1.5, (0.0, 1.0), 30.0),
            m.sine_grating(Xg, Yg, 7.0, 0.5, 0.2, 0.9, 0.3),
            m.binary_grating(Xg, Yg, 6.0, 0.3, 0.4, 0.1),
            m.binary_grating(Xg, Yg, 6.0, 0.3, 0.4, kind="phase", phase=2.0),
            m.blazed_grating(Xg, Yg, 9.0, WL, 0.2),
            m.radial_grating(Xg, Yg, 7.0, (1.0, 0.0)),
            m.radial_grating(Xg, Yg, 7.0, binary=False),
            m.angular_grating(Xg, Yg, 6, (0.5, 0.5)),
            m.forked_grating(Xg, Yg, 6.0, 2, (0.2, 0.1)),
            m.forked_grating(Xg, Yg, 6.0, 1, kind="phase", angle=0.2),
            m.spiral_phase_plate(Xg, Yg, 3, (1.0, 1.0)),
            m.laguerre_gauss_spiral(Xg, Yg, WL, 10.0, 2, 500.0),
            m.laguerre_gauss_spiral(Xg, Yg, WL, 10.0, 1, 400.0,
                                    kind="phase"),
            m.lens_spherical(Xg, Yg, WL, (0.0, 1.0), 30.0, 100.0),
            m.aspheric(Xg, Yg, WL, (1.0, 0.0), 0.01, -0.5, [1e-7, -2e-10],
                       1.0, 1.5, 35.0),
            m.elliptical_phase(Xg, Yg, WL, 300.0, 450.0, 0.3),
            m.biprism_fresnel(Xg, Yg, WL, (1.0, 0.0), 30.0, 2.0),
            m.hyperbolic_grating(Xg, Yg, (0.0, 0.0), 5.0, 30.0, True, 0.2),
            m.archimedes_spiral(Xg, Yg, (0.0, 0.0), 9.0, 0.3, 1.0, 35.0),
            m.sine_edge_grating(Xg, Yg, (0.0, 0.0), 6.0, 20.0, 1.5, 0.3,
                                35.0),
            m.hermite_gauss_binary(Xg, Yg, (1.0, 0.0), (12.0, 9.0), 2, 1),
            m.laguerre_gauss_binary(Xg, Yg, (0.0, 1.0), 12.0, 2, 1),
            m.prism(Xg, Yg, WL, (1.0, 0.0), 0.01, 0.3),
            m.ronchi_grating(Xg, Yg, 7.3, 0.21, 0.35, 0.1),
            m.mask_from_function(Xg, Yg, WL, (0.0, 0.0), 1.5,
                                 lambda a, b: 0.001 * a * a,
                                 lambda a, b: 0.002 * b * b + 1.0, 30.0)]


def _sources(P):
    m = P.mk
    Xg, Yg = P.grid(X, Y)
    return [m.plane_wave(Xg, Yg, WL, 0.02, 0.3, 1.5, 2.0),
            m.gauss_beam(Xg, Yg, WL, (10.0, 12.0), (1.0, 2.0), 300.0, 1.2,
                         0.01, 0.2),
            m.gauss_beam(Xg, Yg, WL, 11.0),
            m.spherical_wave(Xg, Yg, WL, (1.0, 0.0), -300.0, 2.0, 30.0,
                             True),
            m.vortex_beam(Xg, Yg, WL, 12.0, 2, (0.5, 0.0)),
            m.hermite_gauss_beam(Xg, Yg, WL, 13.0, 2, 3, (1.0, 0.0)),
            m.laguerre_beam(Xg, Yg, WL, 12.0, 1, 2, 3.0),
            m.bessel_beam(Xg, Yg, WL, 0.03, 1, (0.0, 1.0)),
            m.zernike_beam(Xg, Yg, 35.0, [(2, 0, 0.2), (3, -1, 0.1),
                                          (4, 2, -0.05)]),
            m.plane_waves_dict(Xg, Yg, WL, [{"theta": 0.01}, {"A": 0.5,
                                                            "phi": 0.3}]),
            m.plane_waves_several_inclined(Xg, Yg, WL, 1.0, (2, 3),
                                           (0.02, 0.03)),
            m.gauss_beams_several_parallel(Xg, Yg, WL, (0.0, 0.0), 1.0,
                                           (2, 2), 6.0, (30.0, 20.0)),
            m.gauss_beams_several_inclined(Xg, Yg, WL, 1.0, (2, 1), 9.0,
                                           (0.0, 0.0), (0.02, 0.01))]


def _mask_utils(P):
    m = P.mk
    Xg, Yg = P.grid(X, Y)
    disc = m.circle(Xg, Yg, (0.0, 0.0), 3.0)
    pos = ([-20.0, 0.3, 15.0, 99.0], [-10.0, 5.0, 12.0, 0.0])
    u = P.arr(U)
    out = [m.dots(X, Y, pos, **P.kw),
           m.dots_regular(X, Y, (-30.0, 30.0), (-20.0, 25.0), (4, 3),
                          **P.kw),
           *m.photon_sieve(X, Y, disc, np.transpose(pos)),
           m.masks_to_positions(X, Y, disc, pos),
           m.masks_to_positions(X, Y, disc, pos, binarize=0.5,
                                normalize=True),
           m.insert_array_masks(X, Y, disc, (15.0, 12.0), 3.0),
           m.widen(X, Y, m.circle(Xg, Yg, (0.0, 0.0), 8.0), 3.0),
           m.widen(X, Y, m.circle(Xg, Yg, (0.0, 0.0), 8.0), 3.0, False),
           m.filter_mask(X, Y, u, disc), m.filter_mask(X, Y, u, disc, 0.5,
                                                       True),
           np.asarray(m.area(u, 1.2, 1.3, 0.1)),
           m.inverse_amplitude(u), m.inverse_phase(u),
           m.extrude_mask_x(X, Y, u[:, 0], -10.0, 20.0),
           *m.repeat_structure(X, Y, u, (2, 3)),
           *m.repeat_structure(X, Y, u, (2, 1), "previous"),
           m.set_amplitude(u, P.arr(np.abs(U[::-1]))),
           m.set_phase(u, P.arr(np.angle(U[:, ::-1])))]
    return out


def _masks_x(P):
    mx = P.mx
    x = P.arr(XL)
    return [mx.slit(x, 1.0, 20.0), mx.double_slit(x, 0.0, 5.0, 20.0),
            mx.two_levels(x, 0.2, 0.8, 3.0),
            mx.sine_grating(x, 7.0, 0.3, 0.1, 0.9),
            mx.binary_grating(x, 6.0, 0.2, 0.4),
            mx.ronchi_grating(x, 6.0), mx.blazed_grating(x, 8.0, WL),
            mx.lens(x, WL, 300.0, 1.0, 40.0),
            mx.lens_spherical(x, WL, 1.0, 40.0, 100.0),
            mx.aspheric(x, WL, 0.0, 0.01, -0.5, [1e-7], 1.0, 1.5, 40.0),
            mx.fresnel_lens(x, WL, 300.0, 0.0, 45.0),
            mx.gray_scale(x, 6, 0.1, 0.9), mx.prism(x, WL, 1.0, 1.5, 0.02),
            mx.biprism_fresnel(x, WL, 0.0, 40.0, 2.0),
            mx.chirped_grating_p(x, "amplitude", 5.0, 9.0),
            mx.chirped_grating_p(x, "phase_binary", 6.0, 6.0),
            mx.chirped_grating_q(x, "phase", 5.0, 9.0, 0.2, 0.8, 2.0),
            mx.chirped_grating(x, "amplitude_binary",
                               lambda a: 6.0 + 0.02 * a),
            mx.binary_code_positions(x, [-20.0, 5.0, 30.0, 5.0]),
            mx.binary_code_positions(x, [-10.0, 10.0], "up"),
            mx.binary_code(x, [1, 0, 1, 1, 0], 12.0, -30.0),
            mx.binary_code(x, [1, 0, 1], 20.0, -30.0, "abs_fag"),
            mx.plane_wave(x, WL, 0.02, 1.3, 2.0),
            mx.gauss_beam(x, WL, 10.0, 1.0, 200.0, 1.1, 0.01),
            mx.spherical_wave(x, WL, 1.0, -500.0, 2.0),
            mx.plane_waves_dict(x, WL, [{"theta": 0.01}, {"A": 0.3}]),
            mx.plane_waves_several_inclined(x, WL, 1.0, 3, 0.04),
            mx.gauss_beams_several_parallel(x, WL, 1.0, 3, 5.0, 1.0, 60.0),
            mx.gauss_beams_several_inclined(x, WL, 1.0, 2, 8.0, 0.0, 0.03),
            mx.dots(x, [-20.0, 3.3, 40.0]),
            mx.mask_from_function(x, lambda a: 0.5 + 0.3 * a / (1 + a * a)),
            mx.mask_from_array(x, [-60.0, 0.0, 60.0], [0.0, 1.0, 0.5]),
            mx.filter_mask(x, mx.slit(x, 0.0, 30.0), 3.0)]


N_XZ = np.ones((len(ZL), len(XL)))
N_RANDOM = 1.0 + RNG.uniform(0, 0.6, (len(ZL), len(XL)))


def _scenes_xz(P):
    s = P.sc
    n = P.arr(N_XZ)
    ar1 = np.stack([XL[::8], 20.0 + 0.05 * XL[::8]], 1)
    ar2 = np.stack([XL[::8], 50.0 + 3.0 * np.sin(XL[::8] / 9.0)], 1)
    lens_n, f1 = s.lens_plane_convergent(n, XL, ZL, (0.0, 10.0), 80.0, 40.0,
                                         15.0, 1.5)
    conv, f2 = s.lens_convergent(n, XL, ZL, (0.0, 10.0), 80.0,
                                 (50.0, -60.0), 20.0, 1.5, 0.05)
    pdiv, f3 = s.lens_plane_divergent(n, XL, ZL, (0.0, 10.0), 80.0, 40.0,
                                      15.0, 1.5)
    div, f4 = s.lens_divergent(n, XL, ZL, (0.0, 10.0), 80.0, (-40.0, 50.0),
                               20.0, 1.5)
    return [s.xz_grids(XL, ZL, **P.kw),
            s.object_by_surfaces(n, XL, ZL, [lambda a, b: a * a + b < 900.0],
                                 lambda a, b: 1.2 + 0.001 * a, 0.1,
                                 (0.0, 30.0)),
            s.semi_plane(n, XL, ZL, (0.0, 40.0), 1.4, 0.1),
            s.layer(n, XL, ZL, (0.0, 20.0), 15.0, 1.3 + 0.01j),
            s.rectangle(n, XL, ZL, (1.0, 40.0), (30.0, 20.0), 1.6, 0.2),
            s.slit(n, XL, ZL, (0.0, 30.0), 20.0, 10.0, 1.5 + 2j),
            s.slit(n, XL, ZL, (0.0, 30.0), 20.0, 10.0, 1.5, 1.2, 0.1),
            s.sphere(n, XL, ZL, (2.0, 40.0), (25.0, 15.0), 1.5, 0.2),
            s.semi_sphere(n, XL, ZL, (0.0, 40.0), 25.0, 1.5),
            s.wedge(n, XL, ZL, (-5.0, 10.0), 50.0, 1.5, 0.4),
            s.prism(n, XL, ZL, (-10.0, 20.0), 30.0, 1.5, 1.0, 0.1),
            s.biprism(n, XL, ZL, (0.0, 20.0), 60.0, 15.0, 1.5),
            s.probe(n, XL, ZL, (0.0, 5.0), 20.0, 40.0, 1.5),
            lens_n, np.asarray(f1), conv, np.asarray(f2), pdiv,
            np.asarray(f3), div, np.asarray(f4),
            s.aspheric_surface_z(n, XL, ZL, (0.0, 30.0), 1.5, 0.01, -0.5,
                                 1e-7),
            s.aspheric_surface_z(n, XL, ZL, (0.0, 30.0), 1.5, 0.01, 0.0,
                                 side="left"),
            s.aspheric_lens(n, XL, ZL, (0.0, 20.0), 1.5, (0.01, -0.008),
                            (-0.5, 0.2), 25.0, 70.0),
            s.mask_from_function_xz(n, XL, ZL, lambda a: 10.0 + 0.1 * a,
                                    lambda a: 60.0 - 0.001 * a * a, 1.4,
                                    (-30.0, 40.0)),
            s.mask_from_array_xz(n, XL, ZL, ar1, ar2, 1.45, None, 0.05),
            s.discretize_refraction_index(P.arr(N_RANDOM),
                                          [1.0, 1.2 + 0.01j, 1.5]),
            s.extrude_mask_xz(n, XL, ZL, P.arr((np.abs(XL) < 20) * 1.0),
                              20.0, 35.0, 1.5),
            s.dots_xz(n, XL, ZL, [(0.0, 30.0), (20.0, 60.0)], 2.0),
            s.add_surfaces(n, XL, ZL, lambda a: 10.0 + 0.0 * a,
                           lambda a: 30.0 + 0.1 * a, (-40.0, 30.0), 1.5),
            s.ronchi_grating_xz(n, XL, ZL, (0.0, 20.0), 8.0, 0.5, 80.0,
                                6.0, 1.3, 1.5, 4.0, 1.45),
            s.sine_grating_xz(n, XL, ZL, (0.0, 20.0), 9.0, 5.0, 1.5, 2.0)]


def _rough_sheet(P):
    n = P.arr(N_XZ)
    if P.name == "jax":
        return P.sc.rough_sheet(n, XL, ZL, (0.0, 30.0), (80.0, 20.0), 4.0,
                                0.8, 1.5, KEY, 0.05)
    return P.sc.rough_sheet(n, XL, ZL, (0.0, 30.0), (80.0, 20.0), 4.0, 0.8,
                            1.5, angle=0.05, noise=DRAWS["line"])


def _scenes_xyz(P):
    s = P.sc
    n = P.arr(np.ones((len(Z3), 64, 60)))
    return [*s.xyz_grids(X, Y, Z3, **P.kw),
            s.sphere_xyz(n, X, Y, Z3, (1.0, -1.0, 30.0), (20.0, 15.0, 18.0),
                         1.5),
            s.sphere_xyz(1.0, X, Y, Z3, (0.0, 0.0, 30.0), 12.0, 1.5 + 0.01j)
            if P.name == "jax" else
            s.sphere_xyz(torch.as_tensor(1.0, dtype=torch.float64), X, Y, Z3,
                         (0.0, 0.0, 30.0), 12.0, 1.5 + 0.01j),
            s.square_xyz(n, X, Y, Z3, (0.0, 1.0, 30.0), (20.0, 30.0, 15.0),
                         1.4),
            s.cylinder_xyz(n, X, Y, Z3, (0.0, 0.0, 30.0), 10.0, 40.0, 1.3),
            s.cylinder_xyz(n, X, Y, Z3, (0.0, 0.0, 30.0), (8.0, 11.0), 40.0,
                           1.3, "x"),
            s.cylinder_xyz(n, X, Y, Z3, (0.0, 0.0, 30.0), 9.0, 40.0, 1.3,
                           "y"),
            s.object_by_surfaces_xyz(n, X, Y, Z3,
                                     [lambda a, b, c: a + b < c],
                                     lambda a, b, c: 1.0 + 0.001 * c)]


def _optics(P):
    o = P.op
    rng = np.random.default_rng(13)
    xs = np.linspace(-30, 30, 301)
    I1 = np.exp(-xs ** 2 / 50.0) + 0.01 * rng.random(301)
    I2 = np.exp(-(X[:, None] ** 2 + 2 * Y[None, :] ** 2 + X[:, None]
                  * Y[None, :]) / 80.0)
    fr = np.linspace(-500, 500, 41)
    th = np.linspace(0.0, 1.2, 13)
    return [o.beam_width_1D(np.exp(-xs ** 2 / 40.0), xs),
            o.beam_width_1D(I1, xs, True), o.beam_width_2D(X, Y, I2),
            o.beam_width_2D(X, Y, I2, True), o.width_percentage(xs, I1),
            o.FWHM1D(xs, I1), o.FWHM1D(xs, I1, 0.3, "min"),
            o.FWHM1D(xs, I1, 0.5, "mean"), o.FWHM1D(xs, I1, 0.5, 0.05),
            o.FWHM2D(X, Y, I2), o.DOF(xs, 1.0 + xs ** 2 / 100.0),
            o.DOF(xs, 1.0 + xs ** 2 / 100.0, 2.0, 1.2),
            o.detect_intensity_range(xs, I1),
            o.MTF_ideal(fr, WL, 10.0, 40.0), o.MTF_ideal(fr, WL, 10, 40, "2D"),
            o.lines_mm_2_cycles_degree(fr, 0.04),
            o.MTF_parameters((fr, np.abs(np.sinc(fr / 400))),
                             (fr, o.MTF_ideal(fr, WL, 10.0, 40.0)[0])),
            o.gauss_spectrum(fr, 10.0, 80.0), o.lorentz_spectrum(fr, 0, 50),
            o.lorentz_spectrum(fr, 0, 50, False), o.uniform_spectrum(fr),
            o.normalize_field(U), o.normalize_field(U, "amplitude"),
            o.field_parameters(U), o.field_parameters(U, True),
            o.convert_phase2heights(np.angle(U), WL, 1.5, 1.0),
            o.convert_amplitude2heights(np.abs(U) / 4, WL, 0.1),
            o.fresnel_coefficients_dielectric(th, 1.0, 1.5),
            o.reflectance_transmitance_dielectric(th, 1.0, 1.5),
            o.fresnel_coefficients_complex(th, 1.0, 1.5 - 0.2j),
            o.reflectance_transmitance_complex(th, 1.0, 1.5 - 0.2j),
            o.roughness_1D(xs, 3.0, 0.2, seed=4),
            o.roughness_1D(xs, 3.0, 0.2, "uniform", 4),
            o.roughness_2D(X, Y, (3.0, 5.0), 0.2, seed=2)]


def _fieldz(P):
    zs = np.linspace(-50, 50, 201)
    f = P.fz.ScalarFieldZ(zs, WL)
    f.u = (1.0 / (1.0 + 1j * zs / 20.0)) * np.exp(1j * 0.1 * zs)
    g = f.duplicate()
    g.u = g.u * 0.5
    c = f.cut_resample((-20.0, 30.0), 77, new_field=True)
    d = f.duplicate().cut_resample((-20.0, 30.0))
    return [(f + g).u, (f - g).u, c.z, c.u, d.z, d.u,
            f.normalize("amplitude", new_field=True).u, f.intensity(),
            np.asarray(f.average_intensity()), f.field_parameters(),
            np.asarray(f.FWHM1D()), f.DOF()]


def _draw_arrays(P):
    d = P.draw
    u = P.arr(U)
    out = []
    for kind in ("intensity", "amplitude", "phase", "real", "imag", "field"):
        out += [d.prepare_drawing(u, kind),
                d.field_view(u, kind, logarithm=True, normalize=True,
                             cut_value=0.5)]
    return out + [d.normalize_draw(np.real(U), True, True, 0.2),
                  d.normalize_draw(np.abs(U), False, False, None)]


CASES = {"rough_masks_on_jax_draws": _rough,
         "masks_amplitude": _masks_amplitude, "masks_phase": _masks_phase,
         "sources": _sources, "mask_utils": _mask_utils,
         "masks_x": _masks_x, "scenes_xz": _scenes_xz,
         "rough_sheet_on_jax_draws": _rough_sheet,
         "scenes_xyz": _scenes_xyz, "optics": _optics, "fieldz": _fieldz,
         "drawing_transforms": _draw_arrays}


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
    for name, fn in CASES.items():
        out[name] = [host(a) for a in flat(fn(J))]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_jax(jref, name):
    got = flat(CASES[name](T))
    ref = jref[name]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        err = rel(a, b)
        assert err <= TOL, (name, i, err)


def test_rough_masks_draw_from_a_seed():
    """Without draws, the rough masks draw from a seeded generator: the
    same seed gives the same mask, and the height maps have the requested
    mean and standard deviation."""
    Xg, Yg = torch.meshgrid(torch.as_tensor(X), torch.as_tensor(Y),
                            indexing="ij")
    h = tmk.roughness_surface(X, Y, 3.0, 0.4, 5, device="cpu")
    assert abs(float(h.mean())) < 1e-12
    assert abs(float(h.std(correction=0)) - 0.4) < 1e-12
    a = tmk.fresnel_lens_rough(Xg, Yg, WL, (0, 0), 20.0, 126.0, 0.5, 8)
    b = tmk.fresnel_lens_rough(Xg, Yg, WL, (0, 0), 20.0, 126.0, 0.5,
                               torch.Generator().manual_seed(8))
    assert torch.equal(a, b)
    assert not torch.equal(a, tmk.fresnel_lens_rough(
        Xg, Yg, WL, (0, 0), 20.0, 126.0, 0.5, 9))
    m, pos, sizes = tmx.dust(torch.as_tensor(XL), 0.3, 4.0, 4, std=1.0)
    assert len(pos) == len(sizes) == int(0.3 * (XL[-1] - XL[0]) / 4.0)
    assert np.all((pos >= XL[0]) & (pos <= XL[-1]))
    s = tsc.rough_sheet(torch.ones(len(ZL), len(XL), dtype=torch.float64),
                        XL, ZL, (0.0, 30.0), (80.0, 20.0), 4.0, 0.8, 1.5, 2)
    assert torch.equal(s, tsc.rough_sheet(
        torch.ones(len(ZL), len(XL), dtype=torch.float64), XL, ZL,
        (0.0, 30.0), (80.0, 20.0), 4.0, 0.8, 1.5, 2))


def test_drawings_save(tmp_path):
    """Every drawing entry point renders and saves with Agg (each plot
    once), the arrays it draws held above."""
    u2 = torch.as_tensor(U)
    fx = tb.ScalarFieldX(XL, WL, u=np.exp(-XL ** 2 / 100.0), device="cpu")
    fxy = tb.ScalarFieldXY(X, Y, WL, u=u2, device="cpu")
    fxz = tb.ScalarFieldXZ(XL, ZL, WL, device="cpu").incident_field(
        np.exp(-XL ** 2 / 100.0))
    fxz.propagate()
    fxyz = tb.ScalarFieldXYZ(X, Y, Z3[:6], WL, device="cpu")
    fxyz.incident_field(u2).propagate()
    vec = tb.VectorFieldXY(X, Y, WL, device="cpu").incident_field(u2, u2)
    names = []
    for i, (f, kw) in enumerate([(fx, {}), (fxy, {"kind": "phase"}),
                                 (fxz, {"logarithm": True}), (fxyz, {}),
                                 (vec, {"normalize": True})]):
        names.append(tmp_path / f"d{i}.png")
        tdraw.draw(f, filename=str(names[-1]), **kw)
    s, prof = fxy.draw_profile((-20.0, -10.0), (20.0, 15.0), 50,
                               filename=str(tmp_path / "prof.png"))
    names += [tmp_path / "prof.png", tmp_path / "several.png"]
    tb.draw_several_fields([fxy, fxy], ("a", "b"), filename=str(names[-1]))
    names.append(tmp_path / "slices.png")
    tdraw.slices(fxyz.u, point=(0.0, 0.0, 2.0), output=str(names[-1]))
    gif = tdraw.video(fxz, str(tmp_path / "scan.gif"), fps=5, dpi=40)
    assert gif.endswith(".gif")
    names.append(tmp_path / "scan.gif")
    assert all(p.stat().st_size > 0 for p in names)
    jfxy = jbeam.ScalarFieldXY(X, Y, WL, u=U)
    js, jprof = jfxy.draw_profile((-20.0, -10.0), (20.0, 15.0), 50)
    assert rel(s, js) == 0.0 and rel(prof, jprof) <= TOL

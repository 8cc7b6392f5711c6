"""Parity of the PyTorch port's sparse-grid, eigensolver, scattering and
lattice modules (pyqed_tpu_torch: grid/smolyak, grid/nusol, ops/davidson,
grid/scattering, models/lattice) with the JAX package, on the CPU at
complex128.

The same numpy inputs go through both packages. Tolerances: closed forms
and dense solves rel 1e-12; eigenvalues of dense symmetric problems
1e-12, of Davidson at its tolerance (1e-9); the Fermi-Hubbard spectrum is
degenerate, so it is compared through energies, the Hamiltonian and the
particle-number sector, not through eigenvectors.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.grid import nusol as jnu
from pyqed_tpu.grid import scattering as jsc
from pyqed_tpu.grid import smolyak as jsm
from pyqed_tpu.models import lattice as jl
from pyqed_tpu.ops.davidson import davidson as j_davidson

from pyqed_tpu_torch.grid import nusol as tnu
from pyqed_tpu_torch.grid import scattering as tsc
from pyqed_tpu_torch.grid import smolyak as tsm
from pyqed_tpu_torch.models import lattice as tl
from pyqed_tpu_torch.ops.davidson import block_davidson, davidson

RTOL = 1e-12


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


# ------------------------------------------------------------ smolyak
def test_sparse_grid_matches_jax():
    f = lambda x, y: np.sin(3 * x) * np.exp(y)
    j = jsm.SparseGrid(2, 4).fit(f)
    t = tsm.SparseGrid(2, 4, device="cpu").fit(f)
    assert t.npts == j.npts
    np.testing.assert_array_equal(t.points, j.points)
    q = np.random.default_rng(1).random((20, 2))
    assert rel_err(t.eval(q), j.eval(q)) < RTOL
    assert t.combination_technique() == j.combination_technique()
    ja = jsm.AdaptiveSparseGrid(2, 3)
    ja.fit(lambda x, y: np.exp(-50 * ((x - 0.3) ** 2 + (y - 0.6) ** 2)))
    ta = tsm.AdaptiveSparseGrid(2, 3, device="cpu")
    ta.fit(lambda x, y: np.exp(-50 * ((x - 0.3) ** 2 + (y - 0.6) ** 2)))
    f2 = lambda x, y: np.exp(-50 * ((x - 0.3) ** 2 + (y - 0.6) ** 2))
    assert ta.refine(f2, tol=1e-3) == ja.refine(f2, tol=1e-3)
    assert rel_err(ta.eval(q), ja.eval(q)) < RTOL
    assert tsm.combination_technique(3, 5) == jsm.combination_technique(3, 5)


@pytest.mark.parametrize("kind", ["CC", "CH"])
def test_sparse_interpolator_matches_jax(kind):
    g = np.random.default_rng(2).random((50, 3))
    f = lambda X: np.exp(-np.sum((X - 0.4) ** 2, axis=1))
    j = jsm.SparseInterpolator(4, 3, kind, tol=1e-6)
    t = tsm.SparseInterpolator(4, 3, kind, tol=1e-6, device="cpu")
    assert rel_err(t.fit(f, g), j.fit(f, g)) < RTOL
    assert t.depth == j.depth
    g2 = np.random.default_rng(3).random((30, 3))
    assert rel_err(t.evaluate(g2), j.evaluate(g2)) < RTOL
    ref = tsm.SparseInterpolator.from_reference(j, device="cpu")
    assert rel_err(ref.evaluate(g2), j.evaluate(g2)) < RTOL


def test_sgct_ldr_matches_jax():
    """tests/test_polariton2_sgct.py's coherent state at q = 4."""
    def dpes(grids):
        X, Y = np.meshgrid(*grids, indexing="ij")
        return (0.5 * (X ** 2 + Y ** 2))[..., None, None]

    def psi0(grids):
        X, Y = np.meshgrid(*grids, indexing="ij")
        return np.exp(-((X - 1.0) ** 2 + Y ** 2) / 2)[..., None]

    args = ([(-7, 7), (-7, 7)], 4, dpes, psi0)
    jt, jx, jlev = jsm.SGCT_LDR(*args).run(dt=0.02, nt=20, nout=10)
    t, x, lev = tsm.SGCT_LDR(*args, device="cpu").run(dt=0.02, nt=20,
                                                      nout=10)
    assert rel_err(x, jx) < RTOL and rel_err(t, jt) < 1e-15
    assert set(lev) == set(jlev)
    for key in lev:
        assert rel_err(lev[key], jlev[key]) < RTOL
    # the population observable: one state, normalized on every grid
    tp = tsm.SGCT_LDR(*args, device="cpu").run(
        dt=0.02, nt=20, nout=10, observable="population")[1]
    assert rel_err(tp, np.ones((3, 1))) < 1e-12


# --------------------------------------------------------------- nusol
@pytest.mark.parametrize("method", ["numerov", "dvr", "primitive",
                                    "chebyshev"])
def test_nusol_matches_jax(method):
    cfg = dict(method=method, ndim=2, xmin=-5, xmax=5, ngridx=14, n_eval=4,
               potential="0.5*(x**2 + y**2) + 0.1*x*y")
    w, v = jnu.NuSol(cfg).run()
    tw, tv = tnu.NuSol(cfg, device="cpu").run()
    assert rel_err(tw, w) < RTOL
    assert tuple(tv.shape) == v.shape
    # eigenvectors up to sign: |<v_k|tv_k>| = |v_k|^2
    vf, tvf = v.reshape(-1, 4), host(tv).reshape(-1, 4)
    np.testing.assert_allclose(np.abs(np.sum(vf * tvf, 0)),
                               np.sum(vf * vf, 0), rtol=1e-9)


def test_nusol_sparse_branch_matches_jax():
    """A grid past the dense limit goes through SciPy's shift-invert
    eigsh on the host, in both packages."""
    cfg = dict(method="dvr", ndim=2, xmin=-6, xmax=6, ngridx=48, n_eval=3,
               potential=lambda x, y: 0.5 * (x ** 2 + 2 * y ** 2))
    w, _ = jnu.NuSol(cfg).run()
    tw, _ = tnu.NuSol(cfg, device="cpu").run()
    assert rel_err(tw, w) < 1e-10


def test_cheb_d2_matches_jax():
    D, x = tnu.cheb_D2(9, -2.0, 3.0)
    jD, jx = jnu.cheb_D2(9, -2.0, 3.0)
    np.testing.assert_array_equal(D, jD)
    np.testing.assert_array_equal(x, jx)


def test_vibrational_dvr3d_matches_jax():
    """H applied to a block of columns as in the JAX package; the block
    Davidson energies against the dense spectrum of the JAX H (the
    Davidson solvers themselves are compared in test_davidson_*)."""
    pes = lambda X, Y, Z: (0.5 * (X ** 2 + 1.3 * Y ** 2 + 0.8 * Z ** 2)
                           + 0.05 * X * Y * Z)
    args = (pes, [1.0, 1.0, 1.0], [(-5, 5)] * 3, [8, 8, 8])
    j = jnu.VibrationalDVR3D(*args)
    t = tnu.VibrationalDVR3D.from_reference(j, device="cpu")
    assert rel_err(t.Vg, j.Vg) == 0.0
    H = np.asarray(jax.jit(j.apply_H)(jnp.eye(512)))
    assert rel_err(t.apply_H(torch.eye(512, dtype=torch.float64)), H) < RTOL
    E = np.linalg.eigvalsh(0.5 * (H + H.T))[:3]
    assert rel_err(t.run(neig=3), E) < 1e-9
    own = tnu.VibrationalDVR3D(*args, device="cpu")
    assert rel_err(own.run(neig=3), E) < 1e-9


# ------------------------------------------------------------ davidson
def test_davidson_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((40, 40))
    A = A + A.T + np.diag(np.arange(40.0) * 3)
    exact = np.linalg.eigvalsh(A)
    w, _ = j_davidson(A, 4)
    tw, tX = davidson(A, 4)
    assert rel_err(tw, w) < 1e-10
    assert rel_err(torch.as_tensor(A) @ tX, tX * tw) < 1e-7
    # the Jacobi correction and the matrix-free block form against the
    # exact spectrum (each JAX call recompiles as its subspace grows)
    assert rel_err(davidson(A, 3, jacobi=True, tol=1e-10)[0],
                   exact[:3]) < 1e-10
    At = torch.as_tensor(A)
    tb, _ = block_davidson(lambda x: At @ x, neig=3,
                           diag=torch.as_tensor(np.diag(A).copy()))
    assert rel_err(tb, exact[:3]) < 1e-9
    with pytest.raises(ValueError, match="diag"):
        davidson(lambda x: At @ x, 2)


# ---------------------------------------------------------- scattering
def test_lippmann_schwinger_matches_jax():
    V = lambda x: 1.0 * (np.abs(x) < 0.5)
    psi, T = jsc.LippmannSchwingerSolver(-5, 5, 80, V=V).run(
        np.array([0.5, 1.5, 3.0]))
    tpsi, tT = tsc.LippmannSchwingerSolver(-5, 5, 80, V=V,
                                           device="cpu").run(
        np.array([0.5, 1.5, 3.0]))
    assert rel_err(tpsi, psi) < RTOL and rel_err(tT, T) < RTOL
    x = np.linspace(-2, 2, 12)
    V2 = lambda X, Y: np.exp(-X ** 2 - Y ** 2)
    ref = jsc.LippmannSchwinger2DSolver(x, x, V2).run(2.0, 0.3)
    out = tsc.LippmannSchwinger2DSolver(x, x, V2, device="cpu").run(2.0, 0.3)
    assert rel_err(out, ref) < RTOL


# ------------------------------------------------------------- lattice
def test_encodings_match_jax():
    for a, b in zip(tl.jordan_wigner_ops(4, device="cpu"),
                    jl.jordan_wigner_ops(4)):
        assert rel_err(a, b) == 0.0
    for a, b in zip(tl.bravyi_kitaev_ops(5, device="cpu"),
                    jl.bravyi_kitaev_ops(5)):
        assert rel_err(a, b) == 0.0
    np.testing.assert_array_equal(tl.bravyi_kitaev_matrix(6),
                                  jl.bravyi_kitaev_matrix(6))
    for j in range(6):
        assert tl.bravyi_kitaev_sets(j, 6) == jl.bravyi_kitaev_sets(j, 6)


@pytest.mark.parametrize("L", [3])
def test_fermi_hubbard_matches_jax(L):
    """The same Hamiltonian (assembled in the occupation basis, not by
    products of dense Jordan-Wigner operators); the half-filling sector's
    spectrum against the dense sector block of the JAX H, and the
    ground energy against the JAX run."""
    j = jl.FermiHubbard(1.0, 4.0, L, nelec=L, mu=0.3)
    t = tl.FermiHubbard(1.0, 4.0, L, nelec=L, mu=0.3, device="cpu")
    E = t.run(6)
    jE = j.run(6)
    assert rel_err(t.H, j.H) < 1e-15
    assert rel_err(t.number_operator(), j.number_operator()) == 0.0
    N = np.real(np.diag(np.asarray(j.number_operator())))
    sector = np.flatnonzero(np.abs(N - L) < 0.5)
    block = np.asarray(j.H)[np.ix_(sector, sector)]
    assert rel_err(E, np.linalg.eigvalsh(block)[:6]) < RTOL
    assert abs(E[0].item() - float(jE[0])) < 1e-12
    # the eigenvectors lie in the sector: particle number L, H v = E v
    v = host(t.eigvecs)
    assert np.allclose(np.einsum("ik, i, ik -> k", v.conj(), N, v).real, L)
    assert rel_err(host(t.H) @ v, v * host(E)) < 1e-10


def test_bose_hubbard_and_chains_match_jax():
    assert rel_err(tl.BoseHubbard(1.0, 2.0, 3, nmax=2, mu=0.1,
                                  device="cpu").run(4),
                   jl.BoseHubbard(1.0, 2.0, 3, nmax=2, mu=0.1).run(4)) \
        < RTOL
    for kw in (dict(), dict(boundary_condition="periodic")):
        j, t = jl.Chain(6, 0.1, 1.0, **kw), tl.Chain(6, 0.1, 1.0,
                                                   device="cpu", **kw)
        assert rel_err(t.run()[0], j.run()[0]) < RTOL
        om = np.linspace(-2, 2, 5)
        assert rel_err(t.gf(om), j.gf(om)) < RTOL
        assert rel_err(t.ldos(om), j.ldos(om)) < RTOL
        assert rel_err(t.position(), j.position()) == 0.0
    hop = np.array([[0.0, 0.5], [1.0, 0.0]])
    j2 = jl.Chain(4, [0.1, -0.2], hop, norb=2, boundary_condition="periodic")
    t2 = tl.Chain(4, [0.1, -0.2], hop, norb=2,
                  boundary_condition="periodic", device="cpu")
    assert rel_err(t2.buildH(), j2.buildH()) == 0.0
    for a, b in zip(t2.gf_surface(0.2), j2.gf_surface(0.2)):
        assert rel_err(a, b) < RTOL
    rm, jrm = tl.RiceMele(0.5, 1.0, nsites=8, device="cpu"), \
        jl.RiceMele(0.5, 1.0, nsites=8)
    assert rel_err(rm.run()[0], jrm.run()[0]) < RTOL
    assert rel_err(rm.band_structure(), jrm.band_structure()) < RTOL
    assert rel_err(rm.position(), jrm.position()) == 0.0
    for a, b in zip(rm.gf_surface(0.3), jrm.gf_surface(0.3)):
        assert rel_err(a, b) < RTOL
    jlat = jl.Lattice2D((3, 2), norb=2).set_onsite([0.1, -0.1])
    tlat = tl.Lattice2D((3, 2), norb=2, device="cpu").set_onsite([0.1, -0.1])
    for lat in (jlat, tlat):
        lat.set_hop(1.0, 0, 1, (0, 0)).set_hop(0.5j, 1, 0, (1, 0),
                                               "periodic")
        lat.set_hop(0.3, 0, 0, (0, 1), "periodic")
    assert rel_err(tlat.buildH(), jlat.buildH()) == 0.0
    assert rel_err(tlat.solve()[0], jlat.solve()[0]) < RTOL


def test_green_renormalization_matches_jax():
    intra = np.array([[0.1, 0.4], [0.4, -0.1]])
    inter = np.array([[0.2, 0.0], [0.7, 0.1]])
    for e in (-0.5, 0.0, 0.8):
        for a, b in zip(tl.green_renormalization(intra, inter, energy=e,
                                                 device="cpu"),
                        jl.green_renormalization(intra, inter, energy=e)):
            assert rel_err(a, b) < 1e-10

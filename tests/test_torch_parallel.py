"""Parity of the port's parallel/ and of its kernel-carrying sharded paths
(pyqed_tpu_torch: meshes, the pencil FFT, HEOMSolver.run, SPON.run and
field_2des_rephasing with ``mesh=``) with the JAX package, on the CPU in
float64.

One gloo group of 4 spawned ranks (``tests/torch_parallel_ranks.py``, one
thread each) runs every case of this file in one launch while the parent
computes the JAX package's sharded references on its 8 virtual CPU devices
(``tests/conftest.py``). Each sharded result is held to JAX's at 1e-10 and
to the port's unsharded run at 1e-12; the plain versions of the kernels
count the launches a rank makes, which must equal the unsharded run's;
the collectives are counted through wrappers of ``torch.distributed``.
JAX is imported inside the fixture only, so a rank never loads it.
"""
import numpy as np
import pytest

import torch_parallel_ranks as R

RESULT_TOL = 1e-10     # against JAX's sharded result
SELF_TOL = 1e-12       # against the port's unsharded run


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (rank order) and the JAX references."""
    launch = R.Launch("parallel", tmp_path_factory.mktemp("parallel"))
    try:
        ref = _jax_references()
    finally:
        results = launch.wait()
    return results, ref


def _jax_references():
    import jax.numpy as jnp
    from pyqed_tpu import pauli
    from pyqed_tpu.grid.spo import SPO, SPO2
    from pyqed_tpu.open.bath import DrudeBath
    from pyqed_tpu.open.heom import HEOMSolver
    from pyqed_tpu.parallel import make_mesh
    from pyqed_tpu.signal import field_2des_rephasing
    ref = {}
    H, Q, rho0, e_ops = R.heom_model()
    c, nu = DrudeBath(temperature=1.0, cutoff=0.5, reorg=0.1).matsubara(1)
    sol = HEOMSolver(H, bath=[(Q, c, nu)], lmax=4)
    ado = make_mesh({"ado": 8})
    ref["heom"] = sol.run(rho0, e_ops=e_ops, mesh=ado, **R.HEOM_RUN)
    ref["heom_driven"] = sol.run(
        rho0, e_ops=e_ops, mesh=ado, edip=R.EDIP,
        pulse=lambda t: 0.05 * jnp.cos(1.0 * t), **R.HEOM_DRIVE)
    grid = make_mesh({"x": 8})
    x, surfaces, cpl, psi0 = R.spo2_model()
    s = SPO2(x, x, masses=[1.0, 1.0], nstates=2, mesh=grid)
    s.set_DPES(surfaces, cpl)
    ref["spo", "linear"] = s.run(psi0, **R.SPO_RUNS["linear"])
    x, th, surfaces, cpl, psi0 = R.jacobi_model()
    s = SPO2(x, th, masses=[1.0, lambda r: 1.0 * r ** 2], nstates=2,
             coords="jacobi", mesh=grid)
    s.set_DPES(surfaces, cpl)
    ref["spo", "jacobi"] = s.run(psi0, **R.SPO_RUNS["jacobi"])
    x, v, psi0 = R.spo1_model()
    s = SPO(x, mass=1.0, nstates=2, mesh=grid)
    s.set_dpes(v)
    ref["spo", "1d"] = s.run(psi0, **R.SPO_RUNS["1d"])
    _, sx, _, sz = [np.asarray(p) for p in pauli()]
    bath = DrudeBath(temperature=0.5, cutoff=0.5, reorg=0.01)
    bath.set_bath_ops([jnp.asarray(sz)])
    tls = HEOMSolver(jnp.asarray(0.5 * sz, dtype=complex), bath=bath, lmax=1,
                     decomposition="pade", nexp=1)
    ref["field2des"] = np.asarray(field_2des_rephasing(
        tls, np.array([[1.0, 0], [0, 0]], complex), sx, R.F2D_T1S,
        mesh=make_mesh({"batch": 8}), **R.F2D_RUN)[0])
    return ref


def case(runs, name):
    return R.case_result(runs[0], name)


def _ranks_agree(per_rank, field):
    """Every rank returns the same whole result."""
    for other in per_rank[1:]:
        np.testing.assert_array_equal(other[field], per_rank[0][field])


# ------------------------------------------------------------------ mesh
def test_mesh_api_and_runtime(runs):
    out = case(runs, "mesh_api")
    assert all(r["started"] for r in runs[0])
    for rank, o in enumerate(out):
        assert o["shape"] == (2, 2) and o["names"] == ("dp", "tp")
        assert "do not multiply to 4" in o["bad"]
        assert o["pad"] == ((16, 3), 10, 0.0)
        np.testing.assert_array_equal(
            o["shard"], np.arange(10.0)[rank * 3:min(rank * 3 + 3, 10)])
        assert o["placements"] == (["R", "S(1)"], ["R", "R"])
        assert o["info"] == (rank, 4, 1, 4)


# ------------------------------------------------------------ pencil FFT
@pytest.mark.parametrize("shape,fnd", R.PENCIL_SHAPES)
def test_fft_sharded_matches_fftn(runs, shape, fnd):
    """Forward and inverse distributed FFT against torch.fft.fftn in 1-D
    (four-step: 3 all-to-alls), 2-D and 3-D (pencil: 2), no gather."""
    for o in case(runs, "pencil_fft"):
        r = o[shape]
        assert r["fwd"] < SELF_TOL and r["back"] < SELF_TOL
        assert r["counts"] == dict(all_to_all=3 if fnd == 1 else 2,
                                   all_gather=0, all_reduce=0)


@pytest.mark.parametrize("grid,ns", R.KEO_GRIDS)
def test_keo_pencil_collectives_and_dense(runs, grid, ns):
    """The fused KEO equals ifftn(expK fftn(psi)) with 2 all-to-alls in
    N-D and 4 in 1-D, no gather, and one phase-kernel call."""
    for o in case(runs, "keo"):
        r = o[grid]
        assert r["err"] < SELF_TOL
        assert r["counts"] == dict(all_to_all=4 if len(grid) == 1 else 2,
                                   all_gather=0, all_reduce=0)
        assert r["phase"] == 1


def test_grid_that_does_not_divide_raises(runs):
    """No silent gather: the pencil KEO, the 1-D four-step FFT and
    SPON(mesh=) raise with the shape, before any collective."""
    for o in case(runs, "not_dividing"):
        assert "(30, 64, 2)" in o["keo"] and "does not divide" in o["keo"]
        assert "(24, 2)" in o["fft1d"] and "d**2" in o["fft1d"]
        assert "(30, 30, 1)" in o["spo"]
        assert o["counts"] == dict(all_to_all=0, all_gather=0, all_reduce=0)


# ----------------------------------------------------------------- HEOM
@pytest.mark.parametrize("kernel", ["einsum", "cuda", "levels", "matmul"])
def test_heom_sharded_matches_jax_and_unsharded(runs, kernel):
    """15 ADOs over 4 ranks (chunks of 4, one padding ADO): every kernel
    runs on the rank's destinations after one all-gather a right-hand
    side; ``cuda`` (its plain version here) counts 4·nt calls a rank, as
    unsharded."""
    jr = runs[1]["heom"]
    per_rank = case(runs, "heom")
    nt = R.HEOM_RUN["nt"]
    for o in per_rank:
        r = o[kernel]
        for f in ("observables", "states", "rho", "ado", "times"):
            assert rel(r["sharded"][f], np.asarray(getattr(jr, f))) \
                < RESULT_TOL, f
            assert rel(r["sharded"][f], r["unsharded"][f]) < SELF_TOL, f
        assert r["launches"] == r["launches_unsharded"] == (
            4 * nt if kernel == "cuda" else 0)
        # one gather per right-hand side and one per output window
        assert r["counts"] == dict(all_to_all=0, all_gather=4 * nt + nt,
                                   all_reduce=0)
    _ranks_agree([o[kernel]["sharded"] for o in per_rank], "ado")


def test_heom_sharded_driven_checkpointed_and_resumed(runs):
    jr = runs[1]["heom_driven"]
    for o in case(runs, "heom"):
        r = o["driven"]
        for f in ("observables", "states", "rho", "ado"):
            assert rel(r["sharded"][f], np.asarray(getattr(jr, f))) \
                < RESULT_TOL, f
            assert rel(r["sharded"][f], r["unsharded"][f]) < SELF_TOL, f
        assert rel(r["resumed"], r["resumed_ref"]) < SELF_TOL


# ------------------------------------------------------------------ SPO
@pytest.mark.parametrize("kind", list(R.SPO_RUNS))
def test_spo_sharded_matches_jax_and_unsharded(runs, kind):
    """SPO2 (pencil KEO), SPO2 in Jacobi coordinates (factor KEO) and the
    1-D SPO (four-step KEO) on 4 ranks: the phase kernel nt times and the
    potential kernel 2·nt times a rank, as unsharded (the Jacobi factors
    are broadcast products, as unsharded)."""
    jr = runs[1]["spo", kind]
    nt = R.SPO_RUNS[kind]["nt"]
    per_rank = case(runs, "spo")
    for o in per_rank:
        r, u = o[kind]["sharded"], o[kind]["unsharded"]
        for f in ("psi", "population", "states", "rho_el"):
            assert rel(r[f], np.asarray(getattr(jr, f))) < RESULT_TOL, f
            assert rel(r[f], u[f]) < SELF_TOL, f
        assert r["phase"] == u["phase"] == (0 if kind == "jacobi" else nt)
        assert r["potential"] == u["potential"] == 2 * nt
        assert r["counts"]["all_to_all"] == (4 if kind == "1d" else 2) * nt
    _ranks_agree([o[kind]["sharded"] for o in per_rank], "psi")


def test_spo_sharded_checkpointed_and_resumed(runs):
    """The sharded SPO2 writes its checkpoints from rank 0 (every 3
    windows and the last); a sharded run resumed from one to twice nt
    ends as the unsharded run of twice nt."""
    for o in case(runs, "spo"):
        r = o["resumed"]
        assert rel(r["states"], r["states_ref"]) < SELF_TOL
        assert rel(r["rho_el"], r["rho_el_ref"]) < SELF_TOL


# ----------------------------------------------------------- field 2DES
def test_field2des_sharded_matches_jax_and_unsharded(runs):
    """The 128 members of the phase × t1 batch over 4 ranks, each rank's
    32 through the coupling kernel's wrapper (one call a right-hand side,
    as unsharded), one all-gather in all."""
    jr = runs[1]["field2des"]
    per_rank = case(runs, "field2des")
    for o in per_rank:
        s, u = o["sharded"], o["unsharded"]
        assert rel(s["P3"], jr) < RESULT_TOL
        assert rel(s["P3"], u["P3"]) < SELF_TOL
        assert s["launches"] == u["launches"] > 0
        assert s["counts"] == dict(all_to_all=0, all_gather=1, all_reduce=0)
    _ranks_agree([o["sharded"] for o in per_rank], "P3")

"""Parity of the PyTorch port's HEOM operators (pyqed_tpu_torch/ops) with
the JAX package's (pyqed_tpu/ops/pallas_kernels.py), on the CPU at
complex128.

The same inputs, made with numpy from a seed, go through the JAX function
(Pallas kernels in interpret mode) and the port's counterpart; the two are
compared as numpy arrays at rel 1e-12, the gate of tests/test_pallas.py.
The CUDA kernel itself runs only on a GPU (chip_smoke.py); here its
wrapper takes the plain version because the tensors lie on the CPU.
"""
import ctypes
import re
import shutil
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyqed_tpu.ops import pallas_kernels as pk
from pyqed_tpu.open.heom import enumerate_hierarchy as j_enum
from pyqed_tpu.open.heom import neighbor_maps as j_nbr
from pyqed_tpu_torch.models.named import FMO
from pyqed_tpu_torch.ops import kernels as kn
from pyqed_tpu_torch.ops import _cuda_lib

RTOL = 1e-12     # f64 parity gate of the HEOM right-hand sides


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


def hierarchy(M=3, lmax=3, n=3, seed=7, projectors=False):
    """Random Hermitian H, couplings (dense or site projectors), complex
    c and real rates on an (M, lmax) hierarchy."""
    rng = np.random.default_rng(seed)
    keys, index = j_enum(M, lmax)
    plus_idx, minus_idx = j_nbr(keys, index)
    H = rng.standard_normal((n, n))
    H = H + H.T
    if projectors:
        Q = np.stack([np.diag(np.eye(n)[m % n]) for m in range(M)])
    else:
        Q = rng.standard_normal((M, n, n))
        Q = Q + np.swapaxes(Q, 1, 2)
    c = crand(rng, M)
    nu = rng.uniform(0.5, 2.0, M)
    return dict(H=H, Q=Q, c=c, nu=nu, keys=np.asarray(keys),
                plus_idx=np.asarray(plus_idx), minus_idx=np.asarray(minus_idx),
                rng=rng)


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ---------------------------------------------------------------- (i)
@pytest.mark.parametrize("direction", ["plus", "minus"])
def test_level_coupling_matches_pallas_call(direction):
    """Port level_coupling == pk._level_coupling_call (interpret, f64) on
    operands from JAX heom_level_blocks, every destination level."""
    h = hierarchy()
    blocks = pk.heom_level_blocks(h["H"], h["Q"], h["c"], h["keys"],
                                  h["plus_idx"], h["minus_idx"])
    _, _, pad_sizes, _, _, _ = blocks["structure"]
    Vp = blocks["Vp"]
    select_first = direction == "plus"
    Ss = blocks["Splus"] if select_first else blocks["Sminus"]
    Op = blocks["Pt"] if select_first else blocks["Dt"]
    Op_split = (np.ascontiguousarray(Op.real), np.ascontiguousarray(Op.imag))
    rng = h["rng"]
    for S in Ss:
        S = np.asarray(S, np.float64)
        F = crand(rng, S.shape[-1], Vp)
        gr, gi = pk._level_coupling_call(
            S, Op_split, jnp.asarray(F.real), jnp.asarray(F.imag), fast=False,
            interpret=True, select_first=select_first)
        ref = np.asarray(gr) + 1j * np.asarray(gi)
        out = kn.level_coupling(t(S), t(Op), t(F), select_first=select_first)
        assert rel_err(out.numpy(), ref) < RTOL


def test_level_coupling_orders_agree():
    h = hierarchy()
    blocks = kn.heom_level_blocks(h["H"], h["Q"], h["c"], h["keys"],
                                  h["plus_idx"], h["minus_idx"])
    F = crand(h["rng"], blocks["Splus"][0].shape[-1], blocks["V"])
    a = kn.level_coupling(t(blocks["Splus"][0]), t(blocks["Pt"]), t(F), True)
    b = kn.level_coupling(t(blocks["Splus"][0]), t(blocks["Pt"]), t(F), False)
    assert rel_err(a.numpy(), b.numpy()) < RTOL


# ---------------------------------------------------------------- (ii)
def test_superop_builders_match_jax():
    h = hierarchy()
    args = (h["H"], h["Q"], h["c"])
    np.testing.assert_array_equal(kn.heom_superop_matrix(*args),
                                  pk.heom_superop_matrix(*args))
    for a, b in zip(kn.heom_superop_split(*args), pk.heom_superop_split(*args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("projectors", [True, False])
def test_q_projector_sites_match_jax(projectors):
    Q = hierarchy(projectors=projectors)["Q"]
    a, b = kn.heom_q_projector_sites(Q), pk.heom_q_projector_sites(Q)
    if projectors:
        np.testing.assert_array_equal(a, b)
    else:
        assert a is None and b is None


@pytest.mark.parametrize("M,lmax", [(3, 3), (4, 2), (2, 5)])
def test_level_structure_matches_jax_unpadded(M, lmax):
    keys = hierarchy(M=M, lmax=lmax)["keys"]
    sizes, offs = kn.heom_level_structure(keys)
    j_sizes, j_offs, pad_sizes, pad_offs, _, perm = pk.heom_level_structure(keys)
    assert sizes == list(j_sizes)
    assert offs == [int(o) for o in j_offs]
    # the JAX layout pads each level to 8 rows; its perm maps the compact
    # (port) row of each ADO to its padded row
    for l in range(len(sizes)):
        rows = np.arange(offs[l], offs[l] + sizes[l])
        np.testing.assert_array_equal(perm[rows], pad_offs[l] + rows - offs[l])


def test_level_blocks_match_jax_up_to_padding():
    h = hierarchy()
    args = (h["H"], h["Q"], h["c"], h["keys"], h["plus_idx"], h["minus_idx"])
    ours, ref = kn.heom_level_blocks(*args), pk.heom_level_blocks(*args)
    V = ours["V"]
    assert V == ref["V"] and ours["M"] == ref["M"]
    for name in ("C", "Pt", "Dt"):
        np.testing.assert_array_equal(ours[name], ref[name][..., :V, :V])
        assert not np.any(ref[name][..., V:, :]) and not np.any(
            ref[name][..., :, V:])
    for name in ("Splus", "Sminus"):
        assert len(ours[name]) == len(ref[name])
        for a, b in zip(ours[name], ref[name]):
            np.testing.assert_array_equal(a, b[:, :a.shape[1], :a.shape[2]])
            assert np.abs(b).sum() == np.abs(a).sum()     # padding is zero


# ------------------------------------------------- torch right-hand sides
def jax_dot_reference(h, ados):
    """The JAX stacked-superoperator RHS on its own gathered stack."""
    B0, Bk = pk.heom_superop_split(h["H"], h["Q"], h["c"])
    keys = h["keys"]
    nado = keys.shape[0]
    damp = keys @ h["nu"]
    all_idx = np.concatenate([h["plus_idx"], h["minus_idx"]], axis=1)
    wocc = np.concatenate([np.ones_like(keys), keys], axis=1).astype(float)
    flat = ados.reshape(nado, -1)
    padded = np.concatenate([flat, np.zeros((1, flat.shape[1]), complex)])
    g = padded[all_idx] * wocc[:, :, None]
    out = pk.heom_rhs_dot(jnp.asarray(B0), jnp.asarray(Bk), jnp.asarray(damp),
                          jnp.asarray(flat), jnp.asarray(g))
    return np.asarray(out), (B0, Bk, damp, flat, g)


def test_rhs_dot_matches_jax():
    h = hierarchy()
    n = h["H"].shape[0]
    ados = crand(h["rng"], h["keys"].shape[0], n, n)
    ref, (B0, Bk, damp, flat, g) = jax_dot_reference(h, ados)
    out = kn.heom_rhs_dot(t(B0), t(Bk), t(damp), t(flat), t(g))
    assert rel_err(out.numpy(), ref) < RTOL


def test_coupling_index_form_matches_jax():
    """flat @ C − damp·flat + heom_coupling_ref == the JAX stacked RHS."""
    h = hierarchy()
    n = h["H"].shape[0]
    ados = crand(h["rng"], h["keys"].shape[0], n, n)
    ref, (_, _, damp, flat, _) = jax_dot_reference(h, ados)
    C, OpT, nbr, w = kn.heom_coupling_operands(
        h["H"], h["Q"], h["c"], h["keys"], h["plus_idx"], h["minus_idx"])
    F = t(flat)
    out = F @ t(C) - t(damp)[:, None] * F + kn.heom_coupling_ref(
        F, t(nbr), t(w), t(OpT))
    assert rel_err(out.numpy(), ref) < RTOL


def test_rowcol_factory_matches_jax():
    h = hierarchy(projectors=True)
    args = (h["H"], h["Q"], h["c"], h["nu"], h["keys"], h["plus_idx"],
            h["minus_idx"])
    n = h["H"].shape[0]
    ados = crand(h["rng"], h["keys"].shape[0], n, n)
    ref = np.asarray(pk.heom_rhs_rowcol_factory(*args, dtype=np.float64)(
        jnp.asarray(ados)))
    out = kn.heom_rhs_rowcol_factory(*args, device="cpu")(t(ados))
    assert rel_err(out.numpy(), ref) < RTOL


def test_rowcol_factory_rejects_nonprojector():
    h = hierarchy()
    with pytest.raises(ValueError):
        kn.heom_rhs_rowcol_factory(h["H"], h["Q"], h["c"], h["nu"], h["keys"],
                                   h["plus_idx"], h["minus_idx"],
                                   device="cpu")


def test_levels_factory_matches_jax():
    h = hierarchy()
    args = (h["H"], h["Q"], h["c"], h["nu"], h["keys"], h["plus_idx"],
            h["minus_idx"])
    n = h["H"].shape[0]
    ados = crand(h["rng"], h["keys"].shape[0], n, n)
    rhs, embed, extract, _ = pk.heom_rhs_levels_xla_factory(
        *args, dtype=np.float64)
    fr, fi = embed(ados)
    ref = extract(*rhs(jnp.asarray(fr), jnp.asarray(fi)))
    out = kn.heom_rhs_levels_xla_factory(*args, device="cpu")(t(ados))
    assert rel_err(out.numpy(), ref) < RTOL


def test_coupling_factory_matches_jax_pallas_factory():
    h = hierarchy()
    args = (h["H"], h["Q"], h["c"], h["nu"], h["keys"], h["plus_idx"],
            h["minus_idx"])
    n = h["H"].shape[0]
    ados = crand(h["rng"], h["keys"].shape[0], n, n)
    rhs, embed, extract, _ = pk.heom_rhs_levels_factory(
        *args, interpret=True, dtype=np.float64)
    fr, fi = embed(ados)
    ref = extract(*rhs(jnp.asarray(fr), jnp.asarray(fi)))
    out = kn.heom_rhs_coupling_factory(*args, device="cpu")(t(ados))
    assert rel_err(out.numpy(), ref) < RTOL


# ---------------------------------------------------- the kernel wrapper
def coupling_args(dtype=torch.complex128):
    h = hierarchy()
    _, OpT, nbr, w = kn.heom_coupling_operands(
        h["H"], h["Q"], h["c"], h["keys"], h["plus_idx"], h["minus_idx"])
    F = crand(h["rng"], h["keys"].shape[0], OpT.shape[-1])
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    return (torch.as_tensor(F, dtype=dtype), torch.as_tensor(nbr),
            torch.as_tensor(w, dtype=rdt), torch.as_tensor(OpT, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_wrapper_on_cpu_is_plain_and_launches_nothing(dtype):
    args = coupling_args(dtype)
    kn.heom_coupling.launches = 0
    out = kn.heom_coupling(*args)
    assert kn.heom_coupling.launches == 0
    torch.testing.assert_close(out, kn.heom_coupling_ref(*args), rtol=0, atol=0)


def _bad_args(case):
    F, nbr, w, OpT = coupling_args()
    if case == "real F":
        return (F.real.contiguous(), nbr, w, OpT), TypeError
    if case == "w precision":
        return (F, nbr, w.float(), OpT), TypeError
    if case == "nbr int64":
        return (F, nbr.long(), w, OpT), TypeError
    if case == "OpT dtype":
        return (F, nbr, w, OpT.to(torch.complex64)), TypeError
    if case == "shape":
        return (F[:-1].contiguous(), nbr, w, OpT), ValueError
    if case == "noncontiguous":
        return (F, nbr.t().contiguous().t(), w, OpT), ValueError
    if case == "meta device":
        return tuple(x.to("meta") for x in (F, nbr, w, OpT)), ValueError
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["real F", "w precision", "nbr int64",
                                  "OpT dtype", "shape", "noncontiguous",
                                  "meta device"])
def test_wrapper_rejects_bad_arguments(case):
    args, exc = _bad_args(case)
    with pytest.raises(exc):
        kn.heom_coupling(*args)


def test_cuda_entry_points_match_ctypes_signatures():
    """Every extern "C" function of the .cu source has argtypes in
    _cuda_lib with as many entries as the C function has parameters."""
    src = (Path(_cuda_lib.CSRC) / "heom_coupling.cu").read_text()
    found = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        found[name] = len([p for p in params.split(",") if p.strip()])
    sigs = _cuda_lib.SIGNATURES["heom_coupling"]
    assert set(found) == {"heom_coupling_c128", "heom_coupling_c64",
                          "heom_coupling_batched_c128",
                          "heom_coupling_batched_c64"}
    assert set(found) == set(sigs)
    for name, nparams in found.items():
        assert len(sigs[name]) == nparams


def test_plan_args_struct_matches_ctypes():
    """The structs that the C entry points take, PlanArgs (edge-major) and
    BatchArgs (destination-major), have the fields of
    _cuda_lib.CouplingPlanArgs and CouplingBatchArgs, in order, with
    matching C types."""
    src = (Path(_cuda_lib.CSRC) / "heom_coupling.cu").read_text()
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int}
    for struct, mirror in (("PlanArgs", _cuda_lib.CouplingPlanArgs),
                           ("BatchArgs", _cuda_lib.CouplingBatchArgs)):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", src,
                         re.S).group(1)
        fields = re.findall(r"^\s*(?:const )?(void\*|int) (\w+);", body,
                            re.M)
        assert [(name, ctype[t]) for t, name in fields] == mirror._fields_


def test_build_digest_sees_included_headers(tmp_path):
    """Editing a header of csrc/ changes the digest (the library's name)
    of every source that includes it, and of no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda_lib.CSRC, csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    before = {n: _cuda_lib.source_digest(csrc / f"{n}.cu") for n in names}
    for n in names:
        assert before[n] == _cuda_lib.source_digest(_cuda_lib.CSRC / f"{n}.cu")
    header = csrc / "sm90_common.cuh"
    users = {n for n in names
             if header in _cuda_lib.local_includes(csrc / f"{n}.cu")}
    assert users == {"heom_coupling", "liouvillian"}
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _cuda_lib.source_digest(csrc / f"{n}.cu") for n in names}
    for n in names:
        assert (after[n] != before[n]) == (n in users)
    assert _cuda_lib.source_digest(csrc / "spo.cu", flags=("-O2",)) != \
        after["spo"]


# ------------------------------------------------- the edge-major plan
def plan_case(case):
    """A hierarchy (the dict of :func:`hierarchy`) for the plan tests."""
    if case == "small":
        return hierarchy()
    if case == "nado1":
        return hierarchy(M=2, lmax=0)
    if case == "isolated":
        # some ADOs keep no neighbour: their rows of both maps are cut
        h = hierarchy(M=3, lmax=3, seed=3)
        nado = h["keys"].shape[0]
        for d in (0, 4, nado - 1):
            h["plus_idx"][d] = nado
            h["minus_idx"][d] = nado
        return h
    assert case == "fmo"
    sol = FMO().heom(temperature=300.0, lmax=3, nexp=1,
                     decomposition="pade", device="cpu")
    keys, plus_idx, minus_idx, Q, c, nu = sol._build(torch.complex128)
    return dict(H=sol._H_np, Q=Q, c=c, nu=nu, keys=keys, plus_idx=plus_idx,
                minus_idx=minus_idx, rng=np.random.default_rng(8))


PLAN_CASES = ["fmo", "small", "isolated", "nado1"]


def plan_walk(F, OpT, plan):
    """Plain walk of a plan in the order of csrc/heom_coupling.cu: the
    partial row of every edge, tile by tile, then each destination's sum
    of its partials in the plan's order, starting from zero."""
    nado, V = F.shape
    partial = F.new_empty((plan.nedges, V))
    for j, e0, cnt in plan.tiles.tolist():
        e = slice(e0, e0 + cnt)
        partial[plan.slot[e].long()] = (
            (F[plan.src[e].long()] @ OpT[j]) * plan.w[e, None])
    ptr = plan.dst_ptr.long()
    deg = ptr[1:] - ptr[:-1]
    out = F.new_zeros((nado, V))
    for q in range(int(deg.max()) if nado and plan.nedges else 0):
        has = deg > q
        out[has] += partial[ptr[:-1][has] + q]
    return out


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_walk_matches_coupling_ref(case):
    """The kernel's arithmetic (a partial row per edge, then each
    destination's sum in the plan's order), walked in plain torch from the
    plan, equals the gather-and-contract plain version."""
    h = plan_case(case)
    _, OpT, nbr, w = kn.heom_coupling_operands(
        h["H"], h["Q"], h["c"], h["keys"], h["plus_idx"], h["minus_idx"])
    F = t(crand(h["rng"], h["keys"].shape[0], OpT.shape[-1]))
    plan = kn.heom_coupling_plan(t(nbr), t(w))
    out = plan_walk(F, t(OpT), plan)
    ref = kn.heom_coupling_ref(F, t(nbr), t(w), t(OpT))
    if case == "nado1":
        assert plan.nedges == 0 and not out.abs().any() and not ref.abs().any()
    else:
        assert rel_err(out.numpy(), ref.numpy()) < RTOL


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_walk_plus_local_matches_jax(case):
    """flat @ C − damp·flat + the plan walk == the JAX stacked RHS."""
    h = plan_case(case)
    n = h["H"].shape[0]
    ados = crand(h["rng"], h["keys"].shape[0], n, n)
    ref, (_, _, damp, flat, _) = jax_dot_reference(h, ados)
    C, OpT, nbr, w = kn.heom_coupling_operands(
        h["H"], h["Q"], h["c"], h["keys"], h["plus_idx"], h["minus_idx"])
    F = t(flat)
    out = F @ t(C) - t(damp)[:, None] * F + plan_walk(
        F, t(OpT), kn.heom_coupling_plan(t(nbr), t(w)))
    assert rel_err(out.numpy(), ref) < RTOL


def dest_walk(F, OpT, nbr, w):
    """Plain walk of the destination-major kernel of
    csrc/heom_coupling.cu on F (nado, B, V): for every destination, its
    edges in ascending j, the weight on the source rows, all into one
    accumulator from zero (the destinations side by side)."""
    nado, nj = nbr.shape
    acc = F.new_zeros(F.shape)
    for j in range(nj):
        has = nbr[:, j] >= 0
        src = nbr[has, j].long()
        acc[has] += (w[has, j, None, None] * F[src]) @ OpT[j]
    return acc


@pytest.mark.parametrize("B", [1, 3, 33])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_dest_walk_matches_coupling_ref(case, B):
    """The destination-major kernel's arithmetic, walked in plain torch,
    equals the gather-and-contract plain version on a batch of B."""
    h = plan_case(case)
    _, OpT, nbr, w = (t(x) for x in kn.heom_coupling_operands(
        h["H"], h["Q"], h["c"], h["keys"], h["plus_idx"], h["minus_idx"]))
    F = t(crand(h["rng"], nbr.shape[0], B, OpT.shape[-1]))
    out = dest_walk(F, OpT, nbr, w)
    ref = kn.heom_coupling_ref(F, nbr, w, OpT)
    if case == "nado1":
        assert not out.abs().any() and not ref.abs().any()
    else:
        assert rel_err(out.numpy(), ref.numpy()) < RTOL


@pytest.mark.parametrize("case", PLAN_CASES)
def test_dest_walk_plus_local_matches_jax(case):
    """flat @ C − damp·flat + the destination-major walk, on a batch of
    two hierarchies, == the JAX stacked RHS of each."""
    h = plan_case(case)
    n = h["H"].shape[0]
    nado = h["keys"].shape[0]
    ados = crand(h["rng"], 2, nado, n, n)
    refs, flats = [], []
    for b in range(2):
        ref, (_, _, damp, flat, _) = jax_dot_reference(h, ados[b])
        refs.append(ref)
        flats.append(flat)
    C, OpT, nbr, w = (t(x) for x in kn.heom_coupling_operands(
        h["H"], h["Q"], h["c"], h["keys"], h["plus_idx"], h["minus_idx"]))
    F = t(np.stack(flats, axis=1))                     # (nado, 2, V)
    out = F @ C - t(damp)[:, None, None] * F + dest_walk(F, OpT, nbr, w)
    assert rel_err(out.numpy(), np.stack(refs, axis=1)) < RTOL


def test_coupling_design_by_batch():
    """An unbatched F and batches below COUPLING_BATCH_MIN take the
    edge-major kernel, larger batches the destination-major one; on the
    CPU both give the plain version and launch nothing."""
    h = plan_case("small")
    _, OpT, nbr, w = (t(x) for x in kn.heom_coupling_operands(
        h["H"], h["Q"], h["c"], h["keys"], h["plus_idx"], h["minus_idx"]))
    nado, V = nbr.shape[0], OpT.shape[-1]
    assert set(kn.COUPLING_BATCH_MIN) == {torch.complex128, torch.complex64}
    bmin = kn.COUPLING_BATCH_MIN[torch.complex128]
    assert bmin > 1
    assert not kn.coupling_batched(torch.zeros((nado, V), dtype=OpT.dtype))
    for B, batched in ((1, False), (bmin - 1, False), (bmin, True),
                       (bmin + 3, True)):
        F = t(crand(h["rng"], nado, B, V))
        assert kn.coupling_batched(F) == batched
        kn.heom_coupling.launches = kn.heom_coupling.batched_launches = 0
        torch.testing.assert_close(
            kn.heom_coupling(F, nbr, w, OpT,
                             plan=kn.heom_coupling_plan(nbr, w)),
            kn.heom_coupling_ref(F, nbr, w, OpT), rtol=0, atol=0)
        assert kn.heom_coupling.launches == kn.heom_coupling.batched_launches \
            == 0


def test_plan_layout():
    """Tiles hold at most COUPLING_TILE_EDGES edges of one j and cover the
    j-sorted edges in order; each destination's partial rows are
    consecutive and hold its own edges in ascending j; weights and sources
    are those of nbr and w."""
    h = plan_case("isolated")
    _, _, nbr, w = kn.heom_coupling_operands(
        h["H"], h["Q"], h["c"], h["keys"], h["plus_idx"], h["minus_idx"])
    plan = kn.heom_coupling_plan(t(nbr), t(w).float())
    assert plan.w.dtype == torch.float32
    tiles = plan.tiles.numpy()
    assert np.all((tiles[:, 2] >= 1)
                  & (tiles[:, 2] <= kn.COUPLING_TILE_EDGES))
    np.testing.assert_array_equal(tiles[1:, 1], np.cumsum(tiles[:-1, 2]))
    assert tiles[:, 2].sum() == plan.nedges == int((nbr >= 0).sum())
    assert np.all(np.diff(tiles[:, 0]) >= 0)
    edge_j = np.repeat(tiles[:, 0], tiles[:, 2])
    ptr, slot = plan.dst_ptr.numpy(), plan.slot.numpy()
    np.testing.assert_array_equal(np.sort(slot), np.arange(plan.nedges))
    for d in range(nbr.shape[0]):
        e = np.argsort(slot)[ptr[d]:ptr[d + 1]]   # d's rows, in order
        js = np.flatnonzero(nbr[d] >= 0)
        np.testing.assert_array_equal(edge_j[e], js)
        np.testing.assert_array_equal(plan.src.numpy()[e], nbr[d, js])
        np.testing.assert_array_equal(plan.w.numpy()[e], w[d, js])
        np.testing.assert_array_equal(plan.dst.numpy()[e], d)
    assert ptr[1] == ptr[0] and ptr[5] == ptr[4]    # cut rows 0 and 4
    assert plan.edgeless and not plan.arrived.any()
    assert plan.arrived.shape == (nbr.shape[0],)
    full = plan_case("small")
    _, _, nbr, w = kn.heom_coupling_operands(
        full["H"], full["Q"], full["c"], full["keys"], full["plus_idx"],
        full["minus_idx"])
    assert not kn.heom_coupling_plan(t(nbr), t(w)).edgeless


def test_wrapper_takes_the_plan_of_its_own_operands():
    """With the plan of its nbr and w the wrapper gives the plain result;
    a plan of another hierarchy of the same size (nado, nj and V), of a
    copy of nbr, or of nbr changed in place since, is refused on any
    device."""
    h, other = plan_case("small"), plan_case("isolated")
    _, OpT, nbr, w = (t(x) for x in kn.heom_coupling_operands(
        h["H"], h["Q"], h["c"], h["keys"], h["plus_idx"], h["minus_idx"]))
    _, OpT2, nbr2, w2 = (t(x) for x in kn.heom_coupling_operands(
        other["H"], other["Q"], other["c"], other["keys"], other["plus_idx"],
        other["minus_idx"]))
    assert nbr.shape == nbr2.shape and OpT.shape == OpT2.shape
    assert not torch.equal(nbr, nbr2)
    F = t(crand(h["rng"], *nbr.shape[:1], OpT.shape[-1]))
    plan = kn.heom_coupling_plan(nbr, w)
    torch.testing.assert_close(kn.heom_coupling(F, nbr, w, OpT, plan=plan),
                               kn.heom_coupling_ref(F, nbr, w, OpT),
                               rtol=0, atol=0)
    for bad in (kn.heom_coupling_plan(nbr2, w2),
                kn.heom_coupling_plan(nbr.clone(), w),
                kn.heom_coupling_plan(nbr, w.clone())):
        with pytest.raises(ValueError, match="plan"):
            kn.heom_coupling(F, nbr, w, OpT, plan=bad)
    nbr[0, 0] = nbr[0, 0].item()          # an in-place write, same values
    with pytest.raises(ValueError, match="plan"):
        kn.heom_coupling(F, nbr, w, OpT, plan=plan)


@pytest.mark.parametrize("case", ["real F", "OpT dtype", "shape"])
def test_wrapper_with_a_plan_rejects_bad_operands(case):
    """F and OpT are checked on every call, a plan given or not."""
    (F, nbr, w, OpT), exc = _bad_args(case)
    plan = kn.heom_coupling_plan(nbr, w)
    with pytest.raises(exc):
        kn.heom_coupling(F, nbr, w, OpT, plan=plan)


@pytest.mark.parametrize("case", ["w precision", "nbr int64", "noncontiguous",
                                  "meta device", "out of range"])
def test_plan_rejects_bad_graphs(case):
    """nbr and w are checked when the plan is built: dtypes, shapes,
    devices, layout, and every index of nbr in [-1, nado)."""
    if case == "out of range":
        _, nbr, w, _ = coupling_args()
        nbr = nbr.clone()
        nbr[1, 0] = nbr.shape[0]
        exc = ValueError
    elif case == "w precision":
        _, nbr, w, _ = coupling_args()
        w, exc = w.to(torch.float16), TypeError
    else:
        (_, nbr, w, _), exc = _bad_args(case)
    with pytest.raises(exc):
        kn.heom_coupling_plan(nbr, w)

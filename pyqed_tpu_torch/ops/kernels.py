"""HEOM right-hand-side operators, the split-operator step, the
Liouvillian matvec, and their hand-written CUDA kernels.

PyTorch counterpart of ``pyqed_tpu/ops/pallas_kernels.py`` §(a) HEOM,
§(b) split operator and §(c) Liouvillian matvec. The split-operator part
holds :func:`spo_phase_multiply` and :func:`spo_potential_apply`, the
wrappers of ``csrc/spo.cu``; the Liouvillian part (at the end of this
module) holds :func:`liouvillian_commutator`, the wrapper of
``csrc/liouvillian.cu``, and :func:`liouvillian_matvec`. Each wrapper has
its plain version beside it.

HEOM (reference semantics: pyqed/heom/deom.py:641-673 ``rem_cal``). With
row-major vec(), left(A) = A ⊗ I and right(A) = I ⊗ Aᵀ act on vec(ρ), and
the HEOM right-hand side of ADO ρ_N is

    vec(ρ_N) C − damp_N vec(ρ_N)
      + Σ_m vec(ρ_{N+e_m}) P_mᵀ + Σ_m n_m vec(ρ_{N−e_m}) D_mᵀ

with C = (−i(left(H) − right(H)))ᵀ, P_m = −i left(Q_m) + i right(Q_m) and
D_m = −i c_m left(Q_m) + i c_m* right(Q_m).

Contents:

- the destination rows of a sharded right-hand side: :func:`rhs_rows`,
  :func:`dest_rows`;
- host builders (NumPy): :func:`heom_superop_matrix`,
  :func:`heom_superop_split`, :func:`heom_q_projector_sites`,
  :func:`heom_level_structure`, :func:`heom_level_blocks`,
  :func:`heom_coupling_operands`;
- torch right-hand sides: :func:`heom_rhs_dot` (``matmul``),
  :func:`heom_rhs_rowcol_factory` (``rowcol``),
  :func:`heom_rhs_levels_xla_factory` (``levels``) and
  :func:`heom_rhs_coupling_factory` (``cuda``);
- the coupling kernel: its wrapper :func:`heom_coupling`, the host plan
  it launches from (:func:`heom_coupling_plan`) and two plain versions,
  :func:`level_coupling` (the level-blocked form of the TPU kernel) and
  :func:`heom_coupling_ref` (the index form the CUDA kernel computes);
- the split-operator kernels: :func:`spo_phase_multiply` and
  :func:`spo_potential_apply`, with plain versions
  :func:`spo_phase_multiply_ref` and :func:`spo_potential_apply_ref`;
- the Liouvillian commutator kernel :func:`liouvillian_commutator`, its
  plain version :func:`liouvillian_commutator_ref`, and the matrix-free
  Lindblad right-hand side :func:`liouvillian_matvec` built on it.

The TPU workarounds of the JAX module are not carried over: operands stay
complex (no real/imag planes), and nothing is padded to 8 rows or 128
lanes (HEOM), to tiles of 512 or 256 grid points (SPO) or to multiples
of 128 (the commutator). The hierarchy
enumeration is level-graded, so without padding the level layout is the
compact ``(nado, n·n)`` layout itself.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..config import real_dtype_of, resolve_device
from ..core.diagnostics import span


def to_tensor(a, dtype, device):
    """A host (NumPy) operand as a contiguous tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def damp_tensor(damp, dtype, device):
    """(nado,) damping rates: real unless a bath rate is complex."""
    damp = np.asarray(damp)
    if np.iscomplexobj(damp) and np.any(damp.imag != 0):
        return to_tensor(damp, dtype, device)
    return to_tensor(np.real(damp), real_dtype_of(dtype), device)


def dest_rows(a, rows, fill):
    """Rows [lo, hi) of a per-destination host array ``a`` (``rows`` =
    (lo, hi)), padded with ``fill`` past its end: the operands of a
    sharded right-hand side, whose last rank's destinations may run past
    the hierarchy (padding ADOs, which have no edges and stay zero)."""
    a = np.asarray(a)
    lo, hi = rows
    part = a[lo:min(hi, a.shape[0])]
    if part.shape[0] < hi - lo:
        part = np.concatenate([part, np.full(
            (hi - lo - part.shape[0],) + a.shape[1:], fill, a.dtype)])
    return part


def rhs_rows(nado, rows, nsrc):
    """(lo, hi, nsrc) of a right-hand side: its destinations [lo, hi)
    (default the whole hierarchy) and the rows of the source stack it is
    called on (default nado; a sharded run's gathered stack, padded to a
    multiple of the ranks, has more)."""
    lo, hi = (0, nado) if rows is None else (int(rows[0]), int(rows[1]))
    nsrc = nado if nsrc is None else int(nsrc)
    if not (0 <= lo <= hi <= nsrc and nsrc >= nado):
        raise ValueError(f"destination rows [{lo}, {hi}) and a source "
                         f"stack of {nsrc} rows do not fit a hierarchy of "
                         f"{nado} ADOs")
    return lo, hi, nsrc


# =====================================================================
# host builders
# =====================================================================

def heom_superop_matrix(H, Q, c):
    """Stacked HEOM superoperator B = [C | P_0 … P_{M−1} | D_0 … D_{M−1}]
    of shape (V, (2M+1)V), with C = −i(left(H) − right(H)) (NumPy)."""
    H = np.asarray(H)
    Q = np.asarray(Q)
    c = np.asarray(c)
    n = H.shape[-1]
    eye = np.eye(n)
    left = lambda a: np.kron(a, eye)
    right = lambda a: np.kron(eye, a.T)
    blocks = [-1j * (left(H) - right(H))]
    for m in range(Q.shape[0]):
        blocks.append(-1j * left(Q[m]) + 1j * right(Q[m]))
    for m in range(Q.shape[0]):
        blocks.append(-1j * c[m] * left(Q[m])
                      + 1j * np.conj(c[m]) * right(Q[m]))
    return np.concatenate(blocks, axis=1)


def heom_superop_split(H, Q, c):
    """(B0, Bk) blocks of :func:`heom_superop_matrix`: B0 = C (V, V) acts
    on the ADO itself, Bk (V, 2M, V) on the [plus; minus] neighbours."""
    B = heom_superop_matrix(H, Q, c)
    V = B.shape[0]
    return B[:, :V].copy(), B[:, V:].reshape(V, -1, V).copy()


def heom_q_projector_sites(Q, tol=0.0):
    """Sites s(m) if every coupling operator Q_m is a site projector
    e_s e_sᵀ, else None."""
    Q = np.asarray(Q)
    sites = np.empty(Q.shape[0], np.int32)
    for m, q in enumerate(Q):
        s = int(np.argmax(np.abs(np.diagonal(q))))
        e = np.zeros_like(q)
        e[s, s] = 1.0
        if not np.allclose(q, e, atol=tol if tol else 1e-14):
            return None
        sites[m] = s
    return sites


def heom_level_structure(keys):
    """(sizes, offs): ADO count and first row of each hierarchy level.
    The keys must be level-graded, as :func:`enumerate_hierarchy`
    returns them."""
    levels = np.asarray(keys).sum(axis=1)
    if not np.all(np.diff(levels) >= 0):
        raise ValueError("hierarchy keys must be level-graded")
    sizes = [int((levels == l).sum()) for l in range(int(levels.max()) + 1)]
    offs = [0] + [int(o) for o in np.cumsum(sizes)[:-1]]
    return sizes, offs


def heom_level_blocks(H, Q, c, keys, plus_idx, minus_idx):
    """Level-blocked operands of the coupling (NumPy, unpadded).

    Returns a dict with
      C      (V, V) complex     — (−i(left(H) − right(H)))ᵀ
      Pt     (M, V, V) complex  — P_mᵀ
      Dt     (M, V, V) complex  — D_mᵀ (c_m folded in)
      Splus  for l = 0..L−1, (M, n_l, n_{l+1}) one-hot selections
      Sminus for l = 1..L,   (M, n_l, n_{l−1}) selections weighted n_m
      structure (sizes, offs), V, M.
    """
    H = np.asarray(H)
    Q = np.asarray(Q)
    c = np.asarray(c)
    keys = np.asarray(keys)
    nado = keys.shape[0]
    n = H.shape[-1]
    M = Q.shape[0]
    eye = np.eye(n)
    left = lambda a: np.kron(a, eye)
    right = lambda a: np.kron(eye, a.T)
    C = (-1j * (left(H) - right(H))).T
    Pt = np.stack([(-1j * left(Q[m]) + 1j * right(Q[m])).T
                   for m in range(M)])
    Dt = np.stack([(-1j * c[m] * left(Q[m])
                    + 1j * np.conj(c[m]) * right(Q[m])).T
                   for m in range(M)])
    sizes, offs = heom_level_structure(keys)
    L = len(sizes) - 1
    Splus, Sminus = [], []
    for l in range(L):                  # dest level l, src level l+1
        S = np.zeros((M, sizes[l], sizes[l + 1]))
        rows = np.arange(offs[l], offs[l] + sizes[l])
        for m in range(M):
            j = plus_idx[rows, m]
            ok = j < nado
            S[m, rows[ok] - offs[l], j[ok] - offs[l + 1]] = 1.0
        Splus.append(S)
    for l in range(1, L + 1):           # dest level l, src level l-1
        S = np.zeros((M, sizes[l], sizes[l - 1]))
        rows = np.arange(offs[l], offs[l] + sizes[l])
        for m in range(M):
            j = minus_idx[rows, m]
            ok = (j < nado) & (keys[rows, m] > 0)
            S[m, rows[ok] - offs[l], j[ok] - offs[l - 1]] = keys[rows[ok], m]
        Sminus.append(S)
    return dict(C=C, Pt=Pt, Dt=Dt, Splus=Splus, Sminus=Sminus,
                structure=(sizes, offs), V=n * n, M=M)


def heom_coupling_operands(H, Q, c, keys, plus_idx, minus_idx):
    """Operands of the index-form coupling (NumPy).

    Returns (C, OpT, nbr, w):
      C   (V, V) complex        — local superoperator, row convention
      OpT (2M, V, V) complex    — [P_0ᵀ … P_{M−1}ᵀ ; D_0ᵀ … D_{M−1}ᵀ]
      nbr (nado, 2M) int32      — [plus_idx | minus_idx], −1 for none
      w   (nado, 2M) float64    — 1 on the plus side, n_m on the minus side
    """
    keys = np.asarray(keys)
    nado = keys.shape[0]
    B0, Bk = heom_superop_split(H, Q, c)
    nbr = np.concatenate([plus_idx, minus_idx], axis=1).astype(np.int32)
    nbr[nbr >= nado] = -1
    w = np.concatenate([np.ones_like(keys), keys], axis=1).astype(np.float64)
    return B0.T.copy(), Bk.transpose(1, 2, 0).copy(), nbr, w


# =====================================================================
# torch right-hand sides
# =====================================================================

def heom_rhs_dot(B0, Bk, damp, flat, g):
    """Stacked-superoperator RHS on the gathered neighbour stack:
    out[N, a] = Σ_b B0[a, b] flat[N, b] + Σ_{k,b} Bk[a, k, b] g[N, k, b]
    − damp[N] flat[N, a]. A batch axis may follow N: flat (N, B, V), g
    (N, K, B, V)."""
    out = torch.einsum("N...b, ab -> N...a", flat, B0)
    out = out + torch.einsum("Nk...b, akb -> N...a", g, Bk)
    return out - damp.view((-1,) + (1,) * (flat.dim() - 1)) * flat


def heom_rhs_rowcol_factory(H, Q, c, nu, keys, plus_idx, minus_idx, *,
                            dtype=torch.complex128, device=None, rows=None,
                            nsrc=None):
    """Row/column HEOM RHS for site-projector couplings Q_m = e_s e_sᵀ.

    left(Q_m) touches only row s and right(Q_m) only column s, so the
    coupling gathers one row and one column of each neighbour ADO
    instead of its whole (n, n) plane:

        out_N += −i Σ_m [ρ_{N+m}[s, :] + n_m c_m ρ_{N−m}[s, :]]   at row s
        out_N += +i Σ_m [ρ_{N+m}[:, s] + n_m c_m* ρ_{N−m}[:, s]]  at col s

    plus −i[H, ρ_N] − damp_N ρ_N. Returns ``rhs(ados)`` for ados
    (nado, n, n) or a batch (nado, B, n, n), its operands on ``device``
    (the card when None; raises without one). With ``rows`` = (lo, hi)
    and ``nsrc`` (:func:`rhs_rows`) the closure takes a stack of nsrc ADOs
    and returns the rows [lo, hi) of the right-hand side only.
    """
    device = resolve_device(device)
    sites = heom_q_projector_sites(Q)
    if sites is None:
        raise ValueError("rowcol kernel needs site-projector couplings")
    H = np.asarray(H)
    keys = np.asarray(keys)
    nado, M = keys.shape
    lo, hi, nsrc = rhs_rows(nado, rows, nsrc)
    nd = hi - lo
    n = H.shape[0]
    s_list, sidx = np.unique(sites, return_inverse=True)
    nq = len(s_list)
    c = np.asarray(c)
    kf = dest_rows(keys.astype(np.float64), (lo, hi), 0.0)
    # gather indices into the (nsrc+1)·nq stacked rows/columns; row nsrc
    # of the padded stack is zero and stands for a missing neighbour

    def gather_index(idx):
        idx = np.where(np.asarray(idx) >= nado, nsrc, idx)
        idx = dest_rows(idx, (lo, hi), nsrc)
        return to_tensor((idx * nq + sidx[None, :]).reshape(-1), torch.long,
                         device)

    idx_p, idx_m = gather_index(plus_idx), gather_index(minus_idx)
    s_t = to_tensor(s_list, torch.long, device)
    E = np.zeros((n, nq))
    E[s_list, np.arange(nq)] = 1.0          # slot -> row/col position
    G = np.zeros((M, nq))
    G[np.arange(M), sidx] = 1.0             # mode -> slot
    E_t, G_t = to_tensor(E, dtype, device), to_tensor(G, dtype, device)
    w_row = to_tensor(kf * c[None, :], dtype, device)[..., None]
    w_col = to_tensor(kf * np.conj(c)[None, :], dtype, device)[..., None]
    H_t = to_tensor(H, dtype, device)
    damp = damp_tensor(dest_rows(keys.astype(np.complex128) @ np.asarray(
        nu, np.complex128), (lo, hi), 0), dtype, device)

    def rhs(ados):
        batch = tuple(ados.shape[1:-2])         # () or (B,)
        ones = (1,) * len(batch)
        padded = torch.cat([ados, ados.new_zeros((1,) + ados.shape[1:])])
        # rows/columns s of every ADO, (nsrc + 1)·nq of them, batch inside
        rows = padded[..., s_t, :].movedim(-2, 1).reshape(
            ((nsrc + 1) * nq,) + batch + (n,))
        cols = padded[..., :, s_t].movedim(-1, 1).reshape(
            ((nsrc + 1) * nq,) + batch + (n,))
        gp_r = rows[idx_p].reshape((nd, M) + batch + (n,))
        gm_r = rows[idx_m].reshape((nd, M) + batch + (n,))
        gp_c = cols[idx_p].reshape((nd, M) + batch + (n,))
        gm_c = cols[idx_m].reshape((nd, M) + batch + (n,))
        wr = w_row.view((nd, M) + ones + (1,))
        wc = w_col.view((nd, M) + ones + (1,))
        row_acc = torch.einsum("Nm...x, mq -> Nq...x", gp_r + wr * gm_r, G_t)
        col_acc = torch.einsum("Nm...x, mq -> Nq...x", gp_c + wc * gm_c, G_t)
        out = -1j * (torch.einsum("aq, Nq...x -> N...ax", E_t, row_acc)
                     - torch.einsum("xq, Nq...a -> N...ax", E_t, col_acc))
        own = ados[lo:hi]
        out = out - 1j * (H_t @ own - own @ H_t)
        return out - damp.view((nd,) + ones + (1, 1)) * own

    return rhs


def heom_rhs_levels_xla_factory(H, Q, c, nu, keys, plus_idx, minus_idx, *,
                                dtype=torch.complex128, device=None,
                                rows=None, nsrc=None):
    """Order-aware level-blocked HEOM RHS in plain torch (the name is the
    JAX package's, where this form runs through XLA).

    Each (direction, level) pair contracts in the FLOP-optimal order:
    plus (source level l+1 larger than destination l) selects first,
    Y = S_fold @ F_{l+1}, then Σ_k Y_k @ P_kᵀ; minus (source smaller)
    transforms first, Z_k = F_{l−1} @ D_kᵀ, then Σ_k S_k @ Z_k.

    Unlike the JAX form, which keeps only Re(keys @ nu), complex bath
    rates enter the damping in full. Returns ``rhs(ados)`` for ados
    (nado, n, n) or a batch (nado, B, n, n), its operands on ``device``
    (the card when None; raises without one). With ``rows`` = (lo, hi)
    and ``nsrc`` (:func:`rhs_rows`) the closure takes a stack of nsrc ADOs
    and returns the rows [lo, hi) of the right-hand side only: each level
    keeps the rows of its selections that fall in the range.
    """
    device = resolve_device(device)
    blocks = heom_level_blocks(H, Q, c, keys, plus_idx, minus_idx)
    sizes, offs = blocks["structure"]
    V, M = blocks["V"], blocks["M"]
    n = int(round(np.sqrt(V)))
    L = len(sizes) - 1
    keys = np.asarray(keys)
    nado = keys.shape[0]
    lo, hi, nsrc = rhs_rows(nado, rows, nsrc)
    nd = hi - lo
    # each level's destinations in [lo, hi): rows [a, b) of the level
    sel = [(min(max(lo - o, 0), sz), min(max(hi - o, 0), sz))
           for o, sz in zip(offs, sizes)]
    C = to_tensor(blocks["C"], dtype, device)
    Pt = to_tensor(blocks["Pt"], dtype, device)
    Dt = to_tensor(blocks["Dt"], dtype, device)
    damp = damp_tensor(dest_rows(keys @ np.asarray(nu), (lo, hi), 0), dtype,
                       device)
    Spf = [to_tensor(S[:, a:b].reshape(-1, S.shape[-1]), dtype, device)
           for S, (a, b) in zip(blocks["Splus"], sel)]
    Smb = [to_tensor(S[:, a:b], dtype, device)
           for S, (a, b) in zip(blocks["Sminus"], sel[1:])]
    npad = nd - sum(b - a for a, b in sel)     # destinations past nado

    def rhs(ados):
        batch = tuple(ados.shape[1:-2])         # () or (B,)
        flat = ados.reshape((nsrc,) + batch + (V,))
        own = flat[lo:hi]
        out = own @ C - damp.view((nd,) + (1,) * (len(batch) + 1)) * own
        plus = []
        for l in range(L):                  # dest l, src l+1
            src = flat[offs[l + 1]:offs[l + 1] + sizes[l + 1]]
            y = (Spf[l] @ src.reshape(sizes[l + 1], -1)).reshape(
                (M, sel[l][1] - sel[l][0]) + batch + (V,))
            plus.append(torch.einsum("kd...v, kvw -> d...w", y, Pt))
        plus.append(flat.new_zeros((sel[L][1] - sel[L][0] + npad,) + batch
                                   + (V,)))
        minus = [flat.new_zeros((sel[0][1] - sel[0][0],) + batch + (V,))]
        for l in range(1, L + 1):           # dest l, src l-1
            src = flat[offs[l - 1]:offs[l - 1] + sizes[l - 1]]
            z = torch.einsum("s...v, kvw -> ks...w", src, Dt)
            minus.append(torch.einsum("kds, ks...w -> d...w", Smb[l - 1], z))
        minus.append(flat.new_zeros((npad,) + batch + (V,)))
        out = out + torch.cat(plus) + torch.cat(minus)
        return out.reshape((nd,) + tuple(ados.shape[1:]))

    return rhs


# =====================================================================
# the coupling kernel
# =====================================================================

def level_coupling(S, OpT, F_src, select_first=False):
    """Plain version of the TPU kernel's unit of work
    (``pallas_kernels._level_coupling_call``) for one (direction,
    destination level), with dense selections:

      select_first=False:  out = Σ_k S_k @ (F_src @ OpT_k)
      select_first=True:   out = Σ_k (S_k @ F_src) @ OpT_k

    S (M, n_dest, n_src) real, OpT (M, V, V) complex, F_src (n_src, V)
    complex; returns (n_dest, V)."""
    S = S.to(F_src.dtype)
    if select_first:
        y = torch.einsum("kds, sv -> kdv", S, F_src)
        return torch.einsum("kdv, kvw -> dw", y, OpT)
    z = torch.einsum("sv, kvw -> ksw", F_src, OpT)
    return torch.einsum("kds, ksw -> dw", S, z)


def heom_coupling_ref(F, nbr, w, OpT):
    """Plain version of :func:`heom_coupling`: gather, weight, contract.

    out[d] = Σ_j w[d, j] F[nbr[d, j]] @ OpT[j]; a −1 in ``nbr`` picks the
    zero row appended to F. F (nsrc, V), or (nsrc, B, V) for a batch:
    out[d, b] = Σ_j w[d, j] F[nbr[d, j], b] @ OpT[j]; nbr and w are
    (nd, nj), one row per destination, and out is (nd, ...): the sources
    may be more than the destinations (a sharded hierarchy's gathered
    stack against one rank's destinations)."""
    padded = torch.cat([F, F.new_zeros((1,) + F.shape[1:])])
    wb = w.view(w.shape + (1,) * (F.dim() - 1))
    g = padded[nbr.long()] * wb                   # (nado, nj, [B,] V)
    return torch.einsum("dj...a, jab -> d...b", g, OpT)


# edges per tile of the edge-major kernel (kRows in csrc/heom_coupling.cu)
COUPLING_TILE_EDGES = 16
# the batch B from which heom_coupling takes the destination-major kernel,
# by F's dtype: below it the edge-major kernel is faster on an H100
# (chip_smoke.py times both at B = 1, 2, 7, 16, 32 and 256; PERF.md)
COUPLING_BATCH_MIN = {torch.complex128: 16, torch.complex64: 32}


@dataclasses.dataclass(frozen=True, eq=False)
class CouplingPlan:
    """The hierarchy's edges in the order the coupling kernel walks them
    (:func:`heom_coupling_plan`). An edge (d, j) with s = nbr[d, j] >= 0
    adds w[d, j] F[s] @ OpT[j] to out[d].

    A plan is bound to the ``nbr`` and ``w`` tensors it was built from
    (``operands``) as they were then (their ``_version`` counters are
    ``versions``): :func:`heom_coupling` takes it only with these two,
    unchanged. The int32 arrays are views of one buffer, ``ints``, which
    the edge-major kernel takes as one pointer. ``arrived`` is that
    kernel's per-destination count of finished edges, zero between calls,
    and ``launch_args`` keeps, for each (V, B, design), what a launch
    takes that does not change between calls, with the edge-major
    design's partials buffer: a plan serves one stream at a time. The
    destination-major kernel reads ``operands`` (nbr and w) as they
    are."""
    operands: tuple         # (nbr, w) as given to heom_coupling_plan
    versions: tuple         # their _version counters at the build
    ints: torch.Tensor      # tiles | src | dst | slot | dst_ptr | arrived
    tiles: torch.Tensor     # (ntiles, 3): j, first edge, edge count
    src: torch.Tensor       # (edges,): source ADO, edges sorted by j
    dst: torch.Tensor       # (edges,): the edge's destination ADO
    slot: torch.Tensor      # (edges,): the edge's partial row
    dst_ptr: torch.Tensor   # (nado + 1,): d's partial rows are dst_ptr[d]
    #                         .. dst_ptr[d + 1] - 1, in ascending j
    arrived: torch.Tensor   # (nado,), zero between calls
    w: torch.Tensor         # (edges,) real: the edge's weight
    edgeless: bool          # some destination has no edge (its row is 0)
    nsrc: int               # rows of the source stack F the plan indexes
    launch_args: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def nedges(self):
        return self.src.shape[0]

    @property
    def nd(self):
        return self.dst_ptr.shape[0] - 1


def heom_coupling_plan(nbr, w, nsrc=None):
    """Edge-major plan of :func:`heom_coupling` for the hierarchy ``nbr``
    ((nd, nj) int32: row d holds destination d's sources, rows of a stack
    of ``nsrc`` (default nd) ADOs, −1: no neighbour) and its weights ``w``
    ((nd, nj) float64 or float32), contiguous tensors on one device. In
    the field names below nado is nd, the destinations. Both are
    checked here, once per right-hand side
    (:func:`heom_rhs_coupling_factory`); the plan is built on the host
    from copies of them, and its tensors lie on their device.

    The edges are sorted by j (for a fixed j, d -> nbr[d, j] is one-to-one)
    and cut into tiles of at most :data:`COUPLING_TILE_EDGES` edges of one
    j: a block of the kernel stages OpT[j] once per tile and writes one
    partial row per edge, at the edge's slot. The slots put each
    destination's partials in consecutive rows, in ascending j: the block
    that finishes a destination's last edge sums them in that order.
    Each build is counted in ``heom_coupling_plan.builds``."""
    _check_graph(nbr, w)
    heom_coupling_plan.builds += 1
    device, versions = nbr.device, (nbr._version, w._version)
    operands = (nbr, w)
    nbr, w = nbr.cpu().numpy(), w.cpu().numpy()
    nado, nj = nbr.shape
    nsrc = nado if nsrc is None else int(nsrc)
    if nbr.size and not (nbr.min() >= -1 and nbr.max() < nsrc):
        raise ValueError(f"heom_coupling: nbr holds an index outside "
                         f"[-1, {nsrc})")
    jj, dd = np.nonzero(nbr.T >= 0)           # sorted by j, then by d
    counts = np.bincount(jj, minlength=nj)
    starts = np.cumsum(counts) - counts
    R = COUPLING_TILE_EDGES
    tiles = np.array([(j, starts[j] + o, min(R, counts[j] - o))
                      for j in range(nj) for o in range(0, counts[j], R)],
                     dtype=np.int32).reshape(-1, 3)
    slot = np.empty(len(dd), np.int32)
    slot[np.argsort(dd, kind="stable")] = np.arange(len(dd))  # j ascending
    deg = np.bincount(dd, minlength=nado)
    parts = [tiles.ravel(), nbr[dd, jj], dd, slot,
             np.concatenate([[0], np.cumsum(deg)]), np.zeros(nado)]
    ints = to_tensor(np.concatenate(parts).astype(np.int32), torch.int32,
                     device)
    views = dict(zip(("tiles", "src", "dst", "slot", "dst_ptr", "arrived"),
                     torch.split(ints, [len(a) for a in parts])))
    views["tiles"] = views["tiles"].view(-1, 3)
    return CouplingPlan(operands=operands, versions=versions, ints=ints,
                        **views,
                        w=to_tensor(w[dd, jj], operands[1].dtype, device),
                        edgeless=bool(np.any(deg == 0)), nsrc=nsrc)


heom_coupling_plan.builds = 0

_KERNEL_DTYPES = {torch.complex128: torch.float64,
                  torch.complex64: torch.float32}


def _check_graph(nbr, w):
    """The checks of nbr and w, made once per plan."""
    if nbr.dtype != torch.int32:
        raise TypeError(f"heom_coupling: nbr must be int32, got {nbr.dtype}")
    if w.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"heom_coupling: w must be float64 or float32, got "
                        f"{w.dtype}")
    if nbr.dim() != 2 or w.shape != nbr.shape:
        raise ValueError(f"heom_coupling: expected nbr and w (nd, nj), got "
                         f"{tuple(nbr.shape)} and {tuple(w.shape)}")
    if w.device != nbr.device:
        raise ValueError(f"heom_coupling: w is on {w.device}, nbr on "
                         f"{nbr.device}")
    if nbr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"heom_coupling: no kernel for device {nbr.device}")
    if not (nbr.is_contiguous() and w.is_contiguous()):
        raise ValueError("heom_coupling: nbr and w must be contiguous")


def _check_operands(F, OpT, nbr, w, nsrc):
    """The checks of F ((nsrc, V) or (nsrc, B, V)) and OpT against a
    checked nbr and w, made on every call."""
    rdt = _KERNEL_DTYPES.get(F.dtype)
    if rdt is None:
        raise TypeError(f"heom_coupling: F must be complex128 or complex64, "
                        f"got {F.dtype}")
    if OpT.dtype != F.dtype:
        raise TypeError(f"heom_coupling: OpT is {OpT.dtype}, F is {F.dtype}")
    if w.dtype != rdt:
        raise TypeError(f"heom_coupling: w must be {rdt}, got {w.dtype}")
    nj = nbr.shape[1]
    if (F.dim() not in (2, 3) or F.shape[0] != nsrc
            or OpT.shape != (nj, F.shape[-1], F.shape[-1])):
        raise ValueError(
            f"heom_coupling: shapes F {tuple(F.shape)}, nbr "
            f"{tuple(nbr.shape)}, w {tuple(w.shape)}, OpT "
            f"{tuple(OpT.shape)} do not agree: expected F ({nsrc}, V) or "
            f"({nsrc}, B, V), nbr and w (nd, nj), OpT (nj, V, V)")
    # nbr is on the CPU or on a card (checked with the graph)
    if not (F.is_cuda and OpT.is_cuda
            and F.get_device() == OpT.get_device() == nbr.get_device()
            if nbr.is_cuda else F.is_cpu and OpT.is_cpu):
        raise ValueError(f"heom_coupling: F is on {F.device}, OpT on "
                         f"{OpT.device}, nbr and w on {nbr.device}")
    if not (F.is_contiguous() and OpT.is_contiguous()):
        raise ValueError("heom_coupling: F and OpT must be contiguous")


def _coupling_launch_args(plan, F, V, B, batched):
    """What a launch on a plan at F's dtype, V, batch B and design takes
    that does not change between calls, made once: the C entry point, the
    launch's arguments as one struct in host memory (``PlanArgs`` or, for
    the destination-major design, ``BatchArgs`` of the source), with its
    address, and the edge-major design's partials buffer ((nedges, B, V),
    allocated here with ``torch.empty``; None for the other). The plan
    keeps all four."""
    from . import _cuda_lib
    lib = _cuda_lib.load("heom_coupling").lib
    c128 = F.dtype == torch.complex128
    if batched:
        nbr, w = plan.operands
        fn = (lib.heom_coupling_batched_c128 if c128
              else lib.heom_coupling_batched_c64)
        args = _cuda_lib.CouplingBatchArgs(
            nbr.data_ptr(), w.data_ptr(), plan.nd, nbr.shape[1], V, B)
        return fn, ctypes.addressof(args), args, None
    fn = lib.heom_coupling_c128 if c128 else lib.heom_coupling_c64
    partial = F.new_empty((plan.nedges, B, V))
    args = _cuda_lib.CouplingPlanArgs(
        plan.w.data_ptr(), plan.ints.data_ptr(), partial.data_ptr(),
        plan.nd, plan.tiles.shape[0], plan.nedges, V, B)
    return fn, ctypes.addressof(args), args, partial


def _raw_stream(index):
    """The handle of the current CUDA stream of device ``index``. It is
    read with the call PyTorch's own generated code uses, without making a
    ``torch.cuda.Stream``: that object costs a wrapper about 10 us of host
    time per launch on an H100 host (PERF.md), more than the launch."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(index).cuda_stream
    return raw(index)


def _launch_on(index, launch):
    """``launch(stream)`` with CUDA device ``index`` current and its
    current stream, switching devices only when it is not current
    already."""
    if index == torch.cuda.current_device():
        return launch(_raw_stream(index))
    with torch.cuda.device(index):
        return launch(_raw_stream(index))


def _refuse_grad(fn, *tensors):
    """Raise where autograd would need a backward through ``fn``'s CUDA
    kernel, which has none: the kernel writes its output through a raw
    pointer, so a gradient through it would be lost without a word. The
    plain version (CPU tensors) is differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{fn}: the CUDA kernel has no backward, and an input requires "
            "grad; call it under torch.no_grad() or use its plain version "
            f"({fn}_ref) to differentiate")


def heom_coupling(F, nbr, w, OpT, plan=None):
    """HEOM coupling term, out[d] = Σ_j w[d, j] F[nbr[d, j]] @ OpT[j]
    (for a batch, out[d, b] = Σ_j w[d, j] F[nbr[d, j], b] @ OpT[j]), for
    the nd destinations of nbr's rows from a stack F of nsrc sources (nsrc
    = nd for a whole hierarchy; a sharded run passes its all-gathered
    stack and its own destinations' rows, nsrc > nd).

    Replaces the level-blocked Pallas kernel of the JAX package
    (``pyqed_tpu/ops/pallas_kernels.py:681-769``). That kernel multiplies
    one-hot selection matrices because a TPU gathers poorly; each of their
    rows has one nonzero at most, so on a GPU the selection is a row
    gather, and ``csrc/heom_coupling.cu`` covers every level and both
    directions with one V×V complex row product per hierarchy edge and
    batch row, in one launch per call, by one of two designs (the notes
    are in the source, the measured times in PERF.md):

    - F (nado, V), or (nado, B, V) with B below
      :data:`COUPLING_BATCH_MIN` (16 at complex128, 32 at complex64):
      edge-major, from the :class:`CouplingPlan`. Each block stages one
      OpT[j] once for a tile of edges and writes one partial row per edge
      (and batch row) into a scratch buffer; the block that finishes a
      destination's last edge sums its partials in a fixed order. At the
      FMO flagship (680 ADOs, M = 14, V = 49; 3,360 edges × 2,401 complex
      MACs ≈ 65 MFLOP, bound 0.96 us) the HEOM step is host-bound, and
      this design keeps its launch short.
    - F (nado, B, V) with B at or above it: destination-major. A block
      owns one destination, a tile of 64 batch rows and 64 columns, walks
      the destination's edges in ascending j through a ring of
      asynchronous copies, multiplies on the FP64 tensor cores
      (complex64: FP32 FMA) and writes its outputs once: no partials
      buffer, no atomics. At the field-2DES shape (the n = 8 chain, 680
      ADOs, V = 64, B = 256) a call is 28.2 GFLOP over 357 MB, bound by
      the FP64 tensor-core rate at 0.42 ms. The edge-major design took
      3.69-3.72 ms there: FP64 FMA (never below 0.83 ms), a 1.76 GB round
      trip of partials, 1.7 waves of blocks walking 256 batch rows one
      after another, and a long summing tail.

    F (nsrc, V) or (nsrc, B, V) complex128/complex64, nbr (nd, nj) int32
    (indices below nsrc; −1: no neighbour), w (nd, nj) real of F's
    precision, OpT (nj, V, V) of F's dtype, all contiguous and on one
    device; the result is (nd, ...). ``plan`` fixes nsrc (its ``nsrc``),
    else it is F's row count. ``plan``, from
    :func:`heom_coupling_plan` on these very nbr and w tensors (the
    wrapper raises for any other, or for these changed in place since),
    is built once per right-hand side by :func:`heom_rhs_coupling_factory`:
    nbr and w are checked when it is built, F and OpT on every call.
    Without a plan nbr and w are checked here, and on CUDA a plan is built
    from them on the host, which copies them back. The edge-major design's
    partials buffer is allocated with ``torch.empty`` at a plan's first
    launch at each (V, B) and kept with it. On the CPU this is
    :func:`heom_coupling_ref`; on CUDA it launches one of the two kernels
    (counted in ``heom_coupling.launches``, one per right-hand side, so an
    RK4 run counts 4 per step; the destination-major launches also in
    ``heom_coupling.batched_launches``; a plan's launch arguments, built
    at its first launch at each (V, B, design), in
    ``heom_coupling.launch_arg_builds``) or raises; a hierarchy without
    edges (one ADO) launches nothing and returns zeros. The kernel has no
    backward: on CUDA it raises when grad is enabled and F, w or OpT
    requires grad.
    """
    if plan is None:
        _check_graph(nbr, w)
        nsrc = F.shape[0]
    elif (plan.operands[0] is not nbr or plan.operands[1] is not w
          or plan.versions != (nbr._version, w._version)):
        raise ValueError("heom_coupling: the plan was built from other nbr "
                         "and w tensors, or they were changed since")
    else:
        nsrc = plan.nsrc
    _check_operands(F, OpT, nbr, w, nsrc)
    if plan is None and nbr.numel() and int(nbr.max()) >= nsrc:
        raise ValueError(f"heom_coupling: shapes F {tuple(F.shape)} and nbr "
                         f"{tuple(nbr.shape)} do not agree: nbr holds an "
                         f"index outside [-1, {nsrc})")
    if not F.is_cuda:
        return heom_coupling_ref(F, nbr, w, OpT)
    _refuse_grad("heom_coupling", F, w, OpT)
    if plan is None:
        plan = heom_coupling_plan(nbr, w, nsrc)
    return _coupling_launch(F, OpT, plan, coupling_batched(F))


def coupling_batched(F):
    """Whether :func:`heom_coupling` takes the destination-major design for
    F: a batch (nado, B, V) of at least ``COUPLING_BATCH_MIN[F.dtype]``."""
    return F.dim() == 3 and F.shape[1] >= COUPLING_BATCH_MIN[F.dtype]


def _coupling_launch(F, OpT, plan, batched):
    """One launch of the coupling kernel on checked CUDA operands, by the
    destination-major design when ``batched``, else by the edge-major one
    (chip_smoke.py times both at the same batch through this)."""
    shape = (plan.nd,) + tuple(F.shape[1:])
    if plan.nedges == 0 or F.numel() == 0:
        return F.new_zeros(shape)
    out = (F.new_zeros(shape) if plan.edgeless and not batched
           else F.new_empty(shape))
    key = (F.shape[-1], F.shape[1] if F.dim() == 3 else 1, batched)
    args = plan.launch_args.get(key)
    if args is None:
        args = plan.launch_args[key] = _coupling_launch_args(plan, F, *key)
        heom_coupling.launch_arg_builds += 1
    fn, addr, _, _ = args
    err = _launch_on(F.get_device(), lambda stream: fn(
        F.data_ptr(), OpT.data_ptr(), out.data_ptr(), addr, stream))
    if err != 0:
        raise RuntimeError(f"heom_coupling: kernel launch failed with CUDA "
                           f"error {err}")
    heom_coupling.launches += 1
    if batched:
        heom_coupling.batched_launches += 1
    return out


heom_coupling.launches = 0
heom_coupling.batched_launches = 0
heom_coupling.launch_arg_builds = 0


def drive_superop(edip):
    """(−i(left(μ) − right(μ)))ᵀ, the row-convention superoperator of
    −i[μ, ·] (NumPy): vec(ρ) @ it = vec(−i[μ, ρ])."""
    mu = np.asarray(edip)
    eye = np.eye(mu.shape[-1])
    return (-1j * (np.kron(mu, eye) - np.kron(eye, mu.T))).T.copy()


def heom_rhs_coupling_factory(H, Q, c, nu, keys, plus_idx, minus_idx, *,
                              dtype=torch.complex128, device=None,
                              rows=None, nsrc=None):
    """HEOM RHS through :func:`heom_coupling` (kernel name ``cuda``; the
    counterpart of the JAX package's ``heom_rhs_levels_factory``). The
    local term flat @ C − damp·flat stays a torch matmul, outside the
    kernel as it was outside the Pallas call. Returns ``rhs(ados)`` for
    ados (nado, n, n), or a batch (nado, B, n, n): one kernel launch for
    the batch (F (nado, B, V), the ADO axis outermost, so a gathered
    neighbour is one contiguous (B, V) block) and one (nado·B, V) @ (V, V)
    product for the local term. Its operands lie on ``device`` (the card
    when None; raises without one).

    With ``rows`` = (lo, hi) and ``nsrc`` (:func:`rhs_rows`) the closure
    takes a stack of nsrc ADOs (a sharded run's all-gathered stack) and
    returns the rows [lo, hi) only: the kernel runs on those destinations'
    edges, with nbr indexing the whole stack (nsrc > nd), still one launch
    a call.

    With spans on (:mod:`..core.diagnostics`) the operands and their
    uploads are span ``heom.build.operands``, the plan
    ``heom.build.plan``."""
    device = resolve_device(device)
    keys = np.asarray(keys)
    nado = keys.shape[0]
    lo, hi, nsrc = rhs_rows(nado, rows, nsrc)
    nd = hi - lo
    n = np.asarray(H).shape[-1]
    V = n * n
    with span("heom.build.operands"):
        C, OpT, nbr, w = heom_coupling_operands(H, Q, c, keys, plus_idx,
                                                minus_idx)
        C_t = to_tensor(C, dtype, device)
        OpT_t = to_tensor(OpT, dtype, device)
        nbr_t = to_tensor(dest_rows(nbr, (lo, hi), -1), torch.int32, device)
        w_t = to_tensor(dest_rows(w, (lo, hi), 0.0), real_dtype_of(dtype),
                        device)
    with span("heom.build.plan"):
        plan = heom_coupling_plan(nbr_t, w_t, nsrc)
    # complex column (complex bath rates enter in full): addcmul_ below
    # needs the operands' dtype
    damp = to_tensor(dest_rows((keys @ np.asarray(nu))[:, None], (lo, hi), 0),
                     dtype, device)

    def rhs(ados):
        if ados.dim() == 3:
            flat = ados.reshape(nsrc, V)
            own = flat[lo:hi]
            out = heom_coupling(flat, nbr_t, w_t, OpT_t, plan=plan)
            out.addmm_(own, C_t)
            out.addcmul_(damp, own, value=-1)
            return out.reshape(nd, n, n)
        flat = ados.reshape(nsrc, -1, V)
        own = flat[lo:hi]
        out = heom_coupling(flat, nbr_t, w_t, OpT_t, plan=plan)
        out.view(-1, V).addmm_(own.reshape(-1, V), C_t)
        out.addcmul_(damp[:, :, None], own, value=-1)
        return out.reshape((nd,) + tuple(ados.shape[1:]))

    return rhs


# =====================================================================
# the split-operator kernels
# =====================================================================

def spo_phase_multiply_ref(expK, psik):
    """Plain version of :func:`spo_phase_multiply`: ψ_k ⊙ expK over the
    states."""
    return psik * expK[..., None]


def spo_potential_apply_ref(expV, psi):
    """Plain version of :func:`spo_potential_apply`: one ns×ns matvec
    per grid point."""
    return torch.einsum("...ab, ...b -> ...a", expV, psi)


def _grid_strides(gshape, sp):
    """C-order strides of the grid axes for a point stride ``sp``."""
    out, acc = [], sp
    for n in reversed(gshape):
        out.append(acc)
        acc *= n
    return out[::-1]


def _spo_layout(fn, psi):
    """(npts, ns, sp, ss) of a ``grid_shape + (ns,)`` tensor in one of the
    two dense layouts the kernels take: states last (point stride
    sp = ns, state stride ss = 1), or states first, as a batched FFT over
    the grid axes returns it (sp = 1, ss = npts). Raises for any other."""
    gshape = tuple(psi.shape[:-1])
    ns = psi.shape[-1]
    npts = int(np.prod(gshape))
    for sp, ss in ((ns, 1), (1, npts)):
        want = _grid_strides(gshape, sp) + [ss]
        if all(n == 1 or s == w
               for n, s, w in zip(psi.shape, psi.stride(), want)):
            return npts, ns, sp, ss
    raise ValueError(f"{fn}: psi {tuple(psi.shape)} with strides "
                     f"{psi.stride()} is neither states-last nor "
                     "states-first dense")


def _check_spo_args(fn, op, psi, op_shape):
    if psi.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{fn}: psi must be complex128 or complex64, got "
                        f"{psi.dtype}")
    if op.dtype != psi.dtype:
        raise TypeError(f"{fn}: operator is {op.dtype}, psi is {psi.dtype}")
    if psi.dim() < 2:
        raise ValueError(f"{fn}: psi must be grid_shape + (ns,), got "
                         f"{tuple(psi.shape)}")
    if tuple(op.shape) != tuple(op_shape):
        raise ValueError(f"{fn}: operator {tuple(op.shape)} does not match "
                         f"psi {tuple(psi.shape)}; expected "
                         f"{tuple(op_shape)}")
    if op.device != psi.device:
        raise ValueError(f"{fn}: operator is on {op.device}, psi on "
                         f"{psi.device}")
    if not op.is_contiguous():
        raise ValueError(f"{fn}: the operator must be contiguous")
    layout = _spo_layout(fn, psi)
    if psi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {psi.device}")
    return layout


def _launch_spo(kind, wrapper, op, psi, layout):
    """Launch ``csrc/spo.cu``'s ``kind`` kernel into a new output of psi's
    layout, check the launch, and count it on ``wrapper``."""
    from . import _cuda_lib
    npts, ns, sp, ss = layout
    lib = _cuda_lib.load("spo").lib
    fn = getattr(lib, kind + ("_c128" if psi.dtype == torch.complex128
                              else "_c64"))
    out = torch.empty_strided(psi.shape, psi.stride(), dtype=psi.dtype,
                              device=psi.device)
    if npts == 0 or ns == 0:
        return out
    err = _launch_on(psi.get_device(), lambda stream: fn(
        op.data_ptr(), psi.data_ptr(), out.data_ptr(), npts, ns, sp, ss,
        stream))
    if err != 0:
        raise RuntimeError(f"{kind}: kernel launch failed with CUDA error "
                           f"{err}")
    wrapper.launches += 1
    return out


def spo_phase_multiply(expK, psik):
    """Kinetic phase multiply ψ_k ← expK ⊙ ψ_k over all electronic states.

    Replaces the Pallas kernel of the JAX package
    (``pyqed_tpu/ops/pallas_kernels.py:267-306``). expK: grid-shaped
    complex; psik: grid_shape + (ns,) of expK's dtype (complex128 or
    complex64), states last or states first in memory (the layout a
    batched FFT over the grid axes returns); the result has psik's
    layout. On the CPU this is :func:`spo_phase_multiply_ref`; on CUDA it
    launches ``csrc/spo.cu`` (counted in ``spo_phase_multiply.launches``)
    or raises, also when grad is enabled and an input requires
    grad (the kernel has no backward).
    """
    fn = "spo_phase_multiply"
    layout = _check_spo_args(fn, expK, psik, psik.shape[:-1])
    if psik.device.type == "cpu":
        return spo_phase_multiply_ref(expK, psik)
    _refuse_grad(fn, expK, psik)
    return _launch_spo("spo_phase", spo_phase_multiply, expK, psik, layout)


spo_phase_multiply.launches = 0


def spo_potential_apply(expV, psi):
    """Potential propagator ψ[p] ← expV[p] @ ψ[p] at every grid point p.

    Replaces the Pallas kernel of the JAX package
    (``pyqed_tpu/ops/pallas_kernels.py:309-357``). expV: contiguous
    grid_shape + (ns, ns), row-major blocks as the solver stores them;
    psi: grid_shape + (ns,) of expV's dtype (complex128 or complex64),
    states last or states first in memory; the result has psi's layout.
    On the CPU this is :func:`spo_potential_apply_ref`; on CUDA it
    launches ``csrc/spo.cu`` (counted in ``spo_potential_apply.launches``)
    or raises, also when grad is enabled and an input requires
    grad (the kernel has no backward).
    """
    fn = "spo_potential_apply"
    ns = psi.shape[-1] if psi.dim() else 0
    layout = _check_spo_args(fn, expV, psi, tuple(psi.shape) + (ns,))
    if psi.device.type == "cpu":
        return spo_potential_apply_ref(expV, psi)
    _refuse_grad(fn, expV, psi)
    return _launch_spo("spo_potential", spo_potential_apply, expV, psi,
                       layout)


spo_potential_apply.launches = 0


# =====================================================================
# the Liouvillian commutator kernel
# =====================================================================

def liouvillian_commutator_ref(Heff, rho):
    """Plain version of :func:`liouvillian_commutator`:
    −i(H_eff ρ − ρ H_eff†)."""
    return -1j * (Heff @ rho - rho @ Heff.mH)


def _check_commutator_args(Heff, rho):
    fn = "liouvillian_commutator"
    if rho.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{fn}: rho must be complex128 or complex64, got "
                        f"{rho.dtype}")
    if Heff.dtype != rho.dtype:
        raise TypeError(f"{fn}: Heff is {Heff.dtype}, rho is {rho.dtype}")
    if rho.dim() != 2 or rho.shape[0] != rho.shape[1] or (
            tuple(Heff.shape) != tuple(rho.shape)):
        raise ValueError(f"{fn}: Heff {tuple(Heff.shape)} and rho "
                         f"{tuple(rho.shape)} must be one square (n, n)")
    if Heff.device != rho.device:
        raise ValueError(f"{fn}: Heff is on {Heff.device}, rho on "
                         f"{rho.device}")
    for name, x in (("Heff", Heff), ("rho", rho)):
        if not x.is_contiguous() or x.is_conj() or x.is_neg():
            raise ValueError(f"{fn}: {name} must be contiguous, with no "
                             "lazy conjugate or negative view")
    if rho.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {rho.device}")


def _commutator_launch(Heff, rho):
    """One launch of ``csrc/liouvillian.cu`` on checked CUDA operands (not
    counted here)."""
    from . import _cuda_lib
    lib = _cuda_lib.load("liouvillian").lib
    fn = (lib.liouvillian_commutator_c128 if rho.dtype == torch.complex128
          else lib.liouvillian_commutator_c64)
    out = torch.empty_like(rho)
    n = rho.shape[0]
    if n == 0:
        return out
    err = _launch_on(rho.get_device(), lambda stream: fn(
        Heff.data_ptr(), rho.data_ptr(), out.data_ptr(), n, stream))
    if err != 0:
        raise RuntimeError(f"liouvillian_commutator: kernel launch failed "
                           f"with CUDA error {err}")
    return out


def _commutator_apply(Heff, rho):
    """−i(H_eff ρ − ρ H_eff†): the plain version on the CPU, one launch of
    the kernel on CUDA."""
    if rho.device.type == "cpu":
        return liouvillian_commutator_ref(Heff, rho)
    return _commutator_launch(Heff, rho)


class _Commutator(torch.autograd.Function):
    """K(H, ρ) = −i(Hρ − ρH†) with a backward. K is linear in ρ, and its
    adjoint g ↦ i(H†g − gH) is K(−H†, g): the gradient with respect to ρ
    is one more call of the same map, on CUDA one more launch of the same
    kernel. The gradient with respect to H under PyTorch's
    conjugate-Wirtinger convention is i(g ρ† + g† ρ), two plain
    products (the JAX package never hands H_eff to Pallas with a
    gradient, so this operand has no kernel to follow)."""

    @staticmethod
    def forward(ctx, Heff, rho):
        ctx.save_for_backward(Heff, rho)
        return _commutator_apply(Heff, rho)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        Heff, rho = ctx.saved_tensors
        g = g.resolve_conj().resolve_neg().contiguous()
        gH = grho = None
        if ctx.needs_input_grad[1]:
            grho = _commutator_apply((-Heff.mH).contiguous(), g)
            if grho.is_cuda and grho.numel():
                liouvillian_commutator.backward_launches += 1
        if ctx.needs_input_grad[0]:
            gH = 1j * (g @ rho.mH + g.mH @ rho)
        return gH, grho


def liouvillian_commutator(Heff, rho):
    """Coherent part of the Lindblad right-hand side,
    out = −i(H_eff ρ − ρ H_eff†), with H_eff non-Hermitian.

    Replaces the Pallas kernel of the JAX package
    (``pyqed_tpu/ops/pallas_kernels.py:364-418``), which tiles 128×128
    outputs over full row and column panels of real/imaginary planes
    padded to multiples of 128. ``csrc/liouvillian.cu`` keeps the operands
    interleaved complex and unpadded and reads H_eff† as the conjugate
    transpose of H_eff: 16 n³ real flops per call, bound by operations.
    complex128 runs on the FP64 tensor cores (``mma.sync`` DMMA, 128×64
    output tiles, both products into one real and one imaginary
    accumulator), complex64 on FP32 FMA (the design notes are in the
    source, the measured times in PERF.md).

    Heff and rho: contiguous (n, n), both complex128 or both complex64,
    on one device. On the CPU this is :func:`liouvillian_commutator_ref`;
    on CUDA it launches the kernel (counted in
    ``liouvillian_commutator.launches``) or raises. Both arguments carry
    gradients on either device, through one ``torch.autograd.Function``
    (:class:`_Commutator`) taken when grad is enabled and an argument
    requires it: the gradient with respect to ρ is one more call of the
    same map on −H_eff†, on CUDA a launch of the same kernel, counted
    apart in ``liouvillian_commutator.backward_launches``.
    """
    _check_commutator_args(Heff, rho)
    if torch.is_grad_enabled() and (Heff.requires_grad or rho.requires_grad):
        out = _Commutator.apply(Heff, rho)
    else:
        out = _commutator_apply(Heff, rho)
    if rho.is_cuda and rho.numel():
        liouvillian_commutator.launches += 1
    return out


liouvillian_commutator.launches = 0
liouvillian_commutator.backward_launches = 0


def liouvillian_matvec(H, c_ops=None, use_kernel=None):
    """Matrix-free Liouvillian closure ``L(rho) -> drho/dt`` with the
    commutator term on :func:`liouvillian_commutator` and the jump terms
    as two batched products over the stacked c_ops (counterpart of
    ``pallas_kernels.py:421``, where they are one einsum outside the
    Pallas call):

        L(ρ) = −i(H_eff ρ − ρ H_eff†) + Σ_k c_k ρ c_k†,
        H_eff = H − (i/2) Σ_k c_k† c_k.

    H and the c_ops are tensors of rho's dtype and device. ``use_kernel``
    None or True: the commutator goes through the kernel's wrapper (its
    plain version for CPU tensors); False: the plain version on any
    device, as the JAX package's ``use_pallas=False``.
    """
    commutator = (liouvillian_commutator if use_kernel in (None, True)
                  else liouvillian_commutator_ref)
    c_ops = list(c_ops or [])
    S = sum((c.mH @ c for c in c_ops), torch.zeros_like(H))
    Heff = (H - 0.5j * S).contiguous()
    cstack = torch.stack(c_ops) if c_ops else None
    cdstack = cstack.mH.resolve_conj() if c_ops else None

    def L(rho):
        out = commutator(Heff, rho)
        if cstack is not None:
            out = out + (cstack @ rho @ cdstack).sum(dim=0)
        return out

    return L

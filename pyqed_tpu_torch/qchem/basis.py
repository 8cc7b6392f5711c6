"""Gaussian basis sets and molecular integrals (McMurchie-Davidson).

Host-side integral layer of the qchem port, a NumPy copy of
``pyqed_tpu/qchem/basis.py`` (reference: pyqed/qchem/basis.py:21-180 — own
McMurchie-Davidson ``E``, ``overlap``, ``kinetic``, ``boys``).

The scalar primitives that remain (``E_md``, ``R_herm``,
``_overlap_prim``, ``_eri_prim``) are those of the JAX package. The
one-electron matrices and their bra derivatives are evaluated by the same
recursions vectorized over every primitive pair of one angular-momentum
pair (:func:`_pair_matrix`), which gives the JAX package's loops' values
to rounding at a fraction of their cost; the O(nao^4) two-electron tensor
comes from the C++ engine (:mod:`.engine`). Everything downstream (SCF,
CI, TDSCF ...) is torch on the molecule's device. Built-in STO-3G data
for H-Ne.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
from scipy.special import hyp1f1


# ----------------------------------------------------------- STO-3G data
# standard EMSL STO-3G exponents; contraction coefficients are shared
# across first-row elements.
_STO3G_S_COEF = [0.1543289673, 0.5353281423, 0.4446345422]
_STO3G_2S_COEF = [-0.09996722919, 0.3995128261, 0.7001154689]
_STO3G_2P_COEF = [0.1559162750, 0.6076837186, 0.3919573931]

STO3G = {
    "H": {"1s": [3.425250914, 0.6239137298, 0.1688554040]},
    "He": {"1s": [6.362421394, 1.158922999, 0.3136497915]},
    "Li": {"1s": [16.11957475, 2.936200663, 0.7946504870],
           "2sp": [0.6362897469, 0.1478600533, 0.0480886784]},
    "Be": {"1s": [30.16787069, 5.495115306, 1.487192653],
           "2sp": [1.314833110, 0.3055389383, 0.0993707456]},
    "B": {"1s": [48.79111318, 8.887362172, 2.405267040],
          "2sp": [2.236956142, 0.5198204999, 0.1690617600]},
    "C": {"1s": [71.61683735, 13.04509632, 3.530512160],
          "2sp": [2.941249355, 0.6834830964, 0.2222899159]},
    "N": {"1s": [99.10616896, 18.05231239, 4.885660238],
          "2sp": [3.780455879, 0.8784966449, 0.2857143744]},
    "O": {"1s": [130.7093214, 23.80886605, 6.443608313],
          "2sp": [5.033151319, 1.169596125, 0.3803889600]},
    "F": {"1s": [166.6791340, 30.36081233, 8.216820672],
          "2sp": [6.464803249, 1.502281245, 0.4885884864]},
    "Ne": {"1s": [207.0156070, 37.70815124, 10.20529731],
           "2sp": [8.246315120, 1.916266291, 0.6232292721]},
}

ATOMIC_NUMBER = {"H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6,
                 "N": 7, "O": 8, "F": 9, "Ne": 10}

# ----------------------------------------------------------- 6-31G data
# standard Pople 6-31G (EMSL values): entries are lists of shells,
# ("S", exps, coefs) or ("SP", exps, s_coefs, p_coefs).
BASIS_631G = {
    "H": [("S", [18.73113696, 2.825394365, 0.6401216923],
           [0.03349460434, 0.2347269535, 0.8137573261]),
          ("S", [0.1612777588], [1.0])],
    "He": [("S", [38.42163400, 5.778030000, 1.241774000],
            [0.02376600, 0.15467900, 0.46963000]),
           ("S", [0.2979640], [1.0])],
    "C": [("S", [3047.524880, 457.3695180, 103.9486850, 29.21015530,
                 9.286662960, 3.163926960],
           [0.001834737132, 0.01403732281, 0.06884262226, 0.2321844432,
            0.4679413484, 0.3623119853]),
          ("SP", [7.868272350, 1.881288540, 0.5442492580],
           [-0.1193324198, -0.1608541517, 1.143456438],
           [0.06899906659, 0.3164239610, 0.7443082909]),
          ("SP", [0.1687144782], [1.0], [1.0])],
    "N": [("S", [4173.511460, 627.4579110, 142.9020930, 40.23432930,
                 12.82021290, 4.390437010],
           [0.001834772160, 0.01399462700, 0.06858655181, 0.2322408730,
            0.4690699481, 0.3604551991]),
          ("SP", [11.62636186, 2.716279807, 0.7722183966],
           [-0.1149611817, -0.1691174786, 1.145851947],
           [0.06757974388, 0.3239072959, 0.7408951398]),
          ("SP", [0.2120314975], [1.0], [1.0])],
    "O": [("S", [5484.671660, 825.2349460, 188.0469580, 52.96450000,
                 16.89757040, 5.799635340],
           [0.001831074430, 0.01395017220, 0.06844507810, 0.2327143360,
            0.4701928980, 0.3585208530]),
          ("SP", [15.53961625, 3.599933586, 1.013761750],
           [-0.1107775495, -0.1480262627, 1.130767015],
           [0.07087426823, 0.3397528391, 0.7271585773]),
          ("SP", [0.2700058226], [1.0], [1.0])],
}


@dataclasses.dataclass
class ContractedGaussian:
    """A contracted Cartesian Gaussian basis function."""
    center: np.ndarray          # (3,)
    lmn: tuple                  # angular momentum (l, m, n)
    exps: np.ndarray
    coefs: np.ndarray           # contraction coefficients (unnormalized)
    norms: np.ndarray = None    # primitive normalization, filled in post

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=float)
        self.exps = np.asarray(self.exps, dtype=float)
        self.coefs = np.asarray(self.coefs, dtype=float)
        l, m, n = self.lmn
        # primitive norms
        from scipy.special import factorial2
        fact = (factorial2(2 * l - 1) * factorial2(2 * m - 1)
                * factorial2(2 * n - 1))
        self.norms = ((2 * self.exps / np.pi) ** 0.75
                      * (4 * self.exps) ** ((l + m + n) / 2)
                      / np.sqrt(max(fact, 1.0)))
        # normalize the contraction
        S = 0.0
        for a, ca, na in zip(self.exps, self.coefs, self.norms):
            for b, cb, nb in zip(self.exps, self.coefs, self.norms):
                S += (ca * cb * na * nb
                      * _overlap_prim(a, self.lmn, self.center,
                                      b, self.lmn, self.center))
        self.coefs = self.coefs / np.sqrt(S)


# 6-31G(d) / 6-31G(d,p) polarization exponents — published values of
# Hariharan & Pople, Theor. Chim. Acta 28, 213 (1973): a single
# 6-component Cartesian d with exponent 0.8 on first-row heavy atoms,
# and (for d,p) a p shell with exponent 1.1 on H/He.
_POL_D = {"Li": 0.200, "Be": 0.400, "B": 0.600, "C": 0.800, "N": 0.800,
          "O": 0.800, "F": 0.800, "Ne": 0.800}
_POL_P_H = 1.1

_SHELL_L = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4}


def cartesian_components(L):
    """All Cartesian (l, m, n) with l + m + n = L, in canonical
    (lexicographic-descending) order: e.g. d -> xx, xy, xz, yy, yz, zz."""
    return [(L - a, a - b, b) for a in range(L + 1) for b in range(a + 1)]


def shells_to_bfs(atoms, shell_table) -> List["ContractedGaussian"]:
    """Expand a per-element shell table into contracted Cartesian
    functions. shell_table: {element: [(letter, exps, coefs[, coefs_p]),
    ...]} with letter in S/P/D/F/G or 'SP'."""
    bfs = []
    for sym, xyz in atoms:
        if sym not in shell_table:
            raise NotImplementedError(
                f"element {sym} missing from basis table "
                f"(available: {sorted(shell_table)})")
        for shell in shell_table[sym]:
            letter = shell[0].upper()
            if letter == "SP":
                _, exps, cs, cp = shell
                bfs.append(ContractedGaussian(xyz, (0, 0, 0), exps, cs))
                for lmn in cartesian_components(1):
                    bfs.append(ContractedGaussian(xyz, lmn, exps, cp))
            else:
                _, exps, cs = shell
                for lmn in cartesian_components(_SHELL_L[letter]):
                    bfs.append(ContractedGaussian(xyz, lmn, exps, cs))
    return bfs


def parse_gbs(text) -> dict:
    """Parse a Gaussian94-format basis file ('.gbs', the format Basis
    Set Exchange exports and the reference pulls through gbasis —
    pyqed/qchem/basis.py:10-15). Returns a shell table
    for :func:`shells_to_bfs`."""
    table = {}
    lines = [ln.split("!")[0].strip() for ln in text.splitlines()]
    i = 0
    while i < len(lines):
        ln = lines[i]
        i += 1
        if not ln or ln.startswith("****"):
            continue
        parts = ln.split()
        # element header lines are exactly "<Sym> 0" in Gaussian94 format
        if len(parts) == 2 and parts[1] == "0" and parts[0][0].isalpha():
            elem = parts[0].capitalize()
            shells = []
            while i < len(lines) and not lines[i].startswith("****"):
                head = lines[i].split()
                i += 1
                letter = head[0].upper()
                nprim = int(head[1])
                exps, c1, c2 = [], [], []
                for _ in range(nprim):
                    row = lines[i].replace("D", "E").replace("d", "e").split()
                    i += 1
                    exps.append(float(row[0]))
                    c1.append(float(row[1]))
                    if len(row) > 2:
                        c2.append(float(row[2]))
                if letter == "SP":
                    shells.append(("SP", exps, c1, c2))
                else:
                    shells.append((letter, exps, c1))
            table[elem] = shells
    return table


def parse_bse_json(text_or_dict) -> dict:
    """Parse a Basis Set Exchange JSON document (format version 1/2)
    into a shell table. Accepts the JSON text or the loaded dict."""
    import json as _json
    doc = (text_or_dict if isinstance(text_or_dict, dict)
           else _json.loads(text_or_dict))
    sym_of = {v: k for k, v in ATOMIC_NUMBER.items()}
    table = {}
    for z_str, el in doc.get("elements", {}).items():
        sym = sym_of.get(int(z_str), f"Z{z_str}")
        shells = []
        for sh in el["electron_shells"]:
            exps = [float(x) for x in sh["exponents"]]
            coefs = [[float(c) for c in col] for col in sh["coefficients"]]
            ang = sh["angular_momentum"]
            letters = "SPDFG"
            if ang == [0, 1] and len(coefs) == 2:
                shells.append(("SP", exps, coefs[0], coefs[1]))
            elif len(ang) == 1:
                # general contraction: one angular momentum, several
                # independent contraction columns -> one shell per column
                # (e.g. cc-pVDZ H: angular_momentum [0], 2 columns)
                for col in coefs:
                    shells.append((letters[ang[0]], exps, col))
            else:
                if len(ang) != len(coefs):
                    raise ValueError(
                        f"BSE shell with angular_momentum {ang} has "
                        f"{len(coefs)} coefficient columns — unsupported "
                        "combination")
                for L, col in zip(ang, coefs):
                    shells.append((letters[L], exps, col))
        table[sym] = shells
    return table


def load_basis(path) -> dict:
    """Load a basis-set file (.gbs / Gaussian94 text, or BSE .json)
    into a shell table usable as ``build_basis(atoms, basis=table)``."""
    with open(path) as fh:
        text = fh.read()
    if str(path).endswith(".json") or text.lstrip().startswith("{"):
        return parse_bse_json(text)
    return parse_gbs(text)


def _sto3g_table():
    table = {}
    for sym, data in STO3G.items():
        shells = []
        if "1s" in data:
            shells.append(("S", data["1s"], _STO3G_S_COEF))
        if "2sp" in data:
            shells.append(("SP", data["2sp"], _STO3G_2S_COEF,
                           _STO3G_2P_COEF))
        table[sym] = shells
    return table


def _631g_table(d_pol=False, p_pol=False):
    table = {}
    for sym, shells in BASIS_631G.items():
        out = list(shells)
        if d_pol and sym in _POL_D:
            out.append(("D", [_POL_D[sym]], [1.0]))
        if p_pol and sym in ("H", "He"):
            out.append(("P", [_POL_P_H], [1.0]))
        table[sym] = out
    return table


def build_basis(atoms: Sequence, basis="sto-3g") -> List[ContractedGaussian]:
    """atoms: list of (symbol, (x, y, z)) in bohr.

    ``basis`` may be: a built-in name — 'sto-3g', '6-31g', '6-31g*'
    (= 6-31g(d), 6 Cartesian d), '6-31g**' (= 6-31g(d,p)); a shell
    table from :func:`load_basis`/:func:`parse_gbs`/:func:`parse_bse_json`
    (arbitrary elements and angular momenta — the general-basis path the
    reference reaches through gbasis, pyqed/qchem/basis.py:10-15); or a
    path to a .gbs/.json basis file."""
    if isinstance(basis, dict):
        return shells_to_bfs(atoms, basis)
    if isinstance(basis, str) and ("/" in basis or basis.endswith(
            (".gbs", ".json", ".txt"))):
        return shells_to_bfs(atoms, load_basis(basis))
    name = basis.lower().replace("-", "").replace("_", "")
    if name == "sto3g":
        return shells_to_bfs(atoms, _sto3g_table())
    if name == "631g":
        return shells_to_bfs(atoms, _631g_table())
    if name in ("631g*", "631gd"):
        return shells_to_bfs(atoms, _631g_table(d_pol=True))
    if name in ("631g**", "631gdp"):
        return shells_to_bfs(atoms, _631g_table(d_pol=True, p_pol=True))
    raise NotImplementedError(
        f"basis {basis!r} not built in (available: sto-3g, 6-31g, "
        "6-31g*, 6-31g**, or a .gbs/.json file / shell table)")


# -------------------------------------------------- McMurchie-Davidson E

def E_md(i, j, t, Qx, a, b):
    """Hermite Gaussian expansion coefficient E_t^{ij}
    (reference: pyqed/qchem/basis.py:21 ``E``)."""
    p = a + b
    q = a * b / p
    if t < 0 or t > i + j:
        return 0.0
    if i == j == t == 0:
        return np.exp(-q * Qx * Qx)
    if j == 0:
        return (E_md(i - 1, j, t - 1, Qx, a, b) / (2 * p)
                - q * Qx / a * E_md(i - 1, j, t, Qx, a, b)
                + (t + 1) * E_md(i - 1, j, t + 1, Qx, a, b))
    return (E_md(i, j - 1, t - 1, Qx, a, b) / (2 * p)
            + q * Qx / b * E_md(i, j - 1, t, Qx, a, b)
            + (t + 1) * E_md(i, j - 1, t + 1, Qx, a, b))


def _overlap_prim(a, lmn1, A, b, lmn2, B):
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    S1 = E_md(l1, l2, 0, A[0] - B[0], a, b)
    S2 = E_md(m1, m2, 0, A[1] - B[1], a, b)
    S3 = E_md(n1, n2, 0, A[2] - B[2], a, b)
    return S1 * S2 * S3 * (np.pi / (a + b)) ** 1.5


def boys(n, T):
    """Boys function F_n(T) (reference: pyqed/qchem/basis.py ``boys``)."""
    return hyp1f1(n + 0.5, n + 1.5, -T) / (2.0 * n + 1.0)


def R_herm(t, u, v, n, p, PCx, PCy, PCz, RPC):
    """Hermite Coulomb integral recursion."""
    if t == u == v == 0:
        return (-2 * p) ** n * boys(n, p * RPC * RPC)
    if t < 0 or u < 0 or v < 0:
        return 0.0
    if t > 0:
        return ((t - 1) * R_herm(t - 2, u, v, n + 1, p, PCx, PCy, PCz, RPC)
                + PCx * R_herm(t - 1, u, v, n + 1, p, PCx, PCy, PCz, RPC))
    if u > 0:
        return ((u - 1) * R_herm(t, u - 2, v, n + 1, p, PCx, PCy, PCz, RPC)
                + PCy * R_herm(t, u - 1, v, n + 1, p, PCx, PCy, PCz, RPC))
    return ((v - 1) * R_herm(t, u, v - 2, n + 1, p, PCx, PCy, PCz, RPC)
            + PCz * R_herm(t, u, v - 1, n + 1, p, PCx, PCy, PCz, RPC))


def _eri_prim(a, lmn1, A, b, lmn2, B, c, lmn3, C, d, lmn4, D):
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    l3, m3, n3 = lmn3
    l4, m4, n4 = lmn4
    p = a + b
    q = c + d
    alpha = p * q / (p + q)
    P = (a * A + b * B) / p
    Q = (c * C + d * D) / q
    RPQ = np.linalg.norm(P - Q)
    val = 0.0
    for t in range(l1 + l2 + 1):
        E1 = E_md(l1, l2, t, A[0] - B[0], a, b)
        if E1 == 0:
            continue
        for u in range(m1 + m2 + 1):
            E2 = E_md(m1, m2, u, A[1] - B[1], a, b)
            if E2 == 0:
                continue
            for v in range(n1 + n2 + 1):
                E3 = E_md(n1, n2, v, A[2] - B[2], a, b)
                if E3 == 0:
                    continue
                for tau in range(l3 + l4 + 1):
                    E4 = E_md(l3, l4, tau, C[0] - D[0], c, d)
                    if E4 == 0:
                        continue
                    for nu in range(m3 + m4 + 1):
                        E5 = E_md(m3, m4, nu, C[1] - D[1], c, d)
                        if E5 == 0:
                            continue
                        for phi in range(n3 + n4 + 1):
                            E6 = E_md(n3, n4, phi, C[2] - D[2], c, d)
                            if E6 == 0:
                                continue
                            val += (E1 * E2 * E3 * E4 * E5 * E6
                                    * (-1) ** (tau + nu + phi)
                                    * R_herm(t + tau, u + nu, v + phi, 0,
                                             alpha, P[0] - Q[0], P[1] - Q[1],
                                             P[2] - Q[2], RPQ))
    return val * 2 * np.pi**2.5 / (p * q * np.sqrt(p + q))


# ------------------------------------------- vectorized one-electron layer
# The recursions above, evaluated at once over every primitive pair of one
# (lmn1, lmn2) block of two basis sets (the overlap, kinetic and nuclear
# primitives and their bra derivatives are the methods of ``_Pairs``). Each pair's value is the scalar
# recursion's; only the order of the contraction sums and of a few
# products differs, so the matrices agree with the loops to rounding.

def _E_vec(Qx, a, b):
    """``E(i, j, t)`` = :func:`E_md` over arrays of pairs (memoized)."""
    p = a + b
    q = a * b / p
    memo = {}

    def E(i, j, t):
        if t < 0 or t > i + j:
            return 0.0
        key = (i, j, t)
        if key not in memo:
            if i == j == t == 0:
                memo[key] = np.exp(-q * Qx * Qx)
            elif j == 0:
                memo[key] = (E(i - 1, j, t - 1) / (2 * p)
                             - q * Qx / a * E(i - 1, j, t)
                             + (t + 1) * E(i - 1, j, t + 1))
            else:
                memo[key] = (E(i, j - 1, t - 1) / (2 * p)
                             + q * Qx / b * E(i, j - 1, t)
                             + (t + 1) * E(i, j - 1, t + 1))
        return memo[key]

    return E


def _R_vec(p, PCx, PCy, PCz, RPC):
    """``R(t, u, v, n)`` = :func:`R_herm` over arrays of pairs (memoized)."""
    memo = {}

    def R(t, u, v, n):
        if t < 0 or u < 0 or v < 0:
            return 0.0
        key = (t, u, v, n)
        if key not in memo:
            if t == u == v == 0:
                memo[key] = (-2 * p) ** n * boys(n, p * RPC * RPC)
            elif t > 0:
                memo[key] = ((t - 1) * R(t - 2, u, v, n + 1)
                             + PCx * R(t - 1, u, v, n + 1))
            elif u > 0:
                memo[key] = ((u - 1) * R(t, u - 2, v, n + 1)
                             + PCy * R(t, u - 1, v, n + 1))
            else:
                memo[key] = ((v - 1) * R(t, u, v - 2, n + 1)
                             + PCz * R(t, u, v - 1, n + 1))
        return memo[key]

    return R


def _shift(lmn, axis, d):
    return tuple(int(l) + (d if k == axis else 0) for k, l in enumerate(lmn))


class _Pairs:
    """Primitive pairs (a at A, b at B) of one angular-momentum block."""

    def __init__(self, a, A, b, B):
        self.a, self.A, self.b, self.B = a, A, b, B
        self.p = a + b
        self.E = [_E_vec(A[:, k] - B[:, k], a, b) for k in range(3)]

    def overlap(self, l1, l2):
        S1, S2, S3 = (self.E[k](l1[k], l2[k], 0) for k in range(3))
        return S1 * S2 * S3 * (np.pi / self.p) ** 1.5

    def kinetic(self, l1, l2):
        b = self.b
        term0 = b * (2 * sum(l2) + 3) * self.overlap(l1, l2)
        term1 = -2 * b ** 2 * sum(self.overlap(l1, _shift(l2, k, 2))
                                  for k in range(3))
        term2 = -0.5 * sum(l2[k] * (l2[k] - 1)
                           * self.overlap(l1, _shift(l2, k, -2))
                           for k in range(3))
        return term0 + term1 + term2

    def nuclear(self, l1, l2, C):
        p = self.p
        P = (self.a[:, None] * self.A + self.b[:, None] * self.B) / p[:, None]
        PC = P - np.asarray(C, dtype=float)
        R = _R_vec(p, PC[:, 0], PC[:, 1], PC[:, 2],
                   np.sqrt(np.sum(PC * PC, axis=1)))
        val = 0.0
        for t in range(l1[0] + l2[0] + 1):
            Et = self.E[0](l1[0], l2[0], t)
            for u in range(l1[1] + l2[1] + 1):
                Eu = self.E[1](l1[1], l2[1], u)
                for v in range(l1[2] + l2[2] + 1):
                    Ev = self.E[2](l1[2], l2[2], v)
                    val = val + Et * Eu * Ev * R(t, u, v, 0)
        return 2 * np.pi / p * val

    def dbra(self, prim, l1, l2, axis, *args):
        """d/dA_axis of ``prim`` by the raising/lowering rule."""
        d = 2.0 * self.a * prim(_shift(l1, axis, 1), l2, *args)
        if l1[axis]:
            d = d - l1[axis] * prim(_shift(l1, axis, -1), l2, *args)
        return d


def _prims(bfs):
    """Every primitive of ``bfs``: (bf index, exponent, coef x norm,
    center, lmn) as arrays."""
    idx = np.concatenate([np.full(len(g.exps), k) for k, g in enumerate(bfs)])
    ex = np.concatenate([g.exps for g in bfs])
    cn = np.concatenate([g.coefs * g.norms for g in bfs])
    ctr = np.concatenate([np.tile(g.center, (len(g.exps), 1)) for g in bfs])
    lmn = np.concatenate([np.tile(np.asarray(g.lmn, int), (len(g.exps), 1))
                          for g in bfs])
    return idx, ex, cn, ctr, lmn


def _pair_matrix(bfs1, bfs2, fn, shape=()):
    """``out[..., i, j] = sum over primitive pairs of (i, j) of
    c_a c_b fn(pairs, lmn_i, lmn_j)``, one vectorized call per pair of
    angular momenta; ``fn`` returns an array of trailing dimension the
    number of pairs, with leading dimensions ``shape``."""
    i1, e1, c1, r1, l1 = _prims(bfs1)
    i2, e2, c2, r2, l2 = _prims(bfs2)
    out = np.zeros(tuple(shape) + (len(bfs1), len(bfs2)))
    lm1 = {tuple(x) for x in l1}
    lm2 = {tuple(x) for x in l2}
    for la in sorted(lm1):
        sa = np.flatnonzero(np.all(l1 == la, axis=1))
        for lb in sorted(lm2):
            sb = np.flatnonzero(np.all(l2 == lb, axis=1))
            ia, ib = (x.ravel() for x in np.meshgrid(sa, sb, indexing="ij"))
            pairs = _Pairs(e1[ia], r1[ia], e2[ib], r2[ib])
            vals = (c1[ia] * c2[ib]) * np.asarray(fn(pairs, la, lb))
            vals = np.broadcast_to(vals, tuple(shape) + ia.shape)
            for lead in np.ndindex(*shape):
                np.add.at(out[lead], (i1[ia], i2[ib]), vals[lead])
    return out


def _mirror_lower(M):
    """The symmetric matrix with the lower triangle of ``M``."""
    return np.tril(M) + np.tril(M, -1).T


def overlap_matrix(bfs):
    return _mirror_lower(_pair_matrix(
        bfs, bfs, lambda P, la, lb: P.overlap(la, lb)))


def dipole_matrix(bfs, origin=(0.0, 0.0, 0.0)):
    """Cartesian dipole AO integrals mu_k[i,j] = <i| (r-O)_k |j> via
    angular-momentum raising: (r−B)_k |b> = |b, l_k+1>, so
    <a|(r−O)_k|b> = S(a, b+e_k) + (B_k − O_k) S(a, b)
    (reference computes these through gbasis, pyqed/qchem/basis.py:10).

    Returns (3, n, n).
    """
    origin = np.asarray(origin, dtype=float)

    def mu(P, la, lb):
        plain = P.overlap(la, lb)
        return np.stack([P.overlap(la, _shift(lb, k, 1))
                         + (P.B[:, k] - origin[k]) * plain
                         for k in range(3)])

    return _pair_matrix(bfs, bfs, mu, shape=(3,))


def kinetic_matrix(bfs):
    T = _pair_matrix(bfs, bfs, lambda P, la, lb: P.kinetic(la, lb))
    return (T + T.T) / 2


def nuclear_matrix(bfs, atoms):
    n = len(bfs)
    V = np.zeros((n, n))
    for (sym, xyz) in atoms:
        C = np.asarray(xyz, dtype=float)
        V -= ATOMIC_NUMBER[sym] * _mirror_lower(_pair_matrix(
            bfs, bfs, lambda P, la, lb: P.nuclear(la, lb, C)))
    return V


def eri_tensor(bfs, native=True):
    """(ij|kl) chemists' notation, 8-fold symmetry exploited.

    With ``native=True`` (default) the C++ MD engine (qchem/native/
    eri_engine.cpp, OpenMP; :mod:`.engine`) builds the tensor, and a
    failed build raises. The Python recursion below runs only with
    ``native=False``: it is the parity oracle, about 100x slower."""
    if native:
        from .engine import eri_tensor_native
        return eri_tensor_native(bfs)
    n = len(bfs)
    eri = np.zeros((n, n, n, n))

    def contracted_eri(g1, g2, g3, g4):
        val = 0.0
        for a, ca, na in zip(g1.exps, g1.coefs, g1.norms):
            for b, cb, nb in zip(g2.exps, g2.coefs, g2.norms):
                for c, cc, nc in zip(g3.exps, g3.coefs, g3.norms):
                    for d, cd, nd in zip(g4.exps, g4.coefs, g4.norms):
                        val += (ca * cb * cc * cd * na * nb * nc * nd
                                * _eri_prim(a, g1.lmn, g1.center,
                                            b, g2.lmn, g2.center,
                                            c, g3.lmn, g3.center,
                                            d, g4.lmn, g4.center))
        return val

    for i in range(n):
        for j in range(i + 1):
            ij = i * (i + 1) // 2 + j
            for k in range(n):
                for l in range(k + 1):
                    kl = k * (k + 1) // 2 + l
                    if ij < kl:
                        continue
                    v = contracted_eri(bfs[i], bfs[j], bfs[k], bfs[l])
                    for (a, b, c, d) in [(i, j, k, l), (j, i, k, l),
                                         (i, j, l, k), (j, i, l, k),
                                         (k, l, i, j), (l, k, i, j),
                                         (k, l, j, i), (l, k, j, i)]:
                        eri[a, b, c, d] = v
    return eri


def nuclear_repulsion(atoms):
    E = 0.0
    for i, (s1, x1) in enumerate(atoms):
        for j, (s2, x2) in enumerate(atoms):
            if j <= i:
                continue
            R = np.linalg.norm(np.asarray(x1) - np.asarray(x2))
            E += ATOMIC_NUMBER[s1] * ATOMIC_NUMBER[s2] / R
    return E


# ----------------------------------------------------------------------
# Real-spherical (pure) angular functions.
#
# The reference obtains spherical-harmonic bases through gbasis
# (pyqed/qchem/basis.py:10-15); here the cart->spherical
# transform is built from first principles for ANY angular momentum: the
# real solid harmonic r^L Y_{Lm} is a degree-L homogeneous polynomial,
# and homogeneous polynomials restricted to the unit sphere are linearly
# independent, so an exact (residual ~1e-15) least-squares projection of
# scipy's Y_{Lm} onto the degree-L monomials recovers the unique
# coefficient table — no hand-copied constant tables.
# ----------------------------------------------------------------------

def _sphere_points(n):
    """Deterministic golden-spiral nodes on S^2 (no RNG)."""
    k = np.arange(n, dtype=float) + 0.5
    phi = np.pi * (1.0 + np.sqrt(5.0)) * k
    z = 1.0 - 2.0 * k / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def real_solid_harmonic_coefs(L):
    """(2L+1, ncart) matrix c with  r^L Y_{Lm}^real = sum_i c[m, i] *
    x^a y^b z^c  over ``cartesian_components(L)`` (rows ordered
    m = -L..L, pyscf convention; each row scaled so the polynomial
    equals the unit-normalized real spherical harmonic on the sphere).

    Exact by construction: lstsq residual is checked to ~1e-12.
    """
    try:                                   # scipy >= 1.15
        from scipy.special import sph_harm_y

        def _ylm(m, l, phi, theta):
            return sph_harm_y(l, m, theta, phi)
    except ImportError:                    # older scipy
        from scipy.special import sph_harm

        def _ylm(m, l, phi, theta):
            return sph_harm(m, l, phi, theta)
    comps = cartesian_components(L)
    pts = _sphere_points(4 * (L + 2) ** 2 + 13)
    x, y, z = pts.T
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    phi = np.arctan2(y, x)
    M = np.stack([x ** a * y ** b * z ** c for (a, b, c) in comps], axis=1)
    rows = []
    for m in range(-L, L + 1):
        ylm = _ylm(abs(m), L, phi, theta)
        if m > 0:
            yr = np.sqrt(2.0) * (-1.0) ** m * ylm.real
        elif m < 0:
            yr = np.sqrt(2.0) * (-1.0) ** m * ylm.imag
        else:
            yr = ylm.real
        c, res, _, _ = np.linalg.lstsq(M, yr, rcond=None)
        err = np.max(np.abs(M @ c - yr))
        if err > 1e-10:
            raise RuntimeError(f"solid-harmonic projection failed L={L} "
                               f"m={m}: residual {err:.2e}")
        rows.append(c)
    return np.asarray(rows)


def _shell_groups(bfs):
    """Group a flat bf list (as emitted by shells_to_bfs) into shells:
    yields (start_index, L, count). Cartesian components of one shell are
    contiguous and begin with lmn = (L, 0, 0)."""
    i, n = 0, len(bfs)
    while i < n:
        L = int(sum(bfs[i].lmn))
        ncart = (L + 1) * (L + 2) // 2
        if tuple(bfs[i].lmn) != (L, 0, 0) or i + ncart > n:
            raise ValueError("basis list is not in canonical shell order")
        for k, lmn in enumerate(cartesian_components(L)):
            if tuple(bfs[i + k].lmn) != tuple(lmn):
                raise ValueError("basis list is not in canonical shell order")
        yield i, L, ncart
        i += ncart


def spherical_transform(bfs, complete=False):
    """Matrix C (nsph x ncart) expressing a normalized real-spherical AO
    basis in terms of the normalized Cartesian AOs ``bfs``:
    ``chi_sph = C @ chi_cart``.  One-electron integrals transform as
    C M C^T, the ERI on all four indices (:func:`transform_eri`).

    s/p shells pass through unchanged; an L>=2 shell of (L+1)(L+2)/2
    Cartesians contracts to 2L+1 pure functions (dropping the r^2-times-
    lower-L contaminants).  With ``complete=True`` the dropped
    combinations are appended as extra orthonormalized rows so C is
    square/invertible — useful to verify exact basis-span invariance.

    (reference counterpart: gbasis spherical basis construction,
    pyqed/qchem/basis.py:10-15.)
    """
    from scipy.special import factorial2
    ncart_tot = len(bfs)
    rows = []
    for i0, L, ncart in _shell_groups(bfs):
        shell = bfs[i0:i0 + ncart]
        if L < 2:
            for k in range(ncart):
                r = np.zeros(ncart_tot)
                r[i0 + k] = 1.0
                rows.append(r)
            continue
        # monomial_i * G(r) = t_i * chi_i  (shared radial G): recover the
        # per-component scale t_i from the stored normalized contraction.
        # t_i  ∝  sqrt(f_i) / ctilde_p*(i)   (see ContractedGaussian:
        # ctilde_p = c_p / sqrt(S_i) with shell-common c_p).
        pstar = int(np.argmax(np.abs(shell[0].coefs)))
        t = np.empty(ncart)
        for k, g in enumerate(shell):
            a, b, c = g.lmn
            f = (factorial2(2 * a - 1) * factorial2(2 * b - 1)
                 * factorial2(2 * c - 1))
            t[k] = np.sqrt(max(float(f), 1.0)) * (
                shell[0].coefs[pstar] / g.coefs[pstar])
        Sblk = overlap_matrix(shell)
        cmono = real_solid_harmonic_coefs(L)          # (2L+1, ncart)
        W = cmono * t[None, :]
        if complete:
            # contaminant subspace: nullspace of the harmonic rows in the
            # metric-free coefficient space, then Gram-Schmidt in S_blk.
            _, _, Vt = np.linalg.svd(cmono)
            W = np.vstack([W, Vt[2 * L + 1:] * t[None, :]])
        for w in W:
            w = w / np.sqrt(float(w @ Sblk @ w))
            r = np.zeros(ncart_tot)
            r[i0:i0 + ncart] = w
            rows.append(r)
    return np.asarray(rows)


def transform_eri(C, eri):
    """Four-index basis transform of the ERI tensor (chemist layout)."""
    e = np.einsum("pi, ijkl -> pjkl", C, np.asarray(eri), optimize=True)
    e = np.einsum("qj, pjkl -> pqkl", C, e, optimize=True)
    e = np.einsum("rk, pqkl -> pqrl", C, e, optimize=True)
    return np.einsum("sl, pqrl -> pqrs", C, e, optimize=True)


# -------------------------------------------- derivative integrals (bra)
# d/dA_x chi(lmn; a) = 2a chi(lmn+e_x) - l_x chi(lmn-e_x), applied per
# PRIMITIVE (the 2a factor differs across the contraction). These feed
# the analytic RHF gradient (reference reaches gradients through pyscf;
# its own Grad class is an empty skeleton, pyqed/qchem/grad.py:9).

def overlap_deriv_bra(bfs):
    """dS[x, i, j] = <d chi_i / dA_x | chi_j> (3, n, n)."""
    return _pair_matrix(bfs, bfs, lambda P, la, lb: np.stack(
        [P.dbra(P.overlap, la, lb, x) for x in range(3)]), shape=(3,))


def kinetic_deriv_bra(bfs):
    """dT[x, i, j] = <d chi_i / dA_x | T | chi_j> (3, n, n)."""
    return _pair_matrix(bfs, bfs, lambda P, la, lb: np.stack(
        [P.dbra(P.kinetic, la, lb, x) for x in range(3)]), shape=(3,))


def nuclear_deriv_bra(bfs, C):
    """dV[x, i, j] = <d chi_i / dA_x | 1/|r-C| | chi_j> for ONE
    attraction center C (3, n, n); the Hellmann-Feynman (operator-
    center) derivative follows by translational invariance:
    dV/dC = -(bra + ket derivatives)."""
    C = np.asarray(C, dtype=float)
    return _pair_matrix(bfs, bfs, lambda P, la, lb: np.stack(
        [P.dbra(P.nuclear, la, lb, x, C) for x in range(3)]), shape=(3,))


def _contract4_dbra(g1, g2, g3, g4, axis):
    """d/d(g1.center[axis]) of the contracted (g1 g2 | g3 g4)."""
    lmn = np.asarray(g1.lmn)
    up = tuple(lmn + np.eye(3, dtype=int)[axis])
    lo = tuple(lmn - np.eye(3, dtype=int)[axis])
    l_ax = int(lmn[axis])
    val = 0.0
    for a, ca, na in zip(g1.exps, g1.coefs, g1.norms):
        for b, cb, nb in zip(g2.exps, g2.coefs, g2.norms):
            for c, cc, nc in zip(g3.exps, g3.coefs, g3.norms):
                for d, cd, nd in zip(g4.exps, g4.coefs, g4.norms):
                    t = 2.0 * a * _eri_prim(
                        a, up, g1.center, b, g2.lmn, g2.center,
                        c, g3.lmn, g3.center, d, g4.lmn, g4.center)
                    if l_ax:
                        t -= l_ax * _eri_prim(
                            a, lo, g1.center, b, g2.lmn, g2.center,
                            c, g3.lmn, g3.center, d, g4.lmn, g4.center)
                    val += ca * cb * cc * cd * na * nb * nc * nd * t
    return val


def eri_deriv_bra_py(bfs):
    """dERI[x, i, j, k, l] = (d chi_i/dA_x chi_j | chi_k chi_l) — pure-
    Python oracle for the native engine (slow; tiny systems only)."""
    n = len(bfs)
    out = np.zeros((3, n, n, n, n))
    for x in range(3):
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    for l in range(n):
                        out[x, i, j, k, l] = _contract4_dbra(
                            bfs[i], bfs[j], bfs[k], bfs[l], x)
    return out


def eri_deriv(bfs, native=True):
    """dERI[x, i, j, k, l] = (d chi_i/dA_x chi_j | chi_k chi_l)
    (3, n, n, n, n): from the C++ derivative builder
    (:func:`.engine.eri_deriv_pairs`, the engine's ``eri_deriv_native``
    tensor), which raises when it cannot be built; ``native=False`` runs
    the Python oracle (:func:`eri_deriv_bra_py`)."""
    if native:
        from .engine import eri_deriv_pairs
        return eri_deriv_pairs(bfs)
    return eri_deriv_bra_py(bfs)

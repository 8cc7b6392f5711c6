"""QSATS: variational Monte Carlo for quantum atomic solids (solid He).

Counterpart of ``pyqed_tpu/qmc/qsats.py``. N He-4 atoms on an fcc/hcp
lattice with periodic boundary conditions (minimum image) and the
pair-product trial function

    ln psi(q) = -a sum_i |q_i|^2  - 1/2 sum_{pairs} (b / r_ij)^5 ,

q_i the displacement of atom i from its site and r_ij = |q_j - q_i +
R_ij| with R_ij the minimum-image lattice vector. Permutation-exchange
moves swap the site assignment of two stencil neighbours (positions
fixed, displacements rebased) and are accepted on the full trial.

Lattices and the pair stencil are host NumPy, as in the JAX package; the
walkers live on the device as one ``(nwalkers, N, 3)`` tensor. The local
energy scatters its per-pair terms with ``index_add_``: on CUDA that sums
with atomics in no fixed order, so the card agrees with the CPU to
rounding (1e-12 relative), not bit for bit.

A sweep is a function of the walkers and their draws (:meth:`QSATS.draws`),
so the JAX package's ``jax.random`` draws can be fed to
:meth:`QSATS.sweeps`. The per-atom sweep moves the N atoms in turn, each
move recomputing ln psi in full as the JAX package does, batched over
walkers; on the card one sweep is one CUDA graph. The exchange flags of
the sweeps come from ``np.random.default_rng(0)`` on the host, as in the
JAX package, and pick one of two graphs, with and without the exchange
move. ``mesh=`` is not yet ported (it raises). All quantities in atomic
units; ``HART2K`` converts to Kelvin.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..config import not_yet_ported, resolve_device
from ..core.dynamics import GraphScan

__all__ = ["hfdbhe", "fcc_lattice", "hcp_lattice", "build_pairs",
           "QSATS", "HART2K", "HE4_MASS"]

HART2K = 315774.65            # hartree -> Kelvin
K_PER_ATOM = 3.1668513e-6     # hartree per Kelvin
HE4_MASS = 7296.299           # He-4 mass in m_e
BLOCK = 25                    # sweeps of draws made and fed per call


def hfdbhe(r2):
    """HFD-B(He) He-He pair potential [hartree] against the squared
    distance [bohr^2] (R.A. Aziz et al., Mol. Phys. 61, 1487 (1987)), in
    torch operations on a tensor ``r2``."""
    r2 = torch.as_tensor(r2)
    astar = 1.8443101e5
    alstar = 10.43329537
    bestar = -2.27965105
    d = 1.4826
    c6, c8, c10 = 1.36745214, 0.42123807, 0.17473318
    rm, eps = 5.59926, 10.948
    x = torch.sqrt(r2) / rm
    vstar = astar * torch.exp(-alstar * x + bestar * x * x)
    vd = c6 / x ** 6 + c8 / x ** 8 + c10 / x ** 10
    vd = torch.where(x < d, vd * torch.exp(-(d / x - 1.0) ** 2), vd)
    return (vstar - vd) * eps / HART2K


def fcc_lattice(ncell, density):
    """fcc supercell: ncell=(n1,n2,n3) conventional cubic cells, atomic
    number density [bohr^-3]. Returns (sites (N,3), box (3,))."""
    n1, n2, n3 = ncell
    a = (4.0 / density) ** (1.0 / 3.0)        # cubic lattice constant
    basis = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                      [0, 0.5, 0.5]])
    cells = np.array([(i, j, k) for i in range(n1) for j in range(n2)
                      for k in range(n3)], float)
    sites = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a
    box = np.array([n1, n2, n3], float) * a
    return sites, box


def hcp_lattice(ncell, density):
    """hcp supercell (orthorhombic 4-atom representation) at the given
    number density; ideal c/a. Returns (sites (N,3), box (3,))."""
    n1, n2, n3 = ncell
    ca = np.sqrt(8.0 / 3.0)
    vol_per_atom = 1.0 / density
    a = (4.0 * vol_per_atom / (np.sqrt(3.0) * ca)) ** (1.0 / 3.0)
    ax, ay, az = a, a * np.sqrt(3.0), a * ca
    basis = np.array([[0.0, 0.0, 0.0],
                      [0.5, 0.5, 0.0],
                      [0.5, 5.0 / 6.0, 0.5],
                      [0.0, 1.0 / 3.0, 0.5]])
    cells = np.array([(i, j, k) for i in range(n1) for j in range(n2)
                      for k in range(n3)], float)
    sites = ((cells[:, None, :] + basis[None, :, :]).reshape(-1, 3)
             * np.array([ax, ay, az]))
    box = np.array([n1 * ax, n2 * ay, n3 * az])
    return sites, box


def build_pairs(sites, box, ratio=1.8):
    """Directed interacting-pair stencil: all (i, j), j != i, whose
    minimum-image lattice separation is below ratio * r_nn. Returns
    (ipairs (P, 2) int32, vpvec (P, 3) float with vpvec = min-image
    R_j - R_i, and the nearest-neighbour distance rnn)."""
    sites = np.asarray(sites)
    box = np.asarray(box)
    dv = sites[None, :, :] - sites[:, None, :]
    dv -= box * np.round(dv / box)            # minimum image
    r = np.sqrt((dv ** 2).sum(-1))
    np.fill_diagonal(r, np.inf)
    rnn = r.min()
    ii, jj = np.where(r < ratio * rnn)
    return (np.stack([ii, jj], axis=1).astype(np.int32),
            dv[ii, jj].astype(np.float64), rnn)


@dataclass
class QSATS:
    """Pair-product VMC on a quantum solid (see the module docstring).

    Parameters
    ----------
    sites, box : lattice sites (N, 3) and periodic box (3,) [bohr]
    a : Einstein localization exponent [bohr^-2]
    b : McMillan Jastrow length [bohr]
    mass : atomic mass [m_e]
    ratio : stencil cutoff in nearest-neighbour distances
    device : where the walkers live (the card when None)
    """
    sites: np.ndarray
    box: np.ndarray
    a: float = 0.06
    b: float = 5.0
    mass: float = HE4_MASS
    ratio: float = 1.8
    device: Any = None

    def __post_init__(self):
        self.sites = np.asarray(self.sites, float)
        self.box = np.asarray(self.box, float)
        self.natoms = self.sites.shape[0]
        ip, vp, rnn = build_pairs(self.sites, self.box, self.ratio)
        self.ipairs, self.vpvec, self.rnn = ip, vp, rnn
        self.device = resolve_device(self.device)
        self._stencil = {}
        self._scans = {}

    def _pairs_on(self, device):
        """(i, j, R) of the stencil as tensors on ``device``."""
        key = str(device)
        if key not in self._stencil:
            ip = torch.as_tensor(self.ipairs, dtype=torch.long,
                                 device=device)
            self._stencil[key] = (ip[:, 0].contiguous(),
                                  ip[:, 1].contiguous(),
                                  torch.as_tensor(self.vpvec, device=device))
        return self._stencil[key]

    def _q(self, q):
        return torch.as_tensor(q, dtype=torch.float64, device=self.device) \
            if not isinstance(q, torch.Tensor) else q

    # ------------------------------------------------------ trial fn

    def _pair_r2(self, q):
        """Squared pair separations r_ij^2 (..., P) of q (..., N, 3)."""
        i, j, R = self._pairs_on(q.device)
        d = q[..., j, :] - q[..., i, :] + R
        return torch.sum(d * d, dim=-1), d, i, j

    def log_psi(self, q):
        """ln psi(q) of displacements q (..., N, 3): a batch of walkers
        gives one value each."""
        q = self._q(q)
        r2, _, _, _ = self._pair_r2(q)
        jas = -0.25 * torch.sum((self.b ** 2 / r2) ** 2.5, dim=-1)
        return -self.a * torch.sum(q * q, dim=(-2, -1)) + jas

    def local_energy(self, q):
        """(tloc, vloc) [hartree] of q (..., N, 3) through the closed-form
        gradient and Laplacian of ln psi, the per-pair terms scattered
        onto their first atom with ``index_add_``."""
        q = self._q(q)
        r2, d, i, _ = self._pair_r2(q)
        dlng = -2.0 * self.a * q
        d2lng = torch.full_like(q, -2.0 * self.a)
        br2 = self.b ** 2 / r2
        br5 = br2 ** 2 * torch.sqrt(br2)
        br52 = br5 / r2
        gi = -2.5 * br52[..., None] * d
        dlng = dlng.index_add(-2, i, gi)
        d2 = 2.5 * br52[..., None] * (1.0 - 7.0 * d * d / r2[..., None])
        d2lng = d2lng.index_add(-2, i, d2)
        tloc = -0.5 / self.mass * torch.sum(d2lng + dlng * dlng,
                                            dim=(-2, -1))
        vloc = 0.5 * torch.sum(hfdbhe(r2), dim=-1)
        return tloc, vloc

    def energy_per_atom_K(self, q):
        t, v = self.local_energy(q)
        return (t + v) / (K_PER_ATOM * self.natoms)

    # ------------------------------------------------------- sampling

    def draws(self, gen, nsweeps, nwalkers, mode="peratom", exchange=False):
        """The draws of ``nsweeps`` sweeps from ``gen``, on its device: the
        displacement normals (nsweeps, nw, N, 3) and the acceptance
        uniforms (nsweeps, nw, N) per-atom, (nsweeps, nw) all-atom; with
        ``exchange`` the stencil pair (nsweeps, nw) integers in [0, P) and
        its uniform (nsweeps, nw)."""
        nw, N = nwalkers, self.natoms
        kw = dict(generator=gen, device=gen.device, dtype=torch.float64)
        out = (torch.randn((nsweeps, nw, N, 3), **kw),
               torch.rand((nsweeps, nw, N) if mode == "peratom"
                          else (nsweeps, nw), **kw))
        if exchange:
            out += (torch.randint(0, self.ipairs.shape[0], (nsweeps, nw),
                                  generator=gen, device=gen.device),
                    torch.rand((nsweeps, nw), **kw))
        return out

    def _sweep_peratom(self, q, lp, z, uu, step):
        """Sequential per-atom Metropolis sweep of every walker: atom n
        moves by step * z[:, n], accepted when log u < 2 (lp' - lp)."""
        disp = step * z
        us = torch.log(uu)
        accs = []
        for n in range(self.natoms):
            prop = q.clone()
            prop[:, n] += disp[:, n]
            lp_new = self.log_psi(prop)
            acc = us[:, n] < 2.0 * (lp_new - lp)
            q = torch.where(acc[:, None, None], prop, q)
            lp = torch.where(acc, lp_new, lp)
            accs.append(acc)
        return q, lp, torch.mean(torch.stack(accs, 1).to(q.dtype), dim=1)

    def _sweep_allatom(self, q, lp, z, u, step):
        """One all-atom Metropolis move of every walker."""
        prop = q + step * z
        lp_new = self.log_psi(prop)
        acc = torch.log(u) < 2.0 * (lp_new - lp)
        return (torch.where(acc[:, None, None], prop, q),
                torch.where(acc, lp_new, lp), acc.to(q.dtype))

    def _exchange(self, q, lp, n, u):
        """Permutation-exchange move of every walker on stencil pair
        ``n``: sites i and j swap their atoms (absolute positions fixed),
        q_i' = q_j + R_ij and q_j' = q_i - R_ij, accepted on the full
        trial for exact detailed balance."""
        i_all, j_all, R_all = self._pairs_on(q.device)
        i, j, R = i_all[n], j_all[n], R_all[n]
        w = torch.arange(q.shape[0], device=q.device)
        q_new = q.clone()
        q_new[w, i] = q[w, j] + R
        q_new[w, j] = q[w, i] - R
        lp_new = self.log_psi(q_new)
        acc = torch.log(u) < 2.0 * (lp_new - lp)
        return (torch.where(acc[:, None, None], q_new, q),
                torch.where(acc, lp_new, lp), acc.to(q.dtype))

    def sweep_fn(self, step, mode="peratom", exchange=False):
        """``sweep((q, lp), *draws) -> ((q, lp), (e, acc, eacc))``: one
        sweep of every walker (then, with ``exchange``, one exchange
        attempt each) on one sweep of :meth:`draws`; ``e`` the mean local
        energy [K/atom], ``acc``/``eacc`` each walker's acceptance."""
        move = (self._sweep_peratom if mode == "peratom"
                else self._sweep_allatom)

        def sweep(state, z, u, *ex):
            q, lp = state
            q, lp, acc = move(q, lp, z, u, step)
            if exchange:
                q, lp, eacc = self._exchange(q, lp, *ex)
            else:
                eacc = torch.zeros_like(acc)
            t, v = self.local_energy(q)
            e = torch.mean(t + v) / (K_PER_ATOM * self.natoms)
            return (q, lp), (e, acc, eacc)

        return sweep

    def sweeps(self, q0, draws, flags, step=0.5, mode="peratom"):
        """Sweeps on given draws: ``draws`` the tuple of :meth:`draws` with
        ``exchange=True`` (its exchange draws read only where ``flags``,
        (nsweeps,) bools, is set), ``q0`` (nw, N, 3). Consecutive sweeps
        with the same flag run through one of two :class:`GraphScan`s,
        kept on the solver for the next call with this step and mode.
        Returns ((q, lp), e (nsweeps,), acc (nsweeps, nw), eacc
        (nsweeps, nw))."""
        q = self._q(q0)
        key = (step, mode)
        if key not in self._scans:
            self._scans[key] = {f: GraphScan(self.sweep_fn(step, mode, f))
                                for f in (False, True)}
        scans = self._scans[key]
        state = (q, self.log_psi(q))
        flags = np.asarray(flags, bool)
        es, accs, eaccs = [], [], []
        start = 0
        while start < len(flags):
            f = bool(flags[start])
            stop = start + 1
            while stop < len(flags) and flags[stop] == f:
                stop += 1
            block = [torch.as_tensor(d[start:stop], device=q.device)
                     for d in (draws if f else draws[:2])]
            state, (e, acc, eacc) = scans[f](state, *block)
            es.append(e)
            accs.append(acc)
            eaccs.append(eacc)
            start = stop
        if not es:
            return state, None, None, None
        return state, torch.cat(es), torch.cat(accs), torch.cat(eaccs)

    def run(self, key, nwalkers=64, nsweeps=500, nequil=100, step=0.5,
            mode="peratom", exchange_prob=0.0, mesh=None, q0=None):
        """Batched VMC. Returns a dict with e_trace (nsweeps,) [K/atom],
        energy mean/err over post-equilibration sweeps, acceptance, the
        exchange acceptance count and the final walkers, NumPy as in the
        JAX package. ``key`` is an integer seed of a generator on the
        solver's device; ``q0`` optional (nwalkers, natoms, 3) restart
        configurations (a previous run's ``out['walkers']``, either
        package's)."""
        if mesh is not None:
            raise not_yet_ported("QSATS.run(mesh=...)")
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(int(key))
        if q0 is None:
            # start tight around the lattice (0.3x the Einstein width)
            q0 = (0.3 * torch.randn((nwalkers, self.natoms, 3),
                                    generator=gen, device=dev,
                                    dtype=torch.float64)
                  / np.sqrt(4.0 * self.a))
        else:
            q0 = torch.as_tensor(np.array(q0, dtype=np.float64),
                                 device=dev)
            nwalkers = q0.shape[0]
        exch_flags = (np.random.default_rng(0).random(nsweeps)
                      < exchange_prob)
        state = q0
        es, accs, eaccs = [], [], []
        for start in range(0, nsweeps, BLOCK):
            flags = exch_flags[start:start + BLOCK]
            draws = self.draws(gen, len(flags), nwalkers, mode,
                               exchange=bool(flags.any()))
            (q, _), e, acc, eacc = self.sweeps(state, draws, flags, step,
                                               mode)
            state = q
            es.append(e)
            accs.append(acc)
            eaccs.append(eacc)
        e_tr = torch.cat(es).cpu().numpy()
        acc_tr = torch.cat(accs).mean(dim=1).cpu().numpy()
        eacc_tr = torch.cat(eaccs).mean(dim=1).cpu().numpy()
        post = e_tr[nequil:]
        nb = max(len(post) // 16, 1)
        blocks = np.array([b.mean() for b in np.array_split(post, nb)])
        return {
            "e_trace": e_tr,
            "energy": float(post.mean()),
            "error": float(blocks.std(ddof=1) / np.sqrt(len(blocks)))
            if len(blocks) > 1 else 0.0,
            "acceptance": float(acc_tr.mean()),
            "exchange_acceptance": float(eacc_tr.sum()),
            "walkers": q.cpu().numpy(),
        }

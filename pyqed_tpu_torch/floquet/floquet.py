"""Floquet theory for periodically driven systems (PyTorch).

Counterpart of ``pyqed_tpu/floquet/floquet.py`` (reference:
pyqed/floquet/Floquet.py — ``TightBinding:26``, ``FloquetBloch:384``
(``build_extendedH:495`` Peierls/Bessel-dressed extended-zone
Hamiltonian), ``track_band:629``, ``run:771``, ``winding_number:869``,
``subspace_winding:933`` Wilson loop).

Every k-point of a Brillouin-zone grid is one entry of a batched
``torch.linalg.eigh`` on ``device`` (the card when None); the Fourier
blocks of each k are built on the host (Bessel factors from
``scipy.special.jv``), the Sambe-space matrices in one batched gather.
Band tracking picks states by overlap with one batched product per field
step. ``floquet_states`` keeps its selection of the physical states on
the host, in NumPy.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor


def _host(a):
    """A tensor or array as NumPy."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class TightBinding:
    """1D tight-binding chain with exponentially decaying hoppings
    (reference: pyqed/floquet/Floquet.py:26). ``buildH(k)`` returns the
    Bloch Hamiltonian; ``run`` diagonalises a k grid on ``device``."""

    def __init__(self, coords, hopping=None, lattice_constant=1.0, nk=50,
                 mu=0.0, lambda_decay=1.0, device=None):
        self.device = resolve_device(device)
        self.coords = np.atleast_2d(np.asarray(coords, dtype=float))
        self.norbs = self.coords.shape[0]
        self.a = lattice_constant
        self.mu = mu
        self.lambda_decay = lambda_decay
        self.nk = nk
        self.hopping = {} if hopping is None else hopping

    def hop_list(self):
        """All (i, j, displacement, t) hops: intracell (i<j) plus the
        intercell wrap of each pair."""
        hops = []
        for i in range(self.norbs):
            for j in range(self.norbs):
                if j > i:
                    d = self.coords[j, 0] - self.coords[i, 0]
                    t = self.hopping.get((i, j),
                                         np.exp(-abs(d) / self.lambda_decay))
                    hops.append((i, j, d, t))
                    d2 = d - np.sign(d) * self.a if d != 0 else d + self.a
                    t2 = self.hopping.get((j, i),
                                          np.exp(-abs(d2) / self.lambda_decay))
                    hops.append((i, j, d2, t2))
        if self.norbs == 1:
            t = self.hopping.get((0, 0), np.exp(-self.a / self.lambda_decay))
            hops.append((0, 0, self.a, t))
        return hops

    def _bloch(self, ks):
        """H(k) for every k of ``ks`` (NumPy, (nk, norbs, norbs))."""
        ks = np.asarray(ks, dtype=float)
        H = np.zeros((len(ks), self.norbs, self.norbs), complex)
        for (i, j, d, t) in self.hop_list():
            if i == j:
                H[:, i, i] += t * 2 * np.cos(ks * d)
            else:
                phase = np.exp(1j * ks * d)
                H[:, i, j] += t * phase
                H[:, j, i] += t * np.conj(phase)
        return H - self.mu * np.eye(self.norbs)

    def buildH(self, k):
        """Bloch Hamiltonian H(k) (reference: pyqed/floquet/Floquet.py:293)."""
        return torch.as_tensor(self._bloch([float(k)])[0], device=self.device)

    def run(self, k=None):
        """Band structure over the BZ grid — one batched eigvalsh."""
        if k is None:
            k = np.linspace(-np.pi / self.a, np.pi / self.a, self.nk)
        Hk = torch.as_tensor(self._bloch(_host(k)), device=self.device)
        self.k = torch.as_tensor(_host(k), device=self.device)
        self.bands = torch.linalg.eigvalsh(Hk)
        return self.k, self.bands

    def band_gap(self):
        if not hasattr(self, "bands"):
            self.run()
        return float((self.bands[:, 1] - self.bands[:, 0]).min())


def floquet_matrix(Hblocks, omega, nt, device=None):
    """Sambe-space extended Hamiltonian from Fourier blocks.

    Hblocks: (..., 2*N0+1, norbs, norbs) with Hblocks[..., p + N0] = H^{(p)}
    (Fourier component of H(t) = sum_p H^{(p)} e^{+i p omega t}); leading
    axes batch. Returns the (..., norbs*nt, norbs*nt) quasi-energy matrix
    F_{(m i),(n j)} = H^{(m-n)}_{ij} + m omega delta_mn delta_ij on
    ``device``, the card when None (reference:
    pyqed/floquet/Floquet.py:495).
    """
    Hb = as_tensor(Hblocks).to(resolve_device(device))
    P, norbs = Hb.shape[-3], Hb.shape[-1]
    N0 = (nt - 1) // 2
    ms = torch.arange(-N0, N0 + 1, device=Hb.device)
    dm = ms[:, None] - ms[None, :]
    idx = torch.clamp(dm + (P - 1) // 2, 0, P - 1)
    valid = dm.abs() <= (P - 1) // 2
    blocks = torch.where(valid[..., None, None], Hb[..., idx, :, :],
                         torch.zeros((), dtype=Hb.dtype, device=Hb.device))
    F = blocks.transpose(-3, -2).reshape(Hb.shape[:-3] + (nt * norbs,
                                                          nt * norbs))
    diag = torch.kron(torch.diag(ms.to(torch.float64)) * omega,
                      torch.eye(norbs, dtype=torch.float64, device=Hb.device))
    return F + diag.to(F.dtype)


class FloquetBloch:
    """Periodically driven Bloch system in the extended (Sambe) zone.

    Parameters
    ----------
    hk_blocks : callable (k, E0) -> (2*N0+1, norbs, norbs)
        Fourier blocks of the driven Bloch Hamiltonian at momentum k.
    omegad : float
        driving frequency.
    nt : int
        number of Floquet harmonics (odd).
    norbs : int
        orbitals per cell.
    device : where the extended-zone matrices are diagonalised (the card
        when None).
    """

    def __init__(self, hk_blocks: Callable, omegad, nt, norbs,
                 Hk_func: Optional[Callable] = None, device=None):
        self.device = resolve_device(device)
        self.hk_blocks = hk_blocks
        self.omegad = float(omegad)
        self.nt = int(nt)
        self.norbs = int(norbs)
        self.Hk_func = Hk_func
        self.k = None

    def build_extendedH(self, kpt, E0):
        """(reference: pyqed/floquet/Floquet.py:495)."""
        return floquet_matrix(self.hk_blocks(kpt, E0), self.omegad, self.nt,
                              device=self.device)

    def _extended(self, ks, E0):
        """The extended-zone matrices of every k, (Nk, NF, NF)."""
        blocks = torch.stack([as_tensor(self.hk_blocks(k, E0))
                              for k in _host(ks)])
        return floquet_matrix(blocks, self.omegad, self.nt,
                              device=self.device)

    def quasienergies(self, ks, E0, first_bz=True):
        """Quasi-energy spectrum over a k grid — one batched eigvalsh."""
        evals = torch.linalg.eigvalsh(self._extended(ks, E0))
        if first_bz:
            w = self.omegad
            evals = torch.remainder(evals + w / 2, w) - w / 2
        return evals

    def track_band(self, k_values, E0, quasienergy=None, previous_state=None,
                   band_index=None):
        """Select the physical bands in the first Floquet BZ for every k.

        At E0 = 0 bands are matched to the static band energies (reference:
        pyqed/floquet/Floquet.py:652-695); at E0 != 0 each band follows the
        state of maximal overlap with ``previous_state`` (adiabatic
        continuation in field strength). Returns (band_energy (Nk, norbs),
        states (norbs, Nk, NF))."""
        evals, evecs = torch.linalg.eigh(self._extended(k_values, E0))
        NF = evecs.shape[-1]
        if previous_state is None:
            if self.Hk_func is None:
                raise ValueError("need Hk_func for the E0=0 seed bands")
            Hk = torch.stack([as_tensor(self.Hk_func(k))
                              for k in _host(k_values)]).to(self.device)
            ref_E = torch.linalg.eigvalsh(Hk)                # (Nk, norbs)
            idx = torch.argmin((evals[:, None, :] - ref_E[:, :, None]).abs(),
                               dim=2)
        else:
            prev = as_tensor(previous_state).to(self.device)  # (norbs,Nk,NF)
            ov = torch.einsum("kbn, knm -> kbm", prev.transpose(0, 1).conj(),
                              evecs).abs()
            idx = torch.argmax(ov, dim=2)                    # (Nk, norbs)
        band_E = torch.gather(evals, 1, idx)
        states = torch.gather(evecs, 2, idx[:, None, :].expand(-1, NF, -1))
        return band_E, states.permute(2, 0, 1)

    def run(self, k, E0=None, nE_steps=10, calculated_bands=None):
        """Ramp the field from 0 to E0 over nE_steps, tracking bands by
        overlap (reference: pyqed/floquet/Floquet.py:771). Returns
        (quasienergy (Nk, norbs), states (norbs, Nk, NF))."""
        self.k = np.asarray(k)
        if np.isscalar(E0):
            E_list = np.linspace(0.0, E0, nE_steps)
        else:
            E_list = np.asarray(E0)
            if E_list[0] != 0:
                E_list = np.concatenate([[0.0], E_list])
        qe, states = self.track_band(k, 0.0)
        for E in E_list[1:]:
            qe, states = self.track_band(k, E, previous_state=states)
        self.quasienergy = qe
        self.states = states
        return qe, states

    def winding_number(self, band, states=None):
        """Berry phase (in units of pi) of one tracked band around the BZ
        from the product of neighbouring overlaps (reference:
        pyqed/floquet/Floquet.py:869-931)."""
        if states is None:
            states = self.states
        vecs = as_tensor(states[band])                       # (Nk, NF)
        vecs = vecs / torch.linalg.norm(vecs, dim=1, keepdim=True)
        ov = (vecs.conj() * torch.roll(vecs, -1, dims=0)).sum(dim=1)
        angle = torch.angle(torch.prod(ov))
        return float(torch.remainder(angle, 2 * np.pi) / np.pi)

    def subspace_winding(self, bands, states=None):
        """Multi-band Wilson loop winding (reference:
        pyqed/floquet/Floquet.py:933-1001): QR gauge fixing per k, overlap
        product around the loop, winding = arg det(W)/2pi."""
        if states is None:
            states = self.states
        psi = torch.stack([as_tensor(states[b]) for b in bands], dim=-1)
        Q, _ = torch.linalg.qr(psi)                          # (Nk, NF, nsub)
        U = torch.einsum("knm, knj -> kmj", Q.conj(), torch.roll(Q, -1, 0))
        W = torch.eye(len(bands), dtype=U.dtype, device=U.device)
        for Uk in U:
            W = W @ Uk
        phase = torch.remainder(torch.angle(torch.linalg.det(W)), 2 * np.pi)
        return int(round(float(phase / (2 * np.pi))))


def gomez_leon_model(b=0.5, t=1.0, a=1.0):
    """Driven dimerized chain of Gomez-Leon & Platero PRL 110, 200403 (2013)
    (the reference's validation model, pyqed/floquet/Floquet.py:1004).

    Two orbitals at 0 and b*a: intracell hop over +b*a (no Bloch phase),
    intercell hop over (b-1)*a with lattice shift -a. Returns
    (hops, Hk_func); feed hops to :func:`make_peierls_blocks_fn`."""
    hops = [
        (0, 1, b * a, 0.0, t),        # intracell, displacement b*a
        (0, 1, (b - 1.0) * a, -a, t),  # intercell wrap
    ]

    def Hk(k):
        h01 = t + t * np.exp(-1j * float(k) * a)
        return torch.as_tensor(np.array([[0.0, h01], [np.conj(h01), 0.0]]))

    return hops, Hk


def make_peierls_blocks_fn(hops, omegad, nmax):
    """hk_blocks(k, E0) for :class:`FloquetBloch` from a 1D hop list
    [(i, j, d, R, t), ...]: H^{(p)}_{ij}(k) = t J_p(E0 d/omega) e^{ikR},
    H^{(p)}_{ji}(k) = t J_{-p}(E0 d/omega) e^{-ikR} (reference:
    pyqed/floquet/Floquet.py:539-547). The blocks are CPU tensors, built in
    NumPy with ``scipy.special.jv``."""
    from scipy.special import jv

    norbs = int(max(max(h[0], h[1]) for h in hops)) + 1
    P = 2 * nmax + 1
    hop_i = [h[0] for h in hops]
    hop_j = [h[1] for h in hops]
    hop_d = np.array([h[2] for h in hops])
    hop_R = np.array([h[3] for h in hops])
    hop_t = np.array([h[4] for h in hops])
    ps = np.arange(-nmax, nmax + 1)

    def hk_blocks(k, E0):
        x = E0 / omegad * hop_d                      # (nh,)
        J = jv(ps[:, None], x[None, :])              # (P, nh)
        Jm = J[::-1]                                 # J_{-p}
        phase = np.exp(1j * float(k) * hop_R)        # (nh,)
        blocks = np.zeros((P, norbs, norbs), complex)
        for h in range(len(hops)):
            blocks[:, hop_i[h], hop_j[h]] += hop_t[h] * J[:, h] * phase[h]
            blocks[:, hop_j[h], hop_i[h]] += (hop_t[h] * Jm[:, h]
                                              * np.conj(phase[h]))
        return torch.as_tensor(blocks)

    return hk_blocks


def floquet_states(Hblocks, omega, nt, device=None):
    """Floquet modes and quasienergies in the first Brillouin zone
    [-omega/2, omega/2) from the extended-zone Hamiltonian (reference:
    pyqed/floquet/FloquetBloch.py:72 ``FloquetHamilton``), diagonalised on
    ``device`` (the card when None); the selection of one state per
    system level runs on the host.

    Hblocks: centred Fourier-block stack (2*N0+1, norb, norb), the
    :func:`floquet_matrix` convention; nt = Fourier components kept.
    Returns (eps (norb,), modes (nt, norb, norb)) on ``device``:
    modes[m, :, a] is the m-th Fourier component of Floquet state a.
    """
    dev = resolve_device(device)
    Hb = as_tensor(Hblocks).to(dev)
    norb = Hb.shape[-1]
    w, V = torch.linalg.eigh(floquet_matrix(Hb, omega, nt, device=dev))
    w, V = _host(w), _host(V)
    sel = np.where((w >= -omega / 2) & (w < omega / 2))[0]
    if len(sel) != norb:
        # Quasienergies at the BZ edge: +-omega/2 are one physical state
        # shifted by one photon, so "norb closest to zero" can pick two
        # replicas of the same state. Greedily select candidates whose
        # t=0 mode sums are linearly independent.
        cand = np.argsort(np.abs(w))
        phi = V.reshape(nt, norb, -1).sum(axis=0)      # (norb, ncand)
        sel_list, basis = [], np.zeros((norb, 0))
        for i in cand:
            v = phi[:, i]
            nv = np.linalg.norm(v)
            if nv < 1e-12:
                continue
            v = v / nv
            resid = v - basis @ (basis.conj().T @ v)
            if np.linalg.norm(resid) > 1e-6:           # new physical state
                sel_list.append(i)
                basis = np.column_stack([basis, resid / np.linalg.norm(resid)])
            if len(sel_list) == norb:
                break
        if len(sel_list) != norb:
            raise ValueError(
                "floquet_states: could not select norb linearly independent "
                "Floquet states (degenerate BZ-edge quasienergies); increase "
                "nt or shift omega slightly.")
        sel = np.asarray(sel_list)
    eps = w[sel]
    modes = V[:, sel].reshape(nt, norb, norb)
    return torch.as_tensor(eps, device=dev), torch.as_tensor(modes, device=dev)


def floquet_evolution(Hblocks, omega, nt, psi0, times, device=None):
    """Exact evolution of a periodically driven system through its Floquet
    decomposition, on ``device`` (the card when None):

        psi(t) = sum_a c_a e^{-i eps_a t} phi_a(t),
        phi_a(t) = sum_m modes[m, :, a] e^{+i (m - m0) w t}

    with c fixed by psi(0) = psi0 (reference:
    pyqed/floquet/FloquetBloch.py:129-140). Returns psis (len(times), norb).
    """
    eps, modes = floquet_states(Hblocks, omega, nt, device=device)
    modes = modes.to(torch.complex128)
    m0 = (nt - 1) // 2
    phi0 = modes.sum(dim=0)                          # (norb, norb)
    c = torch.linalg.solve(phi0, as_tensor(psi0).to(phi0.device, phi0.dtype))
    times = as_tensor(np.asarray(_host(times), float)).to(phi0.device)
    mph = torch.exp(1j * (torch.arange(nt, dtype=torch.float64,
                                       device=phi0.device) - m0)[:, None]
                    * omega * times[None, :])        # (nt, T)
    phit = torch.einsum("mka, mt -> tka", modes, mph)
    return torch.einsum("tka, a, ta -> tk", phit, c,
                        torch.exp(-1j * eps[None, :] * times[:, None]))


class Floquet:
    """Finite N-level system under a monochromatic dipole drive,

        H(t) = H0 - E0 cos(omegad t) mu,

    solved exactly by Sambe-space diagonalisation on ``device`` (the card
    when None). The cosine drive contributes the m = +-1 Fourier blocks
    H^{(+-1)} = -(E0/2) mu in the convention of :func:`floquet_matrix`.
    """

    def __init__(self, H, edip, omegad, E0, nt=31, device=None):
        self.device = resolve_device(device)
        self.H = as_tensor(H).to(self.device)
        self.edip = as_tensor(edip).to(self.device)
        self.omegad = float(omegad)
        self.E0 = float(E0)
        if nt % 2 == 0:
            nt += 1
        self.nt = int(nt)
        self.norb = self.H.shape[0]

    @classmethod
    def from_reference(cls, ref, device=None):
        """The port's Floquet problem with the operators and drive of a JAX
        ``Floquet`` ``ref``."""
        return cls(np.asarray(ref.H), np.asarray(ref.edip), ref.omegad,
                   ref.E0, nt=ref.nt, device=device)

    def _blocks(self):
        drive = (-0.5 * self.E0) * self.edip.to(torch.complex128)
        return torch.stack([drive, self.H.to(torch.complex128), drive])

    def extended_hamiltonian(self):
        """The truncated Sambe-space (extended-zone) Hamiltonian."""
        return floquet_matrix(self._blocks(), self.omegad, self.nt,
                              device=self.device)

    def quasienergies(self, first_bz=True):
        w = torch.linalg.eigvalsh(self.extended_hamiltonian())
        if first_bz:
            om = self.omegad
            w = torch.remainder(w + om / 2, om) - om / 2
        return w

    def states(self):
        """(quasienergies (norb,), modes (nt, norb, norb)) in the first
        Floquet BZ — the physical set, one per system state."""
        return floquet_states(self._blocks(), self.omegad, self.nt,
                              device=self.device)

    def run(self, psi0, times):
        """Exact driven evolution psi(t) via the Floquet decomposition (no
        time stepping — arbitrary t, stroboscopic or not)."""
        return floquet_evolution(self._blocks(), self.omegad, self.nt, psi0,
                                 times, device=self.device)

    evolve = run

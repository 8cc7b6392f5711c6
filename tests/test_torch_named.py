"""Parity of the PyTorch port's named models (pyqed_tpu_torch:
models/named.py — oscillators, spin chains, Frenkel excitons, the
displaced oscillator, Franck-Condon factors) with the JAX package, on the
CPU at complex128.

These are host-side constructors: the operators and grid functions of both
packages are compared entry by entry (rel 1e-12), spectra through their
eigenvalues (rel 1e-10), never through eigenvectors.
"""
import numpy as np
import pytest
import torch

from pyqed_tpu.models import named as jn

import pyqed_tpu_torch as pt
from pyqed_tpu_torch.models import named as tn

RTOL = 1e-12


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def rel_err(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


X = np.linspace(-3.0, 5.0, 41)


def test_oscillators():
    for n in range(4):
        jh, th = jn.HarmonicOscillator(1.3, 0.8, 0.2), \
            tn.HarmonicOscillator(1.3, 0.8, 0.2)
        assert rel_err(th.eigenstate(X, n), jh.eigenstate(X, n)) <= RTOL
        assert th.eigval(n) == jh.eigval(n)
        jm, tm = jn.Morse(3.0, 0.7, 0.5, 2.0), tn.Morse(3.0, 0.7, 0.5, 2.0)
        assert rel_err(tm.eigenstate(X, n), jm.eigenstate(X, n)) <= RTOL
        assert tm.eigval(n) == jm.eigval(n)
    assert tm.nbound() == jm.nbound()
    assert rel_err(th.potential(X), jh.potential(X)) <= RTOL
    assert rel_err(tm.potential(X), jm.potential(X)) <= RTOL


def test_spin_chains():
    jt, tt = jn.TFIM(5, J=1.0, h=0.7), tn.TFIM(5, J=1.0, h=0.7)
    assert rel_err(tt.buildH(), jt.buildH()) <= RTOL
    Ej, _ = jt.ground_state()
    Et, psi = tt.ground_state(device="cpu")
    assert abs(float(Et) - float(Ej)) <= 1e-10 * abs(float(Ej))
    assert abs(torch.linalg.vector_norm(psi).item() - 1.0) <= 1e-12
    jh = jn.HeisenbergModel(4, Jx=0.8, Jy=1.1, Jz=0.5, h=0.3)
    th = tn.HeisenbergModel(4, Jx=0.8, Jy=1.1, Jz=0.5, h=0.3)
    assert rel_err(th.buildH(), jh.buildH()) <= RTOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tn.TFIM(2).ground_state()


@pytest.mark.parametrize("name,args", [
    ("Frenkel", (1.0, 0.1, 3)),
    ("Frenkel2", ([1.0, 1.4], [0.1, 0.05], 2)),
    ("Frenkel2s", ([1.0, 1.4], [0.1, 0.05], 4)),
    ("DHO", (2.0, 0.3, 1.2, 6)),
])
def test_mol_subclasses(name, args):
    j, t = getattr(jn, name)(*args), getattr(tn, name)(*args)
    assert isinstance(t, pt.Mol)
    assert rel_err(t.H, j.H) <= RTOL
    assert rel_err(t.edip, j.edip) <= RTOL
    assert rel_err(t.lowering, j.lowering) <= RTOL
    if hasattr(j, "lowering_ops"):
        assert len(t.lowering_ops) == len(j.lowering_ops)
        for a, b in zip(t.lowering_ops, j.lowering_ops):
            assert rel_err(a, b) <= RTOL
    for attr in ("nsites", "dim", "huang_rhys"):
        if hasattr(j, attr):
            assert getattr(t, attr) == getattr(j, attr)
    assert tn.Frenkel2_s is tn.Frenkel2s


def test_frenkel2s_is_the_single_excitation_block_of_frenkel2():
    full = tn.Frenkel2([1.0, 1.4], [0.1, 0.05], 3)
    s = tn.Frenkel2s([1.0, 1.4], [0.1, 0.05], 3)
    E1 = torch.linalg.eigvalsh(s.H)
    Ef = torch.linalg.eigvalsh(full.H)
    # ground 0, then the 2n single excitations below 2 * 1.0
    assert torch.allclose(E1, Ef[:len(E1)], atol=1e-12)


def test_franck_condon():
    for args in ((0, 1.0, 2, 1.0, 0.8), (1, 0.9, 1, 1.2, -0.5)):
        assert abs(tn.franck_condon(*args) - jn.franck_condon(*args)) <= 1e-12
    assert tn.FranckCondon is tn.franck_condon
    for n in range(4):
        assert tn.franck_condon_analytic(n, 0.6) == \
            jn.franck_condon_analytic(n, 0.6)
    # <0|n>^2 of equal-frequency oscillators is Poisson in S = d^2/2
    d = 0.9
    assert abs(tn.franck_condon(0, 1.0, 2, 1.0, d) ** 2
               - tn.franck_condon_analytic(2, d ** 2 / 2)) <= 1e-10

"""Result container for the solvers.

PyTorch counterpart of ``pyqed_tpu/core/result.py``: a plain dataclass of
torch tensors, left on the device the solver ran on. ``states`` is one
stacked tensor ``(nwindows+1, ...)``; serialization is NPZ.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Result:
    times: Optional[torch.Tensor] = None
    observables: Optional[torch.Tensor] = None  # (nwindows+1, n_e_ops)
    states: Optional[torch.Tensor] = None       # (nwindows+1, ...) stacked
    psi0: Optional[torch.Tensor] = None
    rho0: Optional[torch.Tensor] = None
    psi: Optional[torch.Tensor] = None          # final state
    rho: Optional[torch.Tensor] = None
    ado: Optional[torch.Tensor] = None          # final HEOM ADO stack
    dt: Any = None
    nt: Any = None
    nout: Any = 1
    description: Any = None

    # -- reference-compatible views ------------------------------------
    @property
    def psilist(self):
        return None if self.states is None else list(self.states)

    @property
    def rholist(self):
        return None if self.states is None else list(self.states)

    def expect(self):
        return self.observables

    # -- serialization -------------------------------------------------
    def dump(self, fname):
        """Save every tensor and scalar field to NPZ (tensors are copied
        to the host)."""
        payload = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                payload[f.name] = v.detach().cpu().numpy()
            elif isinstance(v, (int, float, complex, str)):
                payload[f.name] = np.asarray(v)
        np.savez(fname, **payload)

    def save(self, fname):
        self.dump(fname)


def load_result(fname) -> Result:
    """Load a Result saved with :meth:`Result.dump` (tensors on the CPU)."""
    fname = str(fname)
    if not fname.endswith(".npz"):
        fname += ".npz"
    kwargs = {}
    with np.load(fname, allow_pickle=False) as data:
        for key in data.files:
            v = data[key]
            kwargs[key] = v.item() if v.ndim == 0 else torch.from_numpy(v)
    return Result(**kwargs)

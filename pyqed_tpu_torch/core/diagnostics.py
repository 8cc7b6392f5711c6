"""Mid-run checkpoints (PyTorch).

Counterpart of ``save_checkpoint``/``load_checkpoint`` in
``pyqed_tpu/core/diagnostics.py``, in the same file format: one NPZ with
``__step__``, ``__nleaves__``, ``leaf_<i>`` and ``meta_<key>`` entries, so
a checkpoint written by either package loads in the other. The state is a
list of tensors (the JAX package's pytree leaves).
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path, step: int, state, **metadata):
    """Persist (step, list of tensors, metadata) as one .npz (complex-safe,
    no pickle)."""
    leaves = list(state)
    payload = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    payload["__step__"] = np.asarray(step)
    payload["__nleaves__"] = np.asarray(len(leaves))
    for k, v in metadata.items():
        payload[f"meta_{k}"] = np.asarray(v)
    np.savez(path, **payload)
    return path


def load_checkpoint(path):
    """Returns (step, list of CPU tensors, metadata dict of arrays)."""
    path = str(path)
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as z:
        nl = int(z["__nleaves__"])
        leaves = [torch.from_numpy(np.array(z[f"leaf_{i}"]))
                  for i in range(nl)]
        step = int(z["__step__"])
        meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return step, leaves, meta

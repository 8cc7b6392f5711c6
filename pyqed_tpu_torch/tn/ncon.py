"""ncon — network contractor with the standard index-label convention
(PyTorch).

Counterpart of ``pyqed_tpu/tn/ncon.py`` (reference: pyqed/mps/ncon.py:14,
a vendored NumPy implementation with hand-rolled pairwise tensordots).
The label specification is translated once into one ``torch.einsum``
expression, which contracts on the tensors' device.

Convention: positive labels are contracted (equal labels connect legs),
negative labels are open output legs ordered as [-1, -2, ...]
(or ``forder``).
"""
from __future__ import annotations

import string
from typing import Optional, Sequence

import torch

from ..ops.linalg import as_tensor

_SYMS = string.ascii_lowercase + string.ascii_uppercase


def ncon(tensors, labels, order=None, forder: Optional[Sequence] = None):
    """Contract a tensor network.

    tensors : list of tensors (or one tensor); arrays become CPU tensors.
    labels : per-tensor index label lists; positive = contracted,
        negative = open.
    order : accepted for the reference's signature; the contraction
        order is einsum's.
    forder : output ordering of the negative labels
        (default [-1, -2, ...]).
    """
    if hasattr(tensors, "shape"):
        tensors = [tensors]
    tensors = [as_tensor(t) for t in tensors]
    labels = [list(l) for l in labels]
    if len(labels) and not isinstance(labels[0], list):
        labels = [labels]
    if len(tensors) != len(labels):
        raise ValueError(f"{len(tensors)} tensors, {len(labels)} label lists")
    for t, l in zip(tensors, labels):
        if t.dim() != len(l):
            raise ValueError(f"tensor with {t.dim()} legs got labels {l}")

    all_labels = sorted({x for l in labels for x in l})
    pos = [x for x in all_labels if x > 0]
    neg = [x for x in all_labels if x < 0]
    if forder is None:
        forder = sorted(neg, reverse=True)          # -1, -2, ...
    if len(pos) + len(neg) > len(_SYMS):
        raise ValueError("too many distinct labels for einsum")
    sym = {lab: _SYMS[i] for i, lab in enumerate(pos + list(forder))}

    # each positive label must appear exactly twice (pairwise contraction)
    for lab in pos:
        cnt = sum(l.count(lab) for l in labels)
        if cnt != 2:
            raise ValueError(f"contracted label {lab} appears {cnt} times")

    subs = ["".join(sym[x] for x in l) for l in labels]
    out = "".join(sym[x] for x in forder)
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.einsum(",".join(subs) + "->" + out,
                        *[t.to(dtype) for t in tensors])

"""Small neural-network utilities for PES fitting.

Counterpart of ``pyqed_tpu/ml/nn.py``: a multilayer perceptron as a list
of ``(W, b)`` tensors, trained by Adam in the JAX package's own formula
through ``torch.autograd`` (not ``torch.optim``, so the iterates follow
JAX's). ``params_from_numpy`` carries the JAX package's parameters over;
``init_params`` draws from a ``torch.Generator`` seeded by the integer
``key``, or takes the standard normals as ``normals=``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import resolve_device


def init_params(key, layer_dims: Sequence[int], scale=None, device=None,
                normals=None):
    """He-initialised weights ``normal * sqrt(2 / din)`` (or ``scale``)
    and zero biases. ``normals`` is a list of (din, dout) standard
    normals, one per layer, else drawn from ``key`` on ``device`` (the
    card when None)."""
    dev = resolve_device(device)
    dims = list(zip(layer_dims[:-1], layer_dims[1:]))
    if normals is None:
        gen = torch.Generator(device=dev).manual_seed(int(key))
        normals = [torch.randn((din, dout), generator=gen, device=dev,
                               dtype=torch.float64) for din, dout in dims]
    params = []
    for z, (din, dout) in zip(normals, dims):
        s = scale if scale is not None else float(np.sqrt(2.0 / din))
        W = torch.as_tensor(np.array(z, dtype=np.float64)
                            if not isinstance(z, torch.Tensor) else z,
                            device=dev) * s
        params.append((W, torch.zeros(dout, dtype=torch.float64,
                                      device=dev)))
    return params


def params_from_numpy(params, device=None):
    """A list of ``(W, b)`` arrays (the JAX package's parameters) as
    float64 tensors on ``device`` (the card when None)."""
    dev = resolve_device(device)
    return [tuple(torch.as_tensor(np.array(a, dtype=np.float64), device=dev)
                  for a in layer) for layer in params]


def forward(params, x, activation=torch.tanh):
    """MLP forward pass."""
    h = x
    for (W, b) in params[:-1]:
        h = activation(h @ W + b)
    W, b = params[-1]
    return h @ W + b


def mse(params, x, y):
    pred = forward(params, x)
    return torch.mean((pred - y) ** 2)


class MLP:
    """Train an MLP regressor (e.g. a PES fit) with Adam; ``device`` the
    card when None. ``params`` is a list of ``(W, b)`` tensors: assign
    :func:`params_from_numpy` of the JAX package's to start from them."""

    def __init__(self, layer_dims, key=None, activation=torch.tanh,
                 device=None):
        self.device = resolve_device(device)
        self.params = init_params(0 if key is None else key, layer_dims,
                                  device=self.device)
        self.activation = activation

    def _t(self, a):
        return a.to(self.device) if isinstance(a, torch.Tensor) else \
            torch.as_tensor(np.array(a, dtype=np.float64), device=self.device)

    def fit(self, x, y, lr=1e-3, epochs=2000, verbose=False):
        """Adam on the mean squared error, in the JAX package's formula:
        m, v moments with (0.9, 0.999), bias corrections, eps 1e-8."""
        x, y = self._t(x), self._t(y)
        act = self.activation
        p = [tuple(a.detach() for a in layer) for layer in self.params]
        m = [tuple(torch.zeros_like(a) for a in layer) for layer in p]
        v = [tuple(torch.zeros_like(a) for a in layer) for layer in p]
        b1, b2, eps = 0.9, 0.999, 1e-8
        for t in range(1, epochs + 1):
            leaves = [a.requires_grad_(True) for layer in p for a in layer]
            L = torch.mean((forward(p, x, act) - y) ** 2)
            grads = iter(torch.autograd.grad(L, leaves))
            g = [tuple(next(grads) for _ in layer) for layer in p]
            with torch.no_grad():
                m = [tuple(b1 * a + (1 - b1) * gg for a, gg in zip(ml, gl))
                     for ml, gl in zip(m, g)]
                v = [tuple(b2 * a + (1 - b2) * gg ** 2
                           for a, gg in zip(vl, gl))
                     for vl, gl in zip(v, g)]
                p = [tuple(pp - lr * (mm / (1 - b1 ** t))
                           / (torch.sqrt(vv / (1 - b2 ** t)) + eps)
                           for pp, mm, vv in zip(pl, ml, vl))
                     for pl, ml, vl in zip(p, m, v)]
            if verbose and t % max(epochs // 10, 1) == 0:
                print(f"epoch {t}: loss {float(L):.6e}")
        self.params = p
        self.loss_ = float(L.detach())
        return self

    def predict(self, x):
        with torch.no_grad():
            return forward(self.params, self._t(x), self.activation)


NeuralNetwork = MLP

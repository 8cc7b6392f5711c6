"""Differentiable parameter fitting through pyqed_tpu_torch dynamics.

Counterpart of ``pyqed_tpu/control/fit.py`` (no counterpart in the
reference): any scalar built from a solver of the port, a spectrum, a
population trace, a correlation function, is differentiable by
``torch.autograd`` with respect to the parameters that produced it.
``fit`` is the generic gradient loop; ``fit_exponential_decay`` recovers
a decay rate. The JAX package runs its Adam inside one jitted
``lax.scan``; here the loop is on the host and each iteration one
forward and one backward pass on the parameters' device, with Adam
written to the JAX package's formula (b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias-corrected, the operations in the same
order), so the two produce the same iterates to rounding.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["fit", "fit_exponential_decay"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _leaves(p):
    """The tensors of a tensor, a list/tuple of tensors or a dict of
    tensors, in order, and a function that rebuilds the structure."""
    if isinstance(p, dict):
        keys = list(p)
        return [p[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(p, (list, tuple)):
        kind = type(p)
        return list(p), lambda xs: kind(xs)
    return [p], lambda xs: xs[0]


def _param(a, device):
    """A parameter leaf: a tensor is detached and kept on its device; a
    number or array becomes a float64 tensor on ``device`` (the card when
    None, which raises without one)."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    return torch.as_tensor(np.asarray(a, dtype=float),
                           device=resolve_device(device))


def _stack(xs):
    """Stack per-iteration values (tensors, or tuples/lists/dicts of
    them) along a new leading axis."""
    x0 = xs[0]
    if isinstance(x0, dict):
        return {k: _stack([x[k] for x in xs]) for k in x0}
    if isinstance(x0, (list, tuple)):
        return type(x0)(_stack(list(c)) for c in zip(*xs))
    return torch.stack([torch.as_tensor(x) for x in xs])


def fit(loss_fn: Callable, p0, iters: int = 300, learning_rate: float = 0.05,
        optimizer=None, has_aux: bool = False, device=None):
    """Minimize ``loss_fn(params)`` over a tensor, or a list/tuple/dict of
    tensors, of parameters.

    Each iteration evaluates the loss, backpropagates with
    ``torch.autograd`` and updates the parameters: by Adam at
    ``learning_rate`` (the JAX package's formula) when ``optimizer`` is
    None, else by ``optimizer(list_of_parameter_tensors)``, a factory
    returning a ``torch.optim.Optimizer`` (the JAX package takes a
    gradient transformation of its optimizer library here). Nothing is
    read back to the host inside the loop.

    Returns (params_opt, losses) with losses a (iters,) tensor. With
    ``has_aux=True`` the loss function returns (loss, aux) and fit
    returns (params_opt, (losses, auxs)), auxs stacked per iteration.
    """
    leaves, rebuild = _leaves(p0)
    params = [_param(a, device).requires_grad_(True) for a in leaves]
    opt = optimizer(params) if optimizer is not None else None
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, auxs = [], []
    for it in range(1, iters + 1):
        out = loss_fn(rebuild(params))
        val, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(val, params)
        losses.append(val.detach())
        if has_aux:
            auxs.append(torch.utils._pytree.tree_map(
                lambda a: a.detach() if isinstance(a, torch.Tensor) else a,
                aux))
        with torch.no_grad():
            if opt is not None:
                for p, g in zip(params, grads):
                    p.grad = g
                opt.step()
                continue
            c1, c2 = 1.0 - _B1 ** it, 1.0 - _B2 ** it
            for p, g, mi, vi in zip(params, grads, m, v):
                # the JAX package's Adam, operation for operation
                mi.copy_((1.0 - _B1) * g + _B1 * mi)
                vi.copy_((1.0 - _B2) * (g * g) + _B2 * vi)
                u = (mi / c1) / (torch.sqrt(vi / c2) + _EPS)
                p.add_(-learning_rate * u)
    p_opt = rebuild([p.detach() for p in params])
    losses = torch.stack(losses)
    return (p_opt, (losses, _stack(auxs))) if has_aux else (p_opt, losses)


def fit_exponential_decay(t, y, gamma0=0.1, iters=400, learning_rate=0.05,
                          device=None):
    """Fit y(t) ~ exp(-gamma t) for the decay rate gamma (log-parametrized
    so the rate stays positive). Returns (gamma as a float, losses)."""
    dev = resolve_device(device)
    t = torch.as_tensor(np.asarray(t, dtype=float), device=dev)
    y = torch.as_tensor(np.asarray(y, dtype=float), device=dev)

    def loss(log_gamma):
        return torch.mean((torch.exp(-torch.exp(log_gamma) * t) - y) ** 2)

    lg, losses = fit(loss, np.log(gamma0), iters, learning_rate, device=dev)
    return float(torch.exp(lg)), losses

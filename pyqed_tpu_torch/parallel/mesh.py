"""Device meshes and the collectives the sharded solvers call.

Counterpart of ``pyqed_tpu/parallel/mesh.py``. The JAX package builds a
``jax.sharding.Mesh`` and lets GSPMD insert the collectives; here a mesh
is a :class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of
a process group (one process per device: NCCL on the card, gloo on the
CPU), and the sharded solvers hold plain local tensors and call explicit
collectives on the group of one mesh axis (:func:`axis_group`):
``all_gather_single`` or ``all_gather_into_tensor`` (:func:`gather_rows`),
``all_to_all_single``
(:func:`all_to_all`) and ``all_reduce``. Every collective is visible and
countable, and no DTensor dispatch runs in a step.

Axis conventions, as in the JAX package:
  'ado'    — HEOM hierarchy axis (the (nado, n, n) ADO stack)
  'grid'   — first grid axis of wavepacket states (SPO/LDR)
  'omega'  — frequency/delay batch axis of spectroscopy maps
  'walker' — QMC walker/trajectory axis

A sharded axis of length n over d ranks is cut into d chunks of
``ceil(n / d)`` rows (:func:`local_range`); rank r holds rows
[r·c, min((r + 1)·c, n)), and the last ranks' chunks are padded (or
empty) where d does not divide n. Where an algorithm cannot run on a
padded axis (the pencil FFT, the equal-shard estimators of the samplers),
it raises with the shape instead of falling back to a gather.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["make_mesh", "shard_along", "replicated", "with_sharding",
           "pad_to_multiple", "check_mesh", "axis_group", "local_range",
           "gather_rows", "all_to_all", "all_reduce_sum", "rank0_write"]


def check_mesh(mesh):
    """``mesh`` if it is None or a DeviceMesh, else a TypeError (the
    ``mesh=`` argument of the sharded solvers)."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(pyqed_tpu_torch.parallel.make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


def _device_type(devices=None):
    """The mesh's device type: ``devices`` (a type string or a device) if
    given, else the default group's (gloo: cpu, nccl: cuda), else the
    card."""
    import torch.distributed as dist
    if devices is not None:
        if isinstance(devices, (list, tuple)):
            devices = devices[0]
        return torch.device(devices).type
    if dist.is_initialized():
        return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    from ..config import resolve_device
    return resolve_device(None).type


def _start_single(device_type):
    """A one-rank process group on ``device_type`` (an in-process store,
    no port): gloo on the CPU, NCCL on the card."""
    import torch.distributed as dist
    if device_type == "cuda":
        from ..config import resolve_device
        resolve_device("cuda")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), world_size=1, rank=0)


def make_mesh(axis_sizes: Optional[dict] = None, devices=None):
    """A :class:`DeviceMesh` from {axis_name: size} over the ranks of the
    default process group. The sizes must multiply to the world size; one
    axis may be -1 to absorb the rest. None gives one axis 'ado' over all
    ranks. ``devices`` is the device type ('cuda' or 'cpu', or a device);
    None takes the default group's, or the card.

    Without a process group, sizes that multiply to 1 start a one-rank
    group on that device (gloo on the CPU, NCCL on the card), so
    ``make_mesh()`` runs on one card as the JAX package's does on one
    chip; larger sizes need :func:`~pyqed_tpu_torch.parallel.
    ensure_distributed` (or ``init_process_group``) first."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size() if dist.is_initialized() else None
    if axis_sizes is None:
        axis_sizes = {"ado": n or 1}
    names = list(axis_sizes.keys())
    sizes = [int(s) for s in axis_sizes.values()]
    world = n if n is not None else 1
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh sizes {sizes} do not multiply to {world} "
                         "ranks" + ("" if n is not None else
                                    " (no process group is started)"))
    dtype = _device_type(devices)
    if n is None:
        _start_single(dtype)
    return init_device_mesh(dtype, tuple(sizes), mesh_dim_names=tuple(names))


def shard_along(mesh, axis_name: str, ndim: int, array_axis: int = 0):
    """DTensor placements (one per mesh dimension) putting array axis
    ``array_axis`` of an ``ndim``-dimensional tensor on mesh axis
    ``axis_name`` and replicating it over the others."""
    from torch.distributed.tensor import Replicate, Shard
    if not 0 <= array_axis < ndim:
        raise ValueError(f"array_axis {array_axis} outside a {ndim}-d "
                         "tensor")
    return [Shard(array_axis) if name == axis_name else Replicate()
            for name in mesh.mesh_dim_names]


def replicated(mesh, ndim: int):
    """DTensor placements replicating a tensor over every mesh axis."""
    from torch.distributed.tensor import Replicate
    return [Replicate() for _ in mesh.mesh_dim_names]


def axis_group(mesh, axis_name=None):
    """(process group, rank in it, its size) of one mesh axis (the first
    when None)."""
    if axis_name is None:
        axis_name = mesh.mesh_dim_names[0]
    return (mesh.get_group(axis_name), mesh.get_local_rank(axis_name),
            mesh.size(mesh.mesh_dim_names.index(axis_name)))


def local_range(n: int, rank: int, size: int):
    """(lo, hi, chunk): the rows [lo, hi) of an axis of length ``n`` that
    rank ``rank`` of ``size`` holds, chunks of ``ceil(n / size)`` rows."""
    chunk = -(-n // size) if n else 0
    lo = min(rank * chunk, n)
    return lo, min(lo + chunk, n), chunk


def with_sharding(x, mesh, axis_name=None, array_axis: int = 0):
    """This rank's shard of the global tensor ``x`` along ``array_axis``
    (chunks of :func:`local_range`; the last ranks' may be short or
    empty). Every rank passes the same ``x``."""
    _, rank, size = axis_group(mesh, axis_name)
    lo, hi, _ = local_range(x.shape[array_axis], rank, size)
    return x.narrow(array_axis, lo, hi - lo)


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Zero-pad ``axis`` of the tensor ``x`` to a multiple of ``multiple``.
    Returns (padded tensor, original length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [0, 0] * (x.dim() - 1 - axis) + [0, rem]
    return torch.nn.functional.pad(x, pad), n


def _pad_rows(x, rows: int, dim: int = 0):
    """``x`` zero-padded along ``dim`` to ``rows``."""
    have = x.shape[dim]
    if have == rows:
        return x
    shape = list(x.shape)
    shape[dim] = rows - have
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _real(x):
    """A complex tensor as its (..., 2) real view (the collectives move
    real words on every backend), anything else as it is."""
    return torch.view_as_real(x) if x.is_complex() else x


def gather_rows(x, group, size: int, n: Optional[int] = None,
                dim: int = 0):
    """All-gather of the ranks' chunks of an axis along ``dim``: one
    all-gather into one tensor. Each rank passes its chunk; with ``n``
    (the axis' global length) the chunks may be short (they are padded
    to ``ceil(n / size)`` for the call) and the result is cut to ``n``;
    without it every chunk must have the same length."""
    import torch.distributed as dist
    chunk = -(-n // size) if n is not None else x.shape[dim]
    src = _pad_rows(x.movedim(dim, 0), chunk).contiguous()
    out = src.new_empty((size * chunk,) + tuple(src.shape[1:]))
    # all_gather_single where torch has it: releases that have it warn on
    # all_gather_into_tensor, and older ones (2.11) have only the latter
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    gather(_real(out), _real(src), group=group)
    if n is not None:
        out = out[:n]
    # contiguous in the chunks' own layout, as an unsharded run makes it
    return out.movedim(0, dim).contiguous()


def all_to_all(x, group):
    """One ``all_to_all_single`` of ``x`` (contiguous, its first axis cut
    into equal chunks, chunk j to rank j): the result's chunk i is rank
    i's chunk for this rank."""
    import torch.distributed as dist
    out = torch.empty_like(x)
    dist.all_to_all_single(_real(out), _real(x), group=group)
    return out


def all_reduce_sum(x, group):
    """``x`` summed over the group (one ``all_reduce``, in place on a
    copy)."""
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(_real(out), group=group)
    return out


def rank0_write(group, write):
    """Run ``write()`` on rank 0 of ``group`` only, then wait for it on
    every rank (checkpoint files of sharded runs)."""
    import torch.distributed as dist
    if dist.get_rank(group) == 0:
        write()
    dist.barrier(group=group)

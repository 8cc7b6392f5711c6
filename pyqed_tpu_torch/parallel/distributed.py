"""Multi-process start-up of the distributed runtime.

Counterpart of ``pyqed_tpu/parallel/distributed.py``. Every process runs
the same program over one device and calls :func:`ensure_distributed`
before it builds a mesh; the processes then form one
``torch.distributed`` process group (NCCL between cards, gloo between
CPU processes), and :func:`global_mesh` is a one-axis mesh over all of
them.

Environment-driven, with the JAX package's variables:
  PYQED_COORDINATOR  host:port of process 0       (or coordinator_address=)
  PYQED_NUM_PROCS    number of processes          (or num_processes=)
  PYQED_PROC_ID      this process's id            (or process_id=)

With nothing configured the call does nothing, so library code can call
it unconditionally; a second call is a no-op. There is no fallback: a
backend that cannot start raises.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["ensure_distributed", "process_info", "global_mesh"]


def ensure_distributed(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       local_device_ids=None, device=None) -> bool:
    """Start the process group once: ``init_process_group`` with
    ``init_method='tcp://<coordinator_address>'``, the world size
    ``num_processes`` and the rank ``process_id`` (each from its
    ``PYQED_*`` variable when not given). The backend is NCCL when
    ``device`` is the card (the default; the process takes card
    ``local_device_ids[0]``, else its rank modulo the cards it sees) and
    gloo for ``device="cpu"``.

    Returns True if a process group was started (or already is), False
    for plain single-process operation (nothing configured)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("PYQED_COORDINATOR"))
    if num_processes is None and "PYQED_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["PYQED_NUM_PROCS"])
    if process_id is None and "PYQED_PROC_ID" in os.environ:
        process_id = int(os.environ["PYQED_PROC_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None:
        raise ValueError("ensure_distributed needs both a coordinator "
                         "address and a process count (PYQED_COORDINATOR, "
                         "PYQED_NUM_PROCS)")
    rank = 0 if process_id is None else int(process_id)
    from ..config import resolve_device
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        if local_device_ids is not None:
            index = int(list(local_device_ids)[0])
        elif dev.index is not None:
            index = dev.index
        else:
            index = rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=rank, **kw)
    return True


def process_info():
    """(process index, process count, local devices, global devices): one
    device a process, so the global count is the process count."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return 0, 1, 1, 1
    n = dist.get_world_size()
    return dist.get_rank(), n, 1, n


def global_mesh(axis_name: str = "data"):
    """One-axis mesh over every rank (every process calls this with the
    same arguments)."""
    import torch.distributed as dist
    from .mesh import make_mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh({axis_name: n})

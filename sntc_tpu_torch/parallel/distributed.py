"""Multi-process initialization on ``torch.distributed``.

Counterpart of ``sntc_tpu/parallel/distributed.py``.  Every process runs
the same program; :func:`initialize` joins the process group and
:func:`global_mesh` builds one mesh over every process's device, ranks
stacked along the data axis, whose reductions ``all_reduce`` across
them.  Nothing on a host tells a program of a cluster: the launcher
sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` (as ``torchrun`` does), or the caller passes them.

Usage, in each process::

    from sntc_tpu_torch.parallel import initialize, global_mesh
    initialize()            # False (a no-op) when nothing is set
    mesh = global_mesh()    # ranks stacked along "data"
    ... estimators take mesh= as usual ...

The backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU.
NCCL refuses two ranks of one communicator on the same GPU, so ranks
that share one card pass ``backend="gloo"``.  An unavailable backend
raises; there is no silent switch.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from sntc_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    hybrid_mesh,
    process_mesh,
)

_state: dict = {"device": None}

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _local_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group.  With no arguments it reads the launcher
    environment and returns False (a no-op) when none of it is set.
    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``
    or ``file://path``); ``device`` is this process's device (a bare
    ``cuda`` means ``cuda:LOCAL_RANK``)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None:
        if not any(os.environ.get(m) for m in _ENV):
            return False
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build")
    dev = _local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no nccl backend")
        torch.cuda.set_device(dev)
    elif backend == "gloo":
        if not dist.is_gloo_available():
            raise RuntimeError("this torch build has no gloo backend")
    else:
        raise ValueError(f"unsupported backend {backend!r} (nccl | gloo)")
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", "0"))
    dist.init_process_group(
        backend, init_method=coordinator_address or "env://",
        world_size=world, rank=rank)
    _state["device"] = dev
    return True


def global_mesh(model: int = 1) -> Mesh:
    """One mesh over every rank's device (ranks stacked along the data
    axis, reductions all-reduced over the process group, a
    one-rank group included) once :func:`initialize` has run; else the
    default mesh of this process."""
    dist = torch.distributed
    dev = _state["device"]
    devices = None if dev is None else [dev]
    if dist.is_available() and dist.is_initialized():
        return process_mesh(model=model, devices=devices)
    if model == 1:
        return default_mesh()
    return hybrid_mesh(model=model, devices=devices)


def process_info() -> dict:
    dist = torch.distributed
    on = dist.is_available() and dist.is_initialized()
    dev = _state["device"]
    local = 1 if dev is not None else (
        torch.cuda.device_count() if torch.cuda.is_available() else 1)
    count = dist.get_world_size() if on else 1
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": count,
        "local_devices": local,
        "global_devices": local * count,
    }

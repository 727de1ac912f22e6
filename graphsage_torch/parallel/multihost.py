"""The process group: the counterpart of
``graphsage_tpu/parallel/multihost.py``.

One process drives one device. :func:`initialize` joins the process group
that ``torchrun`` describes in the environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), or the one its
arguments name, and binds the process to ``cuda:LOCAL_RANK`` (NCCL) unless
the caller asks for the CPU (gloo). With neither environment nor arguments
it forms a world of one, so a plain ``python -m graphsage_torch.train
--mode sharded`` runs the same code as ``torchrun --nproc-per-node=S``.
Calling it again is a no-op.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from graphsage_torch._device import resolve_device

_device: torch.device | None = None


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> dict:
    """Join (or form) the process group and bind this process's device.

    ``coordinator_address`` is ``host:port`` of rank 0's store (default
    ``MASTER_ADDR:MASTER_PORT``); ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``, then to a world of one.
    ``device`` is ``cuda`` unless the caller passes ``"cpu"``: a card is
    bound as ``cuda:LOCAL_RANK`` and the group uses NCCL; the CPU uses
    gloo. A group the caller formed is joined as it is: NCCL binds the
    current card; gloo binds ``cuda:LOCAL_RANK`` where ``LOCAL_RANK`` is set
    and a card is there (gloo moves CUDA tensors too, so several ranks may
    share one card, which NCCL refuses), else the CPU. Returns the JAX
    package's summary: ``process_index``, ``process_count``,
    ``local_devices`` (one per process) and ``global_devices``."""
    global _device
    if not dist.is_initialized():
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                    f"{os.environ.get('MASTER_PORT', '29500')}")
        world = num_processes if num_processes is not None else _env_int("WORLD_SIZE") or 1
        rank = process_id if process_id is not None else _env_int("RANK") or 0
        dev = resolve_device(device)
        if dev.type == "cuda":
            local = _env_int("LOCAL_RANK")
            dev = torch.device("cuda", rank if local is None else local)
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if coordinator_address is None:
            if world != 1:
                raise ValueError(
                    f"a world of {world} processes needs coordinator_address "
                    "(or torchrun's MASTER_ADDR and MASTER_PORT)")
            # A world of one needs no rendezvous: an in-process store.
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    rank=rank, world_size=world)
        _device = dev
    elif _device is None:
        # A group formed by the caller: the backend and LOCAL_RANK name the device.
        local = _env_int("LOCAL_RANK")
        if dist.get_backend() == "nccl":
            _device = torch.device("cuda", torch.cuda.current_device())
        elif local is not None and device != "cpu" and torch.cuda.is_available():
            _device = torch.device("cuda", local)
            torch.cuda.set_device(_device)
        else:
            _device = torch.device("cpu")
    count = dist.get_world_size()
    return {
        "process_index": dist.get_rank(),
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def device() -> torch.device:
    """This process's device (:func:`initialize` first)."""
    if _device is None:
        raise RuntimeError("graphsage_torch.parallel.multihost.initialize() was not called")
    return _device


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0, or
    the only process when no group was formed)."""
    return not dist.is_initialized() or dist.get_rank() == 0

"""Process-group bring-up (reference: implicit ``MPI_Init``/``MPI_Finalize``).

Nothing tells a program of its cluster: the caller passes the address
(``tcp://localhost:<port>``), the world size and this process's rank, or
sets ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` as
``torchrun`` does.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "finalize_distributed", "local_device_count", "device_count", "restart_epoch"]


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 120.0,
) -> None:
    """Join the world process group; idempotent.

    ``backend=None`` takes gloo for CPU tensors and, where CUDA is available,
    NCCL for CUDA tensors (``"cpu:gloo,cuda:nccl"``).  After bring-up every
    rank holds rank 0's random seed, so ``ht.random`` draws agree in SPMD code.
    """
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None:
        init_method = "env://"
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    from ..utils import faults as _faults

    def attempt():
        _faults.fire("dist.init")  # an injected TransientFault is retried with backoff (retry.dist.init)
        dist.init_process_group(
            backend=backend,
            init_method=init_method,
            world_size=world_size,
            rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )

    _faults.call_with_retries(attempt, "dist.init", retry_on=(_faults.TransientFault,))
    from . import random as _random

    seed = torch.tensor([_random.get_state()[1]], dtype=torch.int64)
    dist.broadcast(seed, src=0)
    _random.seed(int(seed.item()))


def finalize_distributed() -> None:
    """Leave the process group; a no-op when none is initialized.  The
    flight recorder gets its clean-teardown ``shutdown`` record first (a
    ring ending in it reads as a clean exit, not a death)."""
    from ..utils import flightrec as _flightrec

    _flightrec.record_event("shutdown")
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def restart_epoch() -> int:
    """The restart generation this process was launched into: 0 on a fresh
    launch, else ``HEAT_TPU_RESTART_EPOCH`` as a supervising launcher sets
    it on every world restart.  A worker branches on it to resume from its
    newest verified checkpoint (``DASO.resume()``,
    ``load_array_checkpoint``'s fallback chain).  ``utils.health`` reads it
    (stdlib-only, so a supervising launcher never imports torch), as in the
    JAX package."""
    from ..utils import health as _health

    return _health.restart_epoch()


def local_device_count() -> int:
    """Cards on this host (``torch.cuda.device_count()``); 1 without CUDA,
    where the process's one device is the CPU."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def device_count() -> int:
    """Cards of the world, one a process: the world size where a process
    group is initialized, else this host's :func:`local_device_count`."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return local_device_count()

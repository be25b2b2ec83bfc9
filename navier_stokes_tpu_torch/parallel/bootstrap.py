"""Joining the process group of a multi-rank run.

Port of ``navier_stokes_tpu/parallel/bootstrap.py``: the counterpart of the
reference's ``Utilities::MPI::MPI_InitFinalize`` (``main.cpp:7``) and of the
rank-0 ``ConditionalOStream`` (``hpp:648,698``).  One process runs per rank,
launched by ``torchrun`` (as the reference runs under ``mpirun``), which
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; or the caller passes the rank, the world size and an
``init_method`` (``file://...``, ``tcp://host:port``) itself.

A single process is a strict no-op: ``initialize_distributed()`` returns
False and nothing is joined.  The backend is the caller's choice (default:
NCCL when the rank's device is a GPU, else gloo) and is never switched
after a failure: a failed join raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = [
    "initialize_distributed",
    "shutdown_distributed",
    "process_index",
    "process_count",
    "is_coordinator",
    "local_device",
]

_joined = False  # whether initialize_distributed made the process group


def initialize_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
) -> bool:
    """Join the process group if this is a multi-rank launch.

    Unset arguments come from torchrun's environment (``WORLD_SIZE``,
    ``RANK``; ``init_method`` "env://" reads ``MASTER_ADDR`` and
    ``MASTER_PORT``).  Returns True once the group exists (also when it
    existed before the call), False for a single process.  backend None is
    "nccl" where torch sees a GPU, else "gloo"; ranks that share one GPU
    need "gloo" (NCCL refuses two ranks on one device)."""
    global _joined
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":  # NCCL binds each rank to its own card
        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _joined = True
    return True


def shutdown_distributed() -> None:
    """Leave the process group this module joined (MPI_InitFinalize's
    destructor half)."""
    global _joined
    if _joined and dist.is_initialized():
        dist.destroy_process_group()
    _joined = False


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """Rank 0: the rank that prints and writes files (the reference's pcout
    condition, hpp:648)."""
    return process_index() == 0


def local_device(device) -> torch.device:
    """The device of this rank: a bare "cuda" is ``cuda:LOCAL_RANK`` (0 when
    torchrun did not set it); any other device is taken as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev

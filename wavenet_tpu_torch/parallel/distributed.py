"""The process group: one process per rank, started by a launcher.

Counterpart of wavenet_tpu/parallel/distributed.py.  The reference
bootstraps jax.distributed from JAX_COORDINATOR_* variables; here
torch.distributed reads what `torchrun` (python -m torch.distributed.run)
sets in each rank's environment: RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT, or takes them as arguments.  The backend is
the caller's choice or follows the device: nccl for a CUDA device, gloo
for the CPU.  A backend that fails to start raises; no other is tried.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def default_backend(device) -> str:
    """nccl for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched() -> bool:
    """Whether a launcher started this process as a rank (WORLD_SIZE set)."""
    return "WORLD_SIZE" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize(backend: Optional[str] = None, device=None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None) -> bool:
    """Join the process group; returns whether one is running.

    A no-op (False) in a process no launcher started and given no
    world_size, as the reference's is without a coordinator.  Otherwise
    rank and world_size come from the arguments or RANK / WORLD_SIZE, the
    rendezvous from init_method or MASTER_ADDR / MASTER_PORT ("env://"),
    and the backend from `backend` or `device` (default_backend).  Under
    nccl the process binds to `device`, which must be a CUDA device."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    env = os.environ
    if world_size is None:
        if "WORLD_SIZE" not in env:
            return False
        world_size = int(env["WORLD_SIZE"])
    if rank is None:
        rank = int(env.get("RANK", 0))
    if backend is None:
        if device is None:
            raise ValueError("name a backend or the device it serves")
        backend = default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    kw = {}
    if backend == "nccl":
        dev = torch.device(device if device is not None else "cuda")
        if dev.type != "cuda":
            raise ValueError(f"nccl serves CUDA devices, not {dev}")
        if dev.index is None:
            dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kw)
    return True


def shutdown() -> None:
    """Leave the process group, if one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes the config, checkpoints and logs."""
    return rank() == 0


def local_batch_slice(global_batch: int) -> slice:
    """This rank's rows of a globally indexed batch: every rank draws the
    same global batch from (seed, step) (audio/dataset.py) and feeds only
    its slice."""
    n, i = world_size(), rank()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)

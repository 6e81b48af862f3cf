"""Process-group start-up and rank helpers (port of
``seervideoldm_tpu/parallel/distributed.py``).

The port runs one process per rank, as torchrun starts them: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT`` in the
environment, or an explicit ``init_method``.  A single-process run needs
none of them and starts no process group.

The backend is NCCL when every local rank has a card of its own, else gloo
(ranks that share one card, or CPU ranks); the choice is made from the card
count before the group starts, never by retrying after a failure.  On gloo,
``collectives`` stages CUDA tensors through host memory.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_gather

TIMEOUT = timedelta(minutes=10)


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def pick_backend(device_type: str, local_world: int) -> str:
    """'nccl' when each of the ``local_world`` ranks of this host has a
    card of its own, else 'gloo'."""
    if device_type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def initialize_distributed(device=None, init_method: Optional[str] = None,
                           backend: Optional[str] = None) -> torch.device:
    """Start the default process group from torchrun's variables (or
    ``init_method``) when ``WORLD_SIZE`` > 1, and return this rank's device:
    ``cuda:LOCAL_RANK`` (modulo the card count, for ranks that share a
    card) unless ``device`` asks for the CPU.  Safe to call twice and in a
    single-process run."""
    world = _env_int("WORLD_SIZE", 1)
    rank = _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    want = torch.device("cuda" if device is None else device)
    if want.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = want
    if world > 1 and not dist.is_initialized():
        backend = backend or pick_backend(dev.type, local_world)
        kwargs = dict(backend=backend, world_size=world, rank=rank,
                      timeout=TIMEOUT)
        if init_method:
            kwargs["init_method"] = init_method
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(**kwargs)
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on the rank that writes files (the reference's rank-0 gate)."""
    return rank() == 0


def barrier_sync() -> None:
    """A barrier over every rank; a no-op in a single-process run."""
    if dist.is_initialized():
        dist.barrier()


def gather_across_hosts(x) -> np.ndarray:
    """Concatenate every rank's array along axis 0, in rank order (equal
    shapes on every rank).  Identity in a single-process run."""
    from .collectives import all_gather

    arr = np.asarray(x)
    if world_size() == 1:
        return arr
    parts = all_gather(torch.from_numpy(np.ascontiguousarray(arr)), None)
    return np.concatenate([p.numpy() for p in parts], axis=0)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def assert_replicas_equal(tensors, what: str = "masters") -> float:
    """A checksum (fp64 sum of every element) of ``tensors`` on every rank;
    raises when any rank's differs from rank 0's.  Returns this rank's."""
    total = torch.stack([t.sum(dtype=torch.float64) for t in tensors]).sum()
    if world_size() > 1:
        sums = [float(s) for s in all_gather(total.reshape(1), None)]
        if any(s != sums[0] for s in sums):
            raise RuntimeError(f"{what} differ across ranks: checksums {sums}")
    return float(total)

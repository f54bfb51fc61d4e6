"""Multi-process execution on torch.distributed.

Counterpart of htool_python_tpu/parallel/multihost.py, which set up
`jax.distributed` and a device mesh.  Here one process drives one card
(NCCL between cards, gloo between CPU processes), `torch.distributed`
numbers the processes, and a sharded operator lays its partitions over
them with `rank_partitions`: each rank holds P / world size consecutive
partitions.  That is the port's form of the reference's meshes —
`make_mesh` / `make_global_mesh` (one partition a device, P = world size)
and `make_hybrid_mesh` (consecutive partitions on one host) — and it is
also how one card runs several partitions.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> bool:
    """Join the process group of a multi-process run.

    The arguments default to the variables `torchrun` sets: MASTER_ADDR /
    MASTER_PORT (the coordinator), WORLD_SIZE and RANK; LOCAL_RANK picks
    this process's card.  `coordinator_address` is "host:port" or an
    init-method URL ("tcp://host:port", "file:///path").  `backend`:
    'nccl' when a card is present, else 'gloo'.  With neither arguments
    nor variables it does nothing and returns False, so a single process
    stays untouched (the reference's rule, multihost.py:23-48); returns
    True once the group is up (or already was)."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK",
                            process_id % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


def process_count(group=None) -> int:
    """Processes of the run (1 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def process_index(group=None) -> int:
    """This process's rank (0 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return 0


def is_primary(group=None) -> bool:
    """True on the process that should print (the reference's 'rank 0
    prints' convention)."""
    return process_index(group) == 0


def rank_partitions(n_partitions: int, group=None) -> range:
    """The partitions this rank holds: P / world size consecutive ones
    (`partition_range`)."""
    return partition_range(n_partitions, process_count(group),
                           process_index(group))


def partition_range(n_partitions: int, world_size: int, rank: int) -> range:
    """The P / world_size consecutive partitions of `rank`.  Raises
    ValueError unless the world size divides P (the reference's mesh-size
    check, sharded.py:223-227)."""
    if n_partitions < 1 or n_partitions % world_size:
        raise ValueError(f"{n_partitions} partitions cannot be laid over "
                         f"{world_size} processes: each process holds P / "
                         "world size consecutive partitions")
    per = n_partitions // world_size
    return range(rank * per, (rank + 1) * per)

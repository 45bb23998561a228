"""Process-group set-up, the counterpart of
``recurrent_flows_tpu.parallel.distributed``.

The JAX package shards the batch over the devices of one process (an SPMD
mesh) and, on a pod, over hosts after ``jax.distributed.initialize``. The
port runs one process per device (``torchrun --nproc_per_node N``):
:func:`initialize` joins the default process group, NCCL on CUDA and gloo
on the CPU, and returns the :class:`DataParallel` that the ``Trainer``
uses; every process then takes its slice of the global batch
(:func:`process_local_batch_slice`) and only the primary writes files.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .data_parallel import DataParallel


def initialize(device="cuda", init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None
               ) -> DataParallel | None:
    """Join the default process group and return a ``DataParallel`` over it
    on this process's device (``cuda`` means ``cuda:LOCAL_RANK``).

    An existing default group is used as it is. Otherwise the group is made
    from ``init_method``/``world_size``/``rank`` where given, else from
    torchrun's environment (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``). Without either (``WORLD_SIZE`` unset) there
    is no group to join: returns None, and the caller trains in one
    process. A failed ``init_process_group`` raises."""
    owned = not dist.is_initialized()
    if owned and init_method is None and "WORLD_SIZE" not in os.environ:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if owned:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)
    return DataParallel(device, owns_group=owned)


def _world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def process_local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a globally indexed batch."""
    rank, world = _world()
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0)."""
    return _world()[0] == 0

"""The data-parallel step, the counterpart of ``replicate``/``shard_batch``
in ``recurrent_flows_tpu.parallel.mesh``: the (data x model) grid of
``parallel.mesh`` with no model axis.

The JAX package replicates the parameters over a mesh, shards the batch
over its 'data' axis and lets GSPMD insert the collectives: the gradient
is the whole batch's, and a batch norm's statistics are taken over the
whole (sharded) batch. One process per device gives the same step with
three pieces:

- the parameters and buffers are broadcast from rank 0 once the model is
  built (``broadcast_``): every rank starts from rank 0's initialisation
  and data-dependent init;
- rank 0 draws each global batch and sends it to every rank, which keeps
  its slice (``scatter``; the other ranks read no data);
- the batch statistics of a step are global (:func:`batch_mean`, inside
  ``active``), with autograd through their all-reduce, and after the
  backward pass the gradients are averaged over the ranks
  (``reduce_grads_``), one all-reduce of one flat buffer.

``--batch_size`` is the global batch, and a step on W ranks is the step of
one process on the whole batch, up to the order of float32 sums. The
gradients are all-reduced after ``backward`` rather than through
``DistributedDataParallel``, which hooks ``forward`` (the trainer calls
``model.loss``) and overlaps its buckets with a backward pass whose batch
norms already all-reduce; one flat all-reduce keeps a one-rank group's
step bit for bit the step without one. Each rank draws its own noise for
its own slice (``Trainer`` seeds its stream by rank).
"""

from __future__ import annotations

import torch.distributed as dist

from .mesh import Mesh, batch_mean

__all__ = ["DataParallel", "batch_mean"]


class DataParallel(Mesh):
    """One process's place in the default process group, as an
    ``n_data = world``, ``n_model = 1`` grid."""

    def __init__(self, device, owns_group: bool = False):
        super().__init__(device, dist.get_rank(), dist.get_world_size(), 1,
                         owns_group=owns_group)

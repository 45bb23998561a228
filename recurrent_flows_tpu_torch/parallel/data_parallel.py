"""The data-parallel step, the counterpart of ``replicate``/``shard_batch``
in ``recurrent_flows_tpu.parallel.mesh``.

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
  ``global_batch_stats``), with autograd through their all-reduce, and
  after the backward pass the gradients are averaged over the ranks
  (``average_``), one all-reduce of one flat buffer.

``--batch_size`` is the global batch, and a step on W ranks is the step of
one process on the whole batch, up to the order of float32 sums. The
gradients are all-reduced after ``backward`` rather than through
``DistributedDataParallel``, which hooks ``forward`` (the trainer calls
``model.loss``) and overlaps its buckets with a backward pass whose batch
norms already all-reduce; one flat all-reduce keeps a one-rank group's
step bit for bit the step without one.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

_WORLD = None  # the ranks over which batch statistics are global now, or None


class _AllReduceMean(torch.autograd.Function):
    """The mean over ranks of a tensor; its gradient is the mean over ranks
    of the incoming gradients (the adjoint of the same map)."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y / world

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g / ctx.world, None


def batch_mean(x: torch.Tensor, dims, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dims)``, over the global batch inside
    ``DataParallel.global_batch_stats`` (the mean of the ranks' means: the
    ranks hold slices of one size)."""
    m = x.mean(dims, keepdim=keepdim)
    if _WORLD is None:
        return m
    return _AllReduceMean.apply(m, _WORLD)


class DataParallel:
    """One process's place in the default process group and the
    collectives of a step."""

    def __init__(self, device, owns_group: bool = False):
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.owns_group = owns_group  # made by ``initialize``; ``close`` ends it

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def local(self, batch):
        """This rank's slice (along axis 0) of a global batch."""
        n = batch.shape[0]
        if n % self.world:
            raise ValueError(f"a global batch of {n} does not split over {self.world} ranks")
        per = n // self.world
        return batch[self.rank * per:(self.rank + 1) * per]

    def scatter(self, batch):
        """Rank 0's global ``batch`` (a tensor or array; None when its data
        ran out) sent to every rank: this rank's slice, float32 on its
        device, or None on every rank. The other ranks pass None."""
        shape = [None if batch is None else tuple(batch.shape)]
        dist.broadcast_object_list(shape, 0)
        if shape[0] is None:
            return None
        if self.primary:
            t = torch.as_tensor(batch, dtype=torch.float32, device=self.device).contiguous()
        else:
            t = torch.empty(shape[0], dtype=torch.float32, device=self.device)
        dist.broadcast(t, 0)
        return self.local(t)

    def _flat(self, tensors, reduce: bool):
        """One collective per dtype over the flattened ``tensors``: an
        all-reduce averaged over the ranks, or a broadcast from rank 0;
        the result is written back in place."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = _flatten_dense_tensors(ts)
            if reduce:
                dist.all_reduce(flat)
                flat /= self.world
            else:
                dist.broadcast(flat, 0)
            for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(v)

    @torch.no_grad()
    def broadcast_(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        self._flat([t.data for t in list(module.parameters()) + list(module.buffers())],
                   reduce=False)

    @torch.no_grad()
    def average_(self, tensors) -> None:
        """Each tensor replaced in place by its mean over the ranks."""
        self._flat(list(tensors), reduce=True)

    def mean_metrics(self, metrics: dict) -> dict:
        """Scalars averaged over the ranks (one all-reduce)."""
        keys = list(metrics)
        stacked = torch.stack([metrics[k] for k in keys])
        self.average_([stacked])
        return dict(zip(keys, stacked.unbind()))

    @contextlib.contextmanager
    def global_batch_stats(self):
        """Within this block ``batch_mean`` averages over the group."""
        global _WORLD
        before, _WORLD = _WORLD, self.world
        try:
            yield
        finally:
            _WORLD = before

    def close(self) -> None:
        """End the default group where ``initialize`` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False

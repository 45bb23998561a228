"""Data-parallel training over ``torch.distributed``, the counterpart of
``recurrent_flows_tpu.parallel``: one process per device, each holding its
slice of the global batch (see ``data_parallel``)."""

from .data_parallel import DataParallel, batch_mean
from .distributed import initialize, is_primary, process_local_batch_slice

__all__ = ["DataParallel", "batch_mean", "initialize", "is_primary",
           "process_local_batch_slice"]

"""Parallel training over ``torch.distributed``, the counterpart of
``recurrent_flows_tpu.parallel``: one process per device, each holding its
slice of the global batch (``data_parallel``) and, on a (data x model)
grid, its rows of every frame (``mesh``)."""

from .data_parallel import DataParallel
from .distributed import initialize, is_primary, process_local_batch_slice
from .mesh import Mesh, batch_mean, grid, make_mesh, own_rows, spatial_constraint

__all__ = ["DataParallel", "Mesh", "batch_mean", "grid", "initialize", "is_primary",
           "make_mesh", "own_rows", "process_local_batch_slice", "spatial_constraint"]

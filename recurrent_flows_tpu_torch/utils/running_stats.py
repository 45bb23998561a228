"""When running statistics update: the counterpart of applying a flax
model with ``mutable=['batch_stats']``.

Two kinds of module keep running statistics: the flow's
``BatchNormFlow`` (``flow_norm='batchnorm'``) and ``NormLayer`` batch norms
with ``track_running_stats``. Neither updates on its own: they update only
inside :func:`updating_running_stats`, as the JAX modules update only when
their caller makes the collection mutable. A train step never does, so it
never moves a running buffer.

``initializing=True`` stands for flax's ``init``, where the collection is
mutable too: ``BatchNormFlow`` updates there, ``NormLayer`` does not (its
JAX counterpart is guarded by ``not self.is_initializing()``).
"""

from __future__ import annotations

import contextlib

import torch

_MODE = None  # None, "init" or "refresh"


@contextlib.contextmanager
def updating_running_stats(initializing: bool = False):
    """Within this block the modules' running statistics update (under
    ``torch.no_grad``, in place), as in a flax apply with
    ``mutable=['batch_stats']``; with ``initializing``, as in flax's
    ``init``."""
    global _MODE
    before, _MODE = _MODE, "init" if initializing else "refresh"
    try:
        yield
    finally:
        _MODE = before


def flow_stats_update() -> bool:
    """``BatchNormFlow`` updates its running statistics now."""
    return _MODE is not None


def layer_stats_update() -> bool:
    """``NormLayer`` updates its running statistics now (never in init)."""
    return _MODE == "refresh"


def ema_(running: torch.Tensor, batch: torch.Tensor, keep: float) -> None:
    """running <- keep·running + (1-keep)·batch, in place, no gradient."""
    with torch.no_grad():
        running.copy_(running * keep + batch.detach() * (1.0 - keep))


def has_running_stats(model: torch.nn.Module) -> bool:
    """``model`` holds running statistics (the JAX model has a
    ``batch_stats`` collection)."""
    return any(name.rsplit(".", 1)[-1] in ("running_mean", "running_var")
               for name, _ in model.named_buffers())

"""Convert the JAX package's parameter trees into the port's parameters.

The port's modules carry the flax names, so a leaf's path in the flax
tree, joined by '.', is its name in the port's ``state_dict``. Conv
kernels go from HWIO to OIHW; every other leaf (actnorm ``bias``/``logs``,
the LU ``lower``/``upper``/``log_s``, ``Conv2dZeros`` ``logs``, the realnvp
``scale``/``scale_shift``, the peepholes ``Wci``/``Wcf``/``Wco`` [1,H,W,C],
``NormLayer`` ``scale``/``bias``, ``h_0`` … ``z_0x`` [1,h,w,C]) keeps its
layout. The 'consts' tree (the LU's ``p`` and ``sign_s``) maps onto buffers.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(params: Mapping, consts: Mapping | None,
              model: nn.Module) -> dict:
    """State dict for ``model`` from flax ``params``/``consts`` trees
    (nested dicts of arrays). Raises on a leaf the port does not consume,
    on a port parameter or buffer left unset, and on a shape mismatch."""
    expected = model.state_dict()
    buffers = {n for n, _ in model.named_buffers()}
    state = {}
    for coll, tree in (("params", params), ("consts", consts or {})):
        for path, leaf in _leaves(tree):
            name = ".".join(path)
            where = f"{coll}/{'/'.join(path)}"
            if name not in expected or (name in buffers) != (coll == "consts"):
                raise KeyError(f"flax leaf {where} has no counterpart in "
                               f"{type(model).__name__}")
            a = np.asarray(leaf, np.float32)
            if path[-1] == "kernel" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            ref = expected[name]
            if a.shape != tuple(ref.shape):
                raise ValueError(f"flax leaf {where}: shape {a.shape} (after "
                                 f"layout change), port expects {tuple(ref.shape)}")
            state[name] = torch.tensor(a, device=ref.device)
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"port parameters not set by the flax trees: {missing}")
    return state

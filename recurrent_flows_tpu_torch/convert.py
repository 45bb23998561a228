"""Convert the JAX package's parameter trees into the port's parameters.

The port's modules carry the flax names, so a leaf's path in the flax
tree, joined by '.', is its name in the port's ``state_dict``. Conv
kernels go from HWIO to OIHW; the kernel of a transposed conv
(``nn.layers.ConvTranspose2d``: flax's ``nn.ConvTranspose``, which
convolves with its kernel as stored where ``F.conv_transpose2d`` flips
it) is flipped in H and W and goes from HWIO to IOHW; a ``Dense`` kernel
keeps flax's [in, out]; every other leaf (actnorm ``bias``/``logs``,
the LU ``lower``/``upper``/``log_s`` or the plain 1x1 ``weight``,
``BatchNormFlow`` ``log_gamma``/``beta`` [H,W,C], ``Conv2dZeros`` ``logs``,
a ``Conv2dNorm``'s conv ``bias`` and ``bn_scale``/``bn_bias`` where its norm
is not actnorm, the realnvp ``scale``/``scale_shift``, the peepholes
``Wci``/``Wcf``/``Wco`` [1,H,W,C], ``NormLayer`` ``scale``/``bias``,
``h_0`` … ``z_0x`` [1,h,w,C]) keeps its layout. The 'consts' tree (the
LU's ``p`` and ``sign_s``; absent without LU) and the 'batch_stats' tree
(the ``running_mean``/``running_var`` of the BatchNormFlows [H,W,C] and of
the NormLayers that track them [C]) map onto buffers.

The layout changes are linear, so a tree of gradients or of Adam moments
shaped like the parameters converts the same way (``tree_from_flax``);
``adam_from_optax`` loads optax's Adam state into a ``torch.optim.Adam``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .nn.layers import ConvTranspose2d


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _transposed_kernels(model: nn.Module) -> set:
    """Names of the kernels of ``model``'s transposed convs."""
    return {f"{name}.kernel" if name else "kernel" for name, m in model.named_modules()
            if isinstance(m, ConvTranspose2d)}


def _convert(coll: str, tree: Mapping, expected: Mapping, kind: str,
             transposed: set = frozenset()) -> dict:
    """{port name: tensor} for every leaf of ``tree``; raises on a leaf
    with no counterpart in ``expected`` and on a shape mismatch. The
    kernels named in ``transposed`` are a transposed conv's."""
    out = {}
    for path, leaf in _leaves(tree):
        name = ".".join(path)
        where = f"{coll}/{'/'.join(path)}"
        if name not in expected:
            raise KeyError(f"flax leaf {where} has no counterpart in {kind}")
        a = np.asarray(leaf, np.float32)
        if name in transposed:
            a = np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))  # -> IOHW, flipped
        elif path[-1] == "kernel" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        ref = expected[name]
        if a.shape != tuple(ref.shape):
            raise ValueError(f"flax leaf {where}: shape {a.shape} (after "
                             f"layout change), port expects {tuple(ref.shape)}")
        out[name] = torch.tensor(a, device=ref.device)
    return out


def from_flax(params: Mapping, consts: Mapping | None,
              model: nn.Module, batch_stats: Mapping | None = None) -> dict:
    """State dict for ``model`` from flax ``params``/``consts``/
    ``batch_stats`` trees (nested dicts of arrays). Raises on a leaf the
    port does not consume, on a port parameter or buffer left unset, and on
    a shape mismatch."""
    kind = type(model).__name__
    buffers = dict(model.named_buffers())
    state = _convert("params", params, dict(model.named_parameters()), kind,
                     _transposed_kernels(model))
    state.update(_convert("consts", consts or {}, buffers, kind))
    state.update(_convert("batch_stats", batch_stats or {}, buffers, kind))
    missing = sorted(set(model.state_dict()) - set(state))
    if missing:
        raise KeyError(f"port parameters not set by the flax trees: {missing}")
    return state


def tree_from_flax(tree: Mapping, model: nn.Module) -> dict:
    """{parameter name: tensor} from a flax tree shaped like the parameters
    (gradients, Adam moments), in the port's layout. Raises like
    ``from_flax``, also on a parameter the tree leaves out."""
    named = dict(model.named_parameters())
    out = _convert("tree", tree, named, type(model).__name__ + "'s parameters",
                   _transposed_kernels(model))
    missing = sorted(set(named) - set(out))
    if missing:
        raise KeyError(f"port parameters missing from the flax tree: {missing}")
    return out


def adam_from_optax(mu: Mapping, nu: Mapping, count: int, model: nn.Module,
                    optimizer: torch.optim.Adam) -> None:
    """Load optax's Adam state (``ScaleByAdamState.mu``/``.nu``/``.count``)
    into ``optimizer``, which must hold ``model``'s parameters: a step
    taken from there continues the optax run."""
    mu, nu = tree_from_flax(mu, model), tree_from_flax(nu, model)
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        if id(p) not in held:
            raise ValueError(f"the optimizer does not hold parameter {name}")
        optimizer.state[p] = dict(
            step=torch.tensor(float(count)),
            exp_avg=mu[name].to(p.device), exp_avg_sq=nu[name].to(p.device))

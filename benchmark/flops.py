"""Model FLOPs, counted on the plain reference with shapes alone (the
``meta`` device, ``FlopCounterMode``: matrix products and convolutions)
at one sequence and scaled by the batch. A training step counts three
forward passes (forward and backward, recomputation left out)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


class _ShapesOnly:
    """Draws of the right shape and no values."""

    def normal(self, shape):
        return torch.empty(tuple(shape), device="meta")

    def uniform(self, shape, low, high):
        return torch.empty(tuple(shape), device="meta")


def _params(ref, cfg):
    return {n: torch.empty(s, device="meta") for n, s, *_ in ref.spec(cfg)}


def _frames(cfg, t):
    return torch.empty((1, t, cfg["image_size"], cfg["image_size"], cfg["x_channels"]),
                       device="meta")


def train_step(ref, cfg: dict, batch: int, frames: int) -> float:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.loss(_params(ref, cfg), cfg, _frames(cfg, frames), _ShapesOnly(), remat=False)
    return 3.0 * counter.get_total_flops() * batch


def request(ref, cfg: dict, tcfg: dict, batch: int, n_conditions: int,
            n_predictions: int) -> float:
    with FlopCounterMode(display=False) as counter:
        ref.predict(_params(ref, cfg), cfg, tcfg, _frames(cfg, n_conditions), n_conditions,
                    n_predictions, _ShapesOnly())
    return float(counter.get_total_flops()) * batch

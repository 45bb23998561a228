"""Training harness of the port. This slice has only ``preprocess``, which
serving uses; the trainer itself comes later (ROADMAP.md queue 1, item 2)."""

from __future__ import annotations

import torch


def preprocess(x, n_bits: int = 8, rng_range: str = "0.5", scale: int = 255,
               reverse: bool = False):
    """n-bit quantization to [-0.5, 0.5] ('0.5') or [0, 1] ('1.0').

    Forward expects data in [0, 1]; reverse maps back to bytes.
    'none' passes through; 'minmax' rescales to [-1, 1].
    """
    n_bins = 2.0 ** n_bits
    if rng_range == "none":
        return x
    if rng_range == "minmax":
        if not reverse:
            return x * 2.0 - 1.0
        return torch.clamp((x + 1.0) * 0.5 * 255.0, 0, 255).to(torch.uint8)
    if not reverse:
        x = x * scale
        if n_bits < 8:
            x = torch.floor(x / 2 ** (8 - n_bits))
        x = x / n_bins
        if rng_range == "0.5":
            x = x - 0.5
        return x
    if rng_range == "0.5":
        x = x + 0.5
    x = x * n_bins
    return torch.clamp(torch.floor(x) * (256.0 / n_bins), 0, 255).to(torch.uint8)

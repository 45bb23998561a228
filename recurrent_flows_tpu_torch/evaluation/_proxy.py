"""The fixed random weights of the proxy embedders (the LPIPS feature
pyramid and the FVD proxy ``random3d``): the JAX package's draws, written
to ``proxy_weights.npz`` by ``scripts/export_proxy_embedder_weights.py``,
read with numpy and kept on each device they are asked for."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "proxy_weights.npz")


@functools.lru_cache(maxsize=None)
def _arrays() -> dict:
    with np.load(PATH) as data:
        return {k: data[k] for k in data.files}


@functools.lru_cache(maxsize=None)
def weights(prefix: str, device: torch.device) -> tuple:
    """The layers under ``prefix`` ('lpips/conv', 'random3d/conv') as
    channels-first convolution weights on ``device``, in order."""
    arrays, out = _arrays(), []
    while f"{prefix}{len(out)}" in arrays:
        w = torch.from_numpy(arrays[f"{prefix}{len(out)}"])
        out.append(w.permute(w.dim() - 1, w.dim() - 2, *range(w.dim() - 2)).contiguous()
                   .to(device))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def array(name: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_arrays()[name]).to(device)

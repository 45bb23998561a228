"""FVD, the Fréchet Video Distance with a pluggable video embedder, the
counterpart of ``recurrent_flows_tpu.evaluation.fvd``.

The reference embeds videos with the TF-Hub I3D graph and takes the
Fréchet distance of the two sets' Gaussians. The embedders:

* ``embedder='i3d'``: the I3D of ``i3d.py`` given a weights npz (the
  ``i3d_weights`` argument, the ``RFT_I3D_WEIGHTS`` environment variable or
  ./data/i3d_kinetics400.npz; ``scripts/export_i3d_weights.py`` writes it on
  a host with network). Without one it raises: the JAX package's fallback
  to the TF-Hub graph needs TensorFlow and the network, and is not ported;
* ``embedder='random3d'``: a fixed random-feature 3D conv network, the JAX
  package's draws (``proxy_weights.npz``), so its distances equal the JAX
  package's. Fréchet distances under fixed random features are
  self-consistent across models and runs but NOT comparable to published
  I3D-FVD values;
* ``embedder='auto'``: ``i3d`` when an npz is found, else ``random3d``.

The embedders run on the device of the videos, in float32 with TF32 off;
the Fréchet math is numpy, as the JAX package's (the trace of the square
root through the eigenvalues of sigma1 @ sigma2).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.numerics import float32_precision, pad_same
from . import _proxy
from .metrics import to_tensor


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) (symmetrized, stable)."""
    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    sigma1, sigma2 = np.asarray(sigma1), np.asarray(sigma2)
    diff = np.sum((mu1 - mu2) ** 2)
    # trace of sqrt(s1 @ s2) via eigenvalues of the product (PSD pair)
    eigs = np.linalg.eigvals(sigma1 @ sigma2)
    tr_sqrt = np.sum(np.sqrt(np.maximum(eigs.real, 0.0)))
    return float(diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt)


def _random3d_embed(videos) -> torch.Tensor:
    """Fixed random 3D-conv features: [B, T, H, W, C] -> [B, 256]. Three
    3x3x3 convs of stride (1, 2, 2) with SAME padding and tanh (16, 32, 64
    channels), the mean over time and space, a random projection to 256."""
    x = videos.float()
    if x.shape[-1] == 1:
        x = x.expand(x.shape[:-1] + (3,))
    if x.shape[-1] != 3:
        raise ValueError(f"random3d takes 1 or 3 channels, not {x.shape[-1]}")
    x = x.permute(0, 4, 1, 2, 3)
    with float32_precision():
        for w in _proxy.weights("random3d/conv", x.device):
            x = torch.tanh(F.conv3d(pad_same(x, (3, 3, 3), (1, 2, 2)), w, stride=(1, 2, 2)))
        return x.mean((2, 3, 4)) @ _proxy.array("random3d/proj", x.device)


def _stats(feats) -> Tuple[np.ndarray, np.ndarray]:
    f = np.asarray(feats)
    return f.mean(0), np.cov(f, rowvar=False)


def fvd(videos_real, videos_fake, embedder: str = "auto", batch: int = 16,
        i3d_weights: str | None = None) -> dict:
    """Fréchet Video Distance between two [N, T, H, W, C] video sets in [0, 1]
    (tensors, embedded where they are; arrays on the card). Embeds ``batch`` videos at a time, as the reference. Returns
    dict(fvd=..., embedder=...), the embedder named as the JAX package
    names it: 'i3d-jax' for the npz-loaded I3D, else 'random3d'."""
    from . import i3d as i3d_mod

    if embedder not in ("auto", "i3d", "random3d"):
        raise ValueError(f"unknown embedder {embedder!r}")
    i3d_params = None
    if embedder in ("auto", "i3d"):
        path = i3d_weights or i3d_mod.default_weights_path()
        if path is not None:
            i3d_params = i3d_mod.load_params(path)
        elif embedder == "i3d":
            raise FileNotFoundError(
                "embedder='i3d' needs an I3D weights npz (scripts/export_i3d_weights.py); "
                "the TF-Hub graph the JAX package falls back to is not ported")
    if embedder == "auto":
        embedder = "i3d" if i3d_params is not None else "random3d"

    def embed_all(videos):
        videos = to_tensor(videos)
        outs = []
        for i in range(0, videos.shape[0], batch):
            chunk = videos[i:i + batch]
            outs.append(i3d_mod.i3d_embed(chunk, i3d_params) if embedder == "i3d"
                        else _random3d_embed(chunk))
        return torch.cat(outs).cpu().numpy()

    mu1, s1 = _stats(embed_all(videos_real))
    mu2, s2 = _stats(embed_all(videos_fake))
    return dict(fvd=frechet_distance(mu1, s1, mu2, s2),
                embedder="i3d-jax" if embedder == "i3d" else embedder)

"""LPIPS(AlexNet) with a weight-file loader, the counterpart of
``recurrent_flows_tpu.evaluation.alexnet_lpips``.

The reference scores perceptual distance with the ``lpips`` package's
AlexNet backbone. Its pretrained weights cannot be fetched on a host
without network, so this module computes the whole forward path (scaling
layer, AlexNet conv features, unit normalisation, the learned linear
heads, spatial averaging) from an ``.npz`` that
``scripts/export_lpips_weights.py`` writes on a host with network.

npz contract (all float32, the JAX package's):
  scaling/shift [3], scaling/scale [3]
  conv{1..5}/w HWIO, conv{1..5}/b [C]
  lin{0..4}/w [C_l]   (the 1x1 non-negative LPIPS head per tapped layer)
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.numerics import float32_precision
from .lpips import _unit_normalize
from .metrics import to_tensor

# (out_ch, kernel, stride, pad) of torchvision's AlexNet features
_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_LIN_CHANNELS = [64, 192, 384, 256, 256]


def expected_keys() -> list:
    keys = ["scaling/shift", "scaling/scale"]
    for i in range(5):
        keys += [f"conv{i + 1}/w", f"conv{i + 1}/b", f"lin{i}/w"]
    return keys


def random_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights in the loader layout (plumbing tests); numpy's
    ``RandomState``, so the JAX package's function gives the same arrays."""
    rng = np.random.RandomState(seed)
    params: Dict[str, np.ndarray] = {
        "scaling/shift": np.array([-0.030, -0.088, -0.188], np.float32),
        "scaling/scale": np.array([0.458, 0.448, 0.450], np.float32),
    }
    cin = 3
    for i, (cout, k, _, _) in enumerate(_CONVS):
        params[f"conv{i + 1}/w"] = rng.normal(0, 0.05, (k, k, cin, cout)).astype(np.float32)
        params[f"conv{i + 1}/b"] = np.zeros((cout,), np.float32)
        params[f"lin{i}/w"] = rng.uniform(0, 1, (_LIN_CHANNELS[i],)).astype(np.float32)
        cin = cout
    return params


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Load an AlexNet-LPIPS npz, its keys and shapes checked."""
    with np.load(path) as data:
        params = {k: data[k] for k in data.files}
    missing = [k for k in expected_keys() if k not in params]
    if missing:
        raise ValueError(f"lpips weights file missing keys: {missing[:5]}")
    for i, (cout, k, _, _) in enumerate(_CONVS):
        got = tuple(params[f"conv{i + 1}/w"].shape)
        if got[:2] != (k, k) or got[3] != cout:
            raise ValueError(f"conv{i + 1}/w shape {got} unexpected")
        if int(np.prod(params[f"lin{i}/w"].shape)) != _LIN_CHANNELS[i]:
            raise ValueError(f"lin{i}/w size != {_LIN_CHANNELS[i]}")
    return params


def default_weights_path() -> Optional[str]:
    env = os.environ.get("RFT_LPIPS_WEIGHTS")
    if env and os.path.exists(env):
        return env
    for cand in ("./data/lpips_alex.npz", "./lpips_alex.npz"):
        if os.path.exists(cand):
            return cand
    return None


def _device_params(params: Dict[str, np.ndarray], device) -> dict:
    """The weights as tensors on ``device``, conv kernels as OIHW."""
    t = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
         for k, v in params.items()}
    for i in range(5):
        t[f"conv{i + 1}/w"] = t[f"conv{i + 1}/w"].permute(3, 2, 0, 1).contiguous()
        t[f"conv{i + 1}/b"] = t[f"conv{i + 1}/b"].reshape(-1)
        t[f"lin{i}/w"] = t[f"lin{i}/w"].reshape(1, -1, 1, 1)
    return t


def _features(t, x):
    """[B, 3, H, W] in [-1, 1] -> the 5 tapped relu feature maps."""
    x = (x - t["scaling/shift"].reshape(1, 3, 1, 1)) / t["scaling/scale"].reshape(1, 3, 1, 1)
    feats = []
    for i, (_, _, stride, pad) in enumerate(_CONVS):
        x = F.relu(F.conv2d(x, t[f"conv{i + 1}/w"], t[f"conv{i + 1}/b"], stride=stride,
                            padding=pad))
        feats.append(x)
        if i in (0, 1):
            x = F.max_pool2d(x, 3, 2)
    return feats


def lpips_alex(params: Dict[str, np.ndarray], a, b) -> torch.Tensor:
    """LPIPS distance per batch element [B]; a, b [B, H, W, C] in [-1, 1],
    on their device (arrays on the card)."""
    a, b = to_tensor(a), to_tensor(b)
    if a.shape[-1] == 1:
        a, b = a.expand(a.shape[:-1] + (3,)), b.expand(b.shape[:-1] + (3,))
    t = _device_params(params, a.device)
    with float32_precision():
        fa = _features(t, a.permute(0, 3, 1, 2))
        fb = _features(t, b.permute(0, 3, 1, 2))
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            d = torch.sum(t[f"lin{i}/w"] * (_unit_normalize(xa) - _unit_normalize(xb)) ** 2, 1)
            total = total + d.mean((1, 2))
    return total

"""LPIPS-style perceptual distance with a pluggable feature extractor, the
counterpart of ``recurrent_flows_tpu.evaluation.lpips``.

The reference scores with the ``lpips`` package's AlexNet backbone. Its
pretrained weights cannot be fetched on a host without network, so
``lpips_distance`` takes, in this order:

* the AlexNet-LPIPS of ``alexnet_lpips`` when a weights npz is found
  (exact parity with the reference, given the exported weights);
* the ``lpips`` package, when it imports;
* a fixed random-feature conv pyramid computing the same construction
  (unit-normalise each scale's channel features, average the spatial L2
  of their differences). Its weights are the JAX package's draws
  (``proxy_weights.npz``), so its values equal the JAX package's. Random
  VGG-style features are a known perceptual proxy: self-consistent, not
  comparable to published LPIPS numbers.

Everything runs on the device of the inputs, in float32 with TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.numerics import float32_precision, pad_same
from . import _proxy
from .metrics import to_tensor


def _unit_normalize(x):
    """Channel features (axis 1) to unit length, as the JAX package."""
    return x * torch.rsqrt(torch.sum(x ** 2, 1, keepdim=True) + 1e-10)


def _feature_pyramid(x):
    """[B, H, W, C] in [-1, 1] -> the 4 relu feature maps of the pyramid,
    channels first: stride-2 3x3 convs with SAME padding (32, 64, 128, 256
    channels). Gray frames enter as three repeated channels."""
    if x.shape[-1] == 1:
        x = x.expand(x.shape[:-1] + (3,))
    if x.shape[-1] != 3:
        raise ValueError(f"the LPIPS proxy takes 1 or 3 channels, not {x.shape[-1]}")
    x = x.permute(0, 3, 1, 2)
    feats = []
    with float32_precision():
        for w in _proxy.weights("lpips/conv", x.device):
            x = F.relu(F.conv2d(pad_same(x, (3, 3), (2, 2)), w, stride=2))
            feats.append(x)
    return feats


def lpips_distance(a, b, backend: str = "auto", weights: str | None = None):
    """Perceptual distance per batch element [B]; a, b: [B, H, W, C] in
    [-1, 1], tensors (computed where they are) or arrays (on the card).

    ``backend``: 'auto' (the order above), 'alex' (needs a weights npz:
    ``weights``, the ``RFT_LPIPS_WEIGHTS`` environment variable, or
    ./data/lpips_alex.npz, which ``scripts/export_lpips_weights.py`` writes
    on a host with network), 'lpips' or 'random_features'.
    """
    from . import alexnet_lpips as alex_mod

    a, b = to_tensor(a), to_tensor(b)
    alex_params = None
    if backend in ("auto", "alex"):
        path = weights or alex_mod.default_weights_path()
        if path is not None:
            alex_params = alex_mod.load_params(path)
        elif backend == "alex":
            raise FileNotFoundError(
                "backend='alex' needs a weights npz (scripts/export_lpips_weights.py)")
    if alex_params is not None:
        return alex_mod.lpips_alex(alex_params, a, b)

    if backend == "auto":
        try:
            import lpips  # noqa: F401

            backend = "lpips"
        except ImportError:
            backend = "random_features"

    if backend == "lpips":
        return _lpips_package(a, b)

    total = 0.0
    for xa, xb in zip(_feature_pyramid(a), _feature_pyramid(b)):
        d = torch.sum((_unit_normalize(xa) - _unit_normalize(xb)) ** 2, 1)
        total = total + d.mean((1, 2))
    return total / 4


_LPIPS_NETS: dict = {}


def _lpips_package(a, b):
    """The ``lpips`` package's AlexNet LPIPS, one network per device."""
    import lpips as lp

    net = _LPIPS_NETS.get(a.device)
    if net is None:
        net = _LPIPS_NETS[a.device] = lp.LPIPS(net="alex", verbose=False).to(a.device)
    ta, tb = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    if ta.shape[1] == 1:
        ta, tb = ta.repeat(1, 3, 1, 1), tb.repeat(1, 3, 1, 1)
    with torch.no_grad(), float32_precision():
        return net(ta, tb).reshape(-1)

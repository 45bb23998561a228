"""I3D (Inflated Inception-v1, Kinetics-400), the FVD embedder, the
counterpart of ``recurrent_flows_tpu.evaluation.i3d``.

The reference embeds videos with the TF-Hub ``i3d-kinetics-400`` graph,
which cannot be fetched on a host without network, so this is the whole
architecture with a weight-file loader: an ``.npz`` whose keys are the
public kinetics-i3d checkpoint's variable names
(``RGB/inception_i3d/<unit>/conv_3d/w``,
``.../batch_norm/{beta,moving_mean,moving_variance}``), which
``scripts/export_i3d_weights.py`` writes from a checkpoint on a host with
network. The npz stores conv kernels as [t, h, w, in, out]; the network
runs channels first (NCDHW) on the device of its input, in float32 with
TF32 off. TensorFlow's SAME padding is asymmetric on even sizes, and the
max-pools pad with -inf: both are padded explicitly (``pad_same``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.numerics import float32_precision, pad_same
from .metrics import to_tensor

_SCOPE = "RGB/inception_i3d"

# Inception-v1 branch channel table: unit -> (b0, b1a, b1b, b2a, b2b, b3b)
MIXED_CHANNELS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}

NUM_CLASSES = 400


def _unit(t, name: str, x, strides=(1, 1, 1)):
    """Conv3D (SAME, no bias) + batch norm (frozen statistics, beta only,
    eps 1e-3) + ReLU: snt.Conv3D's unit."""
    w = t[f"{_SCOPE}/{name}/conv_3d/w"]
    x = F.conv3d(pad_same(x, w.shape[2:], strides), w, stride=strides)
    bn = f"{_SCOPE}/{name}/batch_norm"
    x = (x - t[f"{bn}/moving_mean"]) * torch.rsqrt(t[f"{bn}/moving_variance"] + 1e-3)
    return F.relu(x + t[f"{bn}/beta"])


def _maxpool(x, window, strides):
    return F.max_pool3d(pad_same(x, window, strides, value=float("-inf")), window, strides)


def _mixed(t, name: str, x):
    b0 = _unit(t, f"{name}/Branch_0/Conv3d_0a_1x1", x)
    b1 = _unit(t, f"{name}/Branch_1/Conv3d_0a_1x1", x)
    b1 = _unit(t, f"{name}/Branch_1/Conv3d_0b_3x3", b1)
    b2 = _unit(t, f"{name}/Branch_2/Conv3d_0a_1x1", x)
    b2 = _unit(t, f"{name}/Branch_2/Conv3d_0b_3x3", b2)
    b3 = _unit(t, f"{name}/Branch_3/Conv3d_0b_1x1", _maxpool(x, (3, 3, 3), (1, 1, 1)))
    return torch.cat([b0, b1, b2, b3], 1)


def _device_params(params: Dict[str, np.ndarray], device) -> dict:
    """The weights on ``device``: conv kernels as OIDHW, batch-norm
    vectors and the logits' bias as [1, C, 1, 1, 1]."""
    t = {}
    for k, v in params.items():
        v = torch.as_tensor(np.asarray(v, np.float32), device=device)
        t[k] = (v.permute(4, 3, 0, 1, 2).contiguous() if k.endswith("conv_3d/w")
                else v.reshape(1, -1, 1, 1, 1))
    return t


def i3d_logits(params: Dict[str, np.ndarray], video) -> torch.Tensor:
    """[B, T>=9, 224, 224, 3] in [-1, 1] -> Kinetics logits [B, 400]: the
    kinetics-i3d ``InceptionI3d`` up to its 'Logits' endpoint (the TF-Hub
    module's default output the reference's FVD uses)."""
    x = to_tensor(video).permute(0, 4, 1, 2, 3)
    t = _device_params(params, x.device)
    with float32_precision():
        x = _unit(t, "Conv3d_1a_7x7", x, strides=(2, 2, 2))
        x = _maxpool(x, (1, 3, 3), (1, 2, 2))
        x = _unit(t, "Conv3d_2b_1x1", x)
        x = _unit(t, "Conv3d_2c_3x3", x)
        x = _maxpool(x, (1, 3, 3), (1, 2, 2))
        x = _mixed(t, "Mixed_3b", x)
        x = _mixed(t, "Mixed_3c", x)
        x = _maxpool(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = _mixed(t, name, x)
        x = _maxpool(x, (2, 2, 2), (2, 2, 2))
        x = _mixed(t, "Mixed_5b", x)
        x = _mixed(t, "Mixed_5c", x)
        # average over (2, 7, 7), VALID; the logits conv (bias, no batch
        # norm); the mean over space, then over time
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        w = t[f"{_SCOPE}/Logits/Conv3d_0c_1x1/conv_3d/w"]
        x = F.conv3d(x, w) + t[f"{_SCOPE}/Logits/Conv3d_0c_1x1/conv_3d/b"]
    return x.mean((3, 4)).mean(2)


def expected_keys() -> list:
    """Every variable name the npz must contain (the loader's contract)."""
    keys = []

    def unit(name, bias=False):
        keys.append(f"{_SCOPE}/{name}/conv_3d/w")
        if bias:
            keys.append(f"{_SCOPE}/{name}/conv_3d/b")
        else:
            for s in ("beta", "moving_mean", "moving_variance"):
                keys.append(f"{_SCOPE}/{name}/batch_norm/{s}")

    unit("Conv3d_1a_7x7")
    unit("Conv3d_2b_1x1")
    unit("Conv3d_2c_3x3")
    for name in MIXED_CHANNELS:
        unit(f"{name}/Branch_0/Conv3d_0a_1x1")
        unit(f"{name}/Branch_1/Conv3d_0a_1x1")
        unit(f"{name}/Branch_1/Conv3d_0b_3x3")
        unit(f"{name}/Branch_2/Conv3d_0a_1x1")
        unit(f"{name}/Branch_2/Conv3d_0b_3x3")
        unit(f"{name}/Branch_3/Conv3d_0b_1x1")
    unit("Logits/Conv3d_0c_1x1", bias=True)
    return keys


def random_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights in the checkpoint's layout (loader tests); numpy's
    ``RandomState``, so the JAX package's function gives the same arrays."""
    rng = np.random.RandomState(seed)
    shapes = _shape_table()
    out = {}
    for k in expected_keys():
        if k.endswith("moving_variance"):
            out[k] = rng.uniform(0.5, 1.5, shapes[k]).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.05, shapes[k]).astype(np.float32)
    return out


def _shape_table() -> Dict[str, tuple]:
    """Variable name -> shape, derived from the architecture."""
    out: Dict[str, tuple] = {}

    def unit(name, k, cin, cout, bias=False):
        out[f"{_SCOPE}/{name}/conv_3d/w"] = (*k, cin, cout)
        if bias:
            out[f"{_SCOPE}/{name}/conv_3d/b"] = (cout,)
        else:
            for s in ("beta", "moving_mean", "moving_variance"):
                out[f"{_SCOPE}/{name}/batch_norm/{s}"] = (1, 1, 1, 1, cout)

    unit("Conv3d_1a_7x7", (7, 7, 7), 3, 64)
    unit("Conv3d_2b_1x1", (1, 1, 1), 64, 64)
    unit("Conv3d_2c_3x3", (3, 3, 3), 64, 192)
    cin = 192
    for name, (b0, b1a, b1b, b2a, b2b, b3b) in MIXED_CHANNELS.items():
        unit(f"{name}/Branch_0/Conv3d_0a_1x1", (1, 1, 1), cin, b0)
        unit(f"{name}/Branch_1/Conv3d_0a_1x1", (1, 1, 1), cin, b1a)
        unit(f"{name}/Branch_1/Conv3d_0b_3x3", (3, 3, 3), b1a, b1b)
        unit(f"{name}/Branch_2/Conv3d_0a_1x1", (1, 1, 1), cin, b2a)
        unit(f"{name}/Branch_2/Conv3d_0b_3x3", (3, 3, 3), b2a, b2b)
        unit(f"{name}/Branch_3/Conv3d_0b_1x1", (1, 1, 1), cin, b3b)
        cin = b0 + b1b + b2b + b3b
    unit("Logits/Conv3d_0c_1x1", (1, 1, 1), cin, NUM_CLASSES, bias=True)
    return out


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Load an I3D weights npz, its keys and shapes checked."""
    with np.load(path) as data:
        params = {k: data[k] for k in data.files}
    shapes = _shape_table()
    missing = [k for k in expected_keys() if k not in params]
    if missing:
        raise ValueError(f"i3d weights file missing {len(missing)} keys, "
                         f"first: {missing[:3]}")
    for k, shape in shapes.items():
        got, want = tuple(params[k].shape), tuple(shape)
        if k.endswith(("beta", "moving_mean", "moving_variance", "/b")):
            if int(np.prod(got)) != int(np.prod(want)):
                raise ValueError(f"{k}: shape {got} != {want}")
        elif got != want:
            raise ValueError(f"{k}: shape {got} != {want}")
    return params


def default_weights_path() -> Optional[str]:
    env = os.environ.get("RFT_I3D_WEIGHTS")
    if env and os.path.exists(env):
        return env
    for cand in ("./data/i3d_kinetics400.npz", "./i3d_kinetics400.npz"):
        if os.path.exists(cand):
            return cand
    return None


def preprocess_videos(videos) -> torch.Tensor:
    """[B, T, H, W, C] in [0, 1] -> [B, T, 224, 224, 3] in [-1, 1]: the
    reference FVD's bilinear resize (half-pixel centres, as
    ``jax.image.resize``; ``align_corners=False`` gives the same on an
    upscale, where no antialiasing applies) and scaling. Gray frames
    become three repeated channels."""
    x = to_tensor(videos)
    if x.shape[-1] == 1:
        x = x.expand(x.shape[:-1] + (3,))
    b, t, h, w, c = x.shape
    x = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(224, 224), mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1).reshape(b, t, 224, 224, c) * 2.0 - 1.0


def i3d_embed(videos, params: Dict[str, np.ndarray]) -> torch.Tensor:
    """The reference FVD embedding: [B, T, H, W, C] in [0, 1] -> the [B, 400]
    logits, on the device of ``videos`` (an array: on the card)."""
    return i3d_logits(params, preprocess_videos(videos))

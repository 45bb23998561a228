"""VGG-style structure-DSL feature extractor and condition generator
(NHWC), the counterparts of ``recurrent_flows_tpu.nn.vgg``.

Ops: int = 3x3 conv (no bias) + norm + activation, 'pool' = maxpool/2,
'conv' = strided conv x ``scale`` channels, 'squeeze' = space-to-depth
(h/2, 4·c) + norm + activation. The upscaler's up-ops (one per block after
the first): 'upsample' = nearest 2x, 'deconv' = a bias-free transposed
conv k4 s2 to c/``scale`` channels + norm + activation, 'squeeze' =
depth-to-space (2h, c/4) + norm + activation; the up-op's norm is
``b{l}_up_norm``, its transposed conv ``b{l}_up``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..config import UPSCALER_OPS
from ..utils.numerics import squeeze2d, unsqueeze2d
from .layers import (Conv2d, ConvTranspose2d, NormLayer, act, max_pool_nhwc,
                     upsample_nearest2x)


def downscaler_layer_sizes(structures, in_channels: int, image_size: int,
                           scale: int = 2):
    """Per-block output (H, W, C) of the extractor."""
    c, h = in_channels, image_size
    out = []
    for structure in structures:
        for i in structure:
            if i == "pool":
                h //= 2
            elif i == "conv":
                h //= 2
                c = int(c * scale)
            elif i == "squeeze":
                h //= 2
                c *= 4
            else:
                c = int(i)
        out.append((h, h, c))
    return out


class VGGDownscaler(nn.Module):
    """Feature extractor; returns the list of per-block outputs when
    ``skip_con``. The last layer of the last block is tanh'd."""

    def __init__(self, structures: Sequence[Sequence], in_channels: int,
                 norm_type: str = "batchnorm", non_lin: str = "relu",
                 scale: int = 2, skip_con: bool = False, tanh: bool = False,
                 track_running_stats: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        self.structures = tuple(tuple(s) for s in structures)
        self.non_lin, self.skip_con, self.tanh = non_lin, skip_con, tanh
        c = in_channels
        for l, structure in enumerate(self.structures):
            for count, i in enumerate(structure, start=1):
                name = f"b{l}_{count}"
                if i == "pool":
                    continue
                if i == "squeeze":
                    c *= 4
                    self.add_module(name + "_norm", NormLayer(
                        norm_type, c, track_running_stats, device=device))
                    continue
                out, stride = (int(c * scale), 2) if i == "conv" else (int(i), 1)
                self.add_module(name, Conv2d(c, out, 3, stride, use_bias=False,
                                             device=device, generator=generator))
                self.add_module(name + "_norm", NormLayer(
                    norm_type, out, track_running_stats, device=device))
                c = out

    def _activation(self, l, count, n, x):
        if l == len(self.structures) - 1 and count == n:
            return torch.tanh(x)
        if count == n and self.tanh:
            return 0.5 * torch.tanh(x)
        return act(x, self.non_lin)

    def forward(self, x, use_running_average: bool = False):
        outputs = []
        for l, structure in enumerate(self.structures):
            n = len(structure)
            for count, i in enumerate(structure, start=1):
                if i == "pool":
                    x = max_pool_nhwc(x)
                    continue
                name = f"b{l}_{count}"
                x = squeeze2d(x) if i == "squeeze" else getattr(self, name)(x)
                x = getattr(self, name + "_norm")(x, use_running_average)
                x = self._activation(l, count, n, x)
            if self.skip_con:
                outputs.append(x)
        return outputs if self.skip_con else x


class VGGUpscaler(nn.Module):
    """Condition generator: L blocks low-res -> high-res with optional
    per-scale skip concatenation; returns its outputs high-res first, of
    ``out_channels`` channels (high-res first)."""

    def __init__(self, structures: Sequence[Sequence], in_channels: int,
                 skip_channels: Sequence[int] | None = None,
                 norm_type: str = "batchnorm", non_lin: str = "leakyrelu",
                 scale: int = 2, tanh: bool = False,
                 track_running_stats: bool = False,
                 *, device=None, generator=None):
        """``skip_channels``: channels of the extractor's outputs, high-res
        first, when skips are concatenated; None for no skips."""
        super().__init__()
        self.structures = tuple(tuple(s) for s in structures)
        self.non_lin, self.tanh = non_lin, tanh
        self.skips = skip_channels is not None
        rev = list(skip_channels)[::-1] if self.skips else None
        c = in_channels
        self.up_ops, out_channels = [None], []
        for l, structure in enumerate(self.structures):
            up_ops = [i for i in structure if i in UPSCALER_OPS]
            if l > 0 and len(up_ops) != 1:
                raise ValueError("each block after the first needs one up-op")
            if l > 0:
                self.up_ops.append(up_ops[0])
                if up_ops[0] != "upsample":
                    if up_ops[0] == "deconv":
                        self.add_module(f"b{l}_up", ConvTranspose2d(
                            c, c // scale, use_bias=False, device=device,
                            generator=generator))
                    c = c // scale if up_ops[0] == "deconv" else c // 4
                    self.add_module(f"b{l}_up_norm", NormLayer(
                        norm_type, c, track_running_stats, device=device))
            if self.skips:
                c += rev[l]
            for count, ch in enumerate((i for i in structure if isinstance(i, int)),
                                       start=1):
                name = f"b{l}_{count}"
                self.add_module(name, Conv2d(c, ch, 3, use_bias=False,
                                             device=device, generator=generator))
                self.add_module(name + "_norm", NormLayer(
                    norm_type, ch, track_running_stats, device=device))
                c = ch
            out_channels.append(c)
        self.out_channels = out_channels[::-1]

    def _up(self, l, x, use_running_average):
        op = self.up_ops[l]
        if op == "upsample":
            return upsample_nearest2x(x)
        x = getattr(self, f"b{l}_up")(x) if op == "deconv" else unsqueeze2d(x)
        return act(getattr(self, f"b{l}_up_norm")(x, use_running_average), self.non_lin)

    def forward(self, x, skip_list=None, use_running_average: bool = False):
        outputs = []
        rev_skips = list(skip_list)[::-1] if self.skips else None
        for l, structure in enumerate(self.structures):
            if l > 0:
                x = self._up(l, x, use_running_average)
            if self.skips:
                x = torch.cat([x, rev_skips[l]], -1)
            convs = [i for i in structure if isinstance(i, int)]
            for count in range(1, len(convs) + 1):
                name = f"b{l}_{count}"
                x = getattr(self, name + "_norm")(getattr(self, name)(x),
                                                  use_running_average)
                if count == len(convs) and self.tanh:
                    x = 0.5 * torch.tanh(x)
                else:
                    x = act(x, self.non_lin)
            outputs.append(x)
        return outputs[::-1]

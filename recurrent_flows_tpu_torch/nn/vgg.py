"""VGG-style structure-DSL feature extractor and condition generator
(NHWC), the counterparts of ``recurrent_flows_tpu.nn.vgg``.

Ops: int = 3x3 conv (no bias) + norm + activation, 'pool' = maxpool/2,
'conv' = strided conv x ``scale`` channels, 'upsample' = nearest 2x.
'deconv' and 'squeeze' raise ``NotImplementedError``: no preset uses them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import Conv2d, NormLayer, act, max_pool_nhwc


def _unported(op):
    raise NotImplementedError(f"VGG op {op!r} is not ported yet "
                              "(ROADMAP.md queue 1, item 5b)")


def _upsample_nearest2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


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
            elif i in ("squeeze", "deconv"):
                _unported(i)
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
                if i in ("squeeze", "deconv"):
                    _unported(i)
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
                else:
                    name = f"b{l}_{count}"
                    x = getattr(self, name + "_norm")(getattr(self, name)(x),
                                                      use_running_average)
                    x = self._activation(l, count, n, x)
            if self.skip_con:
                outputs.append(x)
        return outputs if self.skip_con else x


class VGGUpscaler(nn.Module):
    """Condition generator: L blocks low-res -> high-res with optional
    per-scale skip concatenation; returns its outputs high-res first."""

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
        for l, structure in enumerate(self.structures):
            up_ops = [i for i in structure if i in ("upsample", "deconv", "squeeze")]
            if l > 0 and len(up_ops) != 1:
                raise ValueError("each block after the first needs one up-op")
            if l > 0 and up_ops[0] != "upsample":
                _unported(up_ops[0])
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

    def forward(self, x, skip_list=None, use_running_average: bool = False):
        outputs = []
        rev_skips = list(skip_list)[::-1] if self.skips else None
        for l, structure in enumerate(self.structures):
            if l > 0:
                x = _upsample_nearest2x(x)
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

"""Shared NN primitives (NHWC), the counterparts of
``recurrent_flows_tpu.nn.layers``.

Parameters keep the JAX package's names (``kernel``, ``bias``, ``scale``)
so ``convert.from_flax`` maps each leaf by its path; conv kernels are
stored OIHW for ``F.conv2d``. Convolutions take NHWC and run on the NCHW
view of the same memory (channels-last strides), so no copy is made.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def act(x: torch.Tensor, non_lin: str) -> torch.Tensor:
    """relu / leakyrelu(0.2)."""
    if non_lin == "relu":
        return F.relu(x)
    if non_lin == "leakyrelu":
        return F.leaky_relu(x, 0.2)
    raise ValueError(f"unknown activation: {non_lin}")


def conv_nhwc(x, kernel, bias=None, stride: int = 1):
    """kxk conv with explicit (k-1)//2 padding: x NHWC, kernel OIHW."""
    p = (kernel.shape[-1] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, bias, stride, p)
    return y.permute(0, 2, 3, 1)


def max_pool_nhwc(x):
    """2x2 max pool, stride 2, no padding."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def normal_(shape, std: float, generator, device) -> torch.Tensor:
    """N(0, std²) drawn from ``generator`` (on its device), moved to
    ``device``; std 0 gives zeros without drawing."""
    if std == 0:
        return torch.zeros(shape, device=device)
    gdev = generator.device if generator is not None else "cpu"
    t = torch.randn(shape, generator=generator, device=gdev) * std
    return t.to(device)


class Conv2d(nn.Module):
    """NHWC conv holding ``kernel`` [O,I,k,k] and an optional ``bias``.

    Init: kernel ~ N(0, kernel_std²) (default 1/fan_in, lecun-normal-like),
    bias zero or, with ``bias_uniform``, U[0, 1).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True,
                 kernel_std: float | None = None, bias_uniform: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        self.stride = stride
        if kernel_std is None:
            kernel_std = 1.0 / math.sqrt(in_channels * kernel * kernel)
        self.kernel = nn.Parameter(normal_(
            (out_channels, in_channels, kernel, kernel), kernel_std,
            generator, device))
        if use_bias:
            b = torch.zeros(out_channels, device=device)
            if bias_uniform:
                gdev = generator.device if generator is not None else "cpu"
                b = torch.rand(out_channels, generator=generator,
                               device=gdev).to(device)
            self.bias = nn.Parameter(b)
        else:
            self.bias = None

    def forward(self, x):
        return conv_nhwc(x, self.kernel, self.bias, self.stride)


class NormLayer(nn.Module):
    """{batchnorm | instancenorm | none}. Batch norm uses the current
    batch's statistics over axes (0,1,2), biased variance, eps 1e-5 inside
    the rsqrt, and keeps no running averages."""

    def __init__(self, norm_type: str, channels: int, *, device=None):
        super().__init__()
        if norm_type not in ("batchnorm", "instancenorm", "none"):
            raise ValueError(f"unknown norm type: {norm_type}")
        self.norm_type = norm_type
        if norm_type == "batchnorm":
            self.scale = nn.Parameter(torch.ones(channels, device=device))
            self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        if self.norm_type == "none":
            return x
        axes = (0, 1, 2) if self.norm_type == "batchnorm" else (1, 2)
        mean = x.mean(axes, keepdim=True)
        var = (x - mean).square().mean(axes, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        if self.norm_type == "batchnorm":
            y = y * self.scale + self.bias
        return y


class SimpleParamNet(nn.Module):
    """Conv stack from the structure DSL -> (loc, softplus scale); the RFN
    prior and encoder. int = 3x3 conv, 'pool' = maxpool/2, 'conv' =
    strided conv multiplying channels by ``scale``."""

    def __init__(self, structure: Sequence, in_channels: int,
                 out_channels: int, norm_type: str = "batchnorm",
                 non_lin: str = "leakyrelu", scale: int = 2,
                 *, device=None, generator=None):
        super().__init__()
        self.structure = tuple(structure)
        self.non_lin = non_lin
        c = in_channels
        kw = dict(device=device, generator=generator)
        for j, i in enumerate(self.structure):
            if i == "pool":
                continue
            if i == "conv":
                out, stride = int(scale * c), 2
            else:
                out, stride = int(i), 1
            self.add_module(f"conv_{j}", Conv2d(c, out, 3, stride, **kw))
            self.add_module(f"norm_{j}", NormLayer(norm_type, out,
                                                   device=device))
            c = out
        self.param_conv = Conv2d(c, 2 * out_channels, 3, **kw)

    def forward(self, x):
        for j, i in enumerate(self.structure):
            if i == "pool":
                x = max_pool_nhwc(x)
            else:
                x = getattr(self, f"conv_{j}")(x)
                x = act(getattr(self, f"norm_{j}")(x), self.non_lin)
        loc, log_scale = torch.chunk(self.param_conv(x), 2, dim=-1)
        return loc, F.softplus(log_scale)

"""Shared NN primitives (NHWC), the counterparts of
``recurrent_flows_tpu.nn.layers``.

Parameters keep the JAX package's names (``kernel``, ``bias``, ``scale``)
so ``convert.from_flax`` maps each leaf by its path; conv kernels are
stored OIHW for ``F.conv2d``, transposed-conv kernels (I, O, kH, kW)
spatially flipped for ``F.conv_transpose2d`` (``convert`` does both), and a
``Dense`` kernel keeps flax's [in, out] layout (``x @ kernel``), so it
converts as it is. Convolutions take NHWC and hand ``F.conv2d`` the NCHW
view of the same memory (channels-last strides). PyTorch copies nothing,
but in float32 with TF32 off cuDNN has no channels-last fprop on the H100:
it runs its NCHW kernel between transposes of its own (input and output,
and their gradients in the backward). The flow's coupling net, whose maps
are the widest, runs channel-major instead (``flows.modules``).

Inside a train step on a (data x model) grid (``parallel.mesh.grid``) the
spatial ops work on this rank's rows of every map: a 3x3 conv pads its
rows with its neighbours' (a stride-2 one with one row on top, where its
local height is even), the k4 s2 transposed conv takes one row each side,
the 2x2 pool and the upsample keep to their own rows; an op that cannot
(an odd local height in front of the pool or a stride-2 conv, a 'VALID'
conv) gathers the rows and computes replicated; every op's output keeps
its own rows again where its height divides over 'model'.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import batch_mean, grid, own_rows
from ..utils.running_stats import ema_, layer_stats_update


def act(x: torch.Tensor, non_lin: str) -> torch.Tensor:
    """relu / leakyrelu(0.2)."""
    if non_lin == "relu":
        return F.relu(x)
    if non_lin == "leakyrelu":
        return F.leaky_relu(x, 0.2)
    raise ValueError(f"unknown activation: {non_lin}")


def _conv(x, kernel, bias, stride, padding):
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, bias, stride, padding)
    return y.permute(0, 2, 3, 1)


def conv_nhwc(x, kernel, bias=None, stride: int = 1, padding: int | None = None):
    """kxk conv, x NHWC, kernel OIHW, with explicit (k-1)//2 padding per
    side unless ``padding`` is given (0 is flax's 'VALID'). On a grid: the
    halo rows in place of the padding of H (module docstring)."""
    k = kernel.shape[-1]
    p = (k - 1) // 2 if padding is None else padding
    g = grid()
    if g is None:
        return _conv(x, kernel, bias, stride, p)
    x = g.reshard(x)
    if g.sharded(x) and k > 1:
        h = x.shape[1]
        if stride == 1 and k % 2 and p == (k - 1) // 2 and h >= p:
            return _conv(g.halo(x, p, p), kernel, bias, 1, (0, p))
        if (k, stride, p) == (3, 2, 1) and h % 2 == 0:
            # output row i reads input rows 2i-1 .. 2i+1: one row from above
            return _conv(g.halo(x, 1, 0), kernel, bias, 2, (0, 1))
        x = g.gather(x)
    return g.reshard(_conv(x, kernel, bias, stride, p))


def _halving(x):
    """x ready for an op that halves its height on a grid: its own rows
    where their count is even, else the whole frame."""
    g = grid()
    if g is None:
        return x
    x = g.reshard(x)
    return g.gather(x) if g.sharded(x) and x.shape[1] % 2 else x


def max_pool_nhwc(x):
    """2x2 max pool, stride 2, no padding."""
    y = F.max_pool2d(_halving(x).permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return own_rows(y)


def upsample_nearest2x(x):
    """Nearest-neighbour 2x upsample of an NHWC map."""
    x = own_rows(x)
    return own_rows(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


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

    Padding (k-1)//2 per side, or ``padding``. Init: kernel ~ N(0,
    kernel_std²) (default 1/fan_in, lecun-normal-like), bias zero or, with
    ``bias_uniform``, U[0, 1).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True,
                 kernel_std: float | None = None, bias_uniform: bool = False,
                 padding: int | None = None, *, device=None, generator=None):
        super().__init__()
        self.stride, self.padding = stride, padding
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
        return conv_nhwc(x, self.kernel, self.bias, self.stride, self.padding)


class ConvTranspose2d(nn.Module):
    """NHWC transposed conv, the counterpart of flax's ``nn.ConvTranspose``
    (``transpose_kernel=False``), holding ``kernel`` [I, O, k, k] for
    ``F.conv_transpose2d`` and a ``bias``.

    flax convolves the stride-dilated input with its [k, k, I, O] kernel as
    stored; ``F.conv_transpose2d`` convolves with the kernel flipped, so
    ``convert.from_flax`` flips H and W as it maps HWIO -> IOHW. flax's
    'SAME' at k=4, s=2 pads the dilated input by (2, 2), which is torch's
    ``padding=1`` (both give 2n); its 'VALID' pads it by k-1, torch's
    ``padding=0``. Init: kernel ~ N(0, 1/(k²·I)), bias zero. ``use_bias``
    as flax's ``nn.ConvTranspose`` (default True); the VGG upscaler's
    'deconv' passes False, as JAX's ``deconv2d`` defaults to.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 4,
                 stride: int = 2, padding: str = "SAME", use_bias: bool = True,
                 *, device=None, generator=None):
        super().__init__()
        if padding == "SAME" and (kernel, stride) != (4, 2):
            raise ValueError("ConvTranspose2d: 'SAME' is ported for k=4, s=2 only")
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"ConvTranspose2d: unknown padding {padding!r}")
        self.stride = stride
        self.padding = 1 if padding == "SAME" else 0
        self.kernel = nn.Parameter(normal_(
            (in_channels, out_channels, kernel, kernel),
            1.0 / math.sqrt(in_channels * kernel * kernel), generator, device))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device)) if use_bias
                     else None)

    def forward(self, x):
        """On a grid the 'SAME' k4 s2 op takes one halo row each side and
        pads H by 3 (output row o of the local rows reads input rows
        (o-2)/2 .. (o+1)/2); a 'VALID' one computes replicated."""
        g = grid()
        pad = self.padding
        if g is not None:
            x = g.reshard(x)
            if g.sharded(x) and pad == 1:
                x, pad = g.halo(x, 1, 1), (3, 1)
            else:
                x = g.gather(x)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.kernel, self.bias,
                               self.stride, pad)
        return own_rows(y.permute(0, 2, 3, 1))


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``x @ kernel + bias`` with ``kernel`` [in, out]
    in flax's layout. Init: kernel ~ N(0, 1/in), bias zero."""

    def __init__(self, in_features: int, out_features: int, *, device=None,
                 generator=None):
        super().__init__()
        self.kernel = nn.Parameter(normal_((in_features, out_features),
                                           1.0 / math.sqrt(in_features),
                                           generator, device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return x @ self.kernel + self.bias


class NormLayer(nn.Module):
    """{batchnorm | instancenorm | none}. Batch norm normalises with the
    current batch's statistics over axes (0,1,2) (of the global batch in a
    data-parallel or grid step: ``parallel.batch_mean``), biased variance, eps 1e-5
    inside the rsqrt. With ``track_running_stats`` it also keeps running
    averages in torch's convention (momentum 0.1, new = (1-m)·old +
    m·batch, the unbiased variance), updated only in a refresh pass
    (``utils.running_stats.updating_running_stats``, never in its
    ``initializing`` form), and ``use_running_average`` normalises with
    them."""

    def __init__(self, norm_type: str, channels: int,
                 track_running_stats: bool = False, momentum: float = 0.1,
                 *, device=None):
        super().__init__()
        if norm_type not in ("batchnorm", "instancenorm", "none"):
            raise ValueError(f"unknown norm type: {norm_type}")
        self.norm_type = norm_type
        self.momentum = momentum
        self.track = norm_type == "batchnorm" and track_running_stats
        if norm_type == "batchnorm":
            self.scale = nn.Parameter(torch.ones(channels, device=device))
            self.bias = nn.Parameter(torch.zeros(channels, device=device))
        if self.track:
            self.register_buffer("running_mean", torch.zeros(channels, device=device))
            self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x, use_running_average: bool = False):
        if self.norm_type == "none":
            return x
        if self.track and use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            if self.norm_type == "batchnorm":
                moment = lambda t: batch_mean(t, (0, 1, 2), keepdim=True)
            else:
                moment = lambda t: batch_mean(t, (1, 2), keepdim=True)
            mean = moment(x)
            var = moment((x - mean).square())
            if self.track and layer_stats_update():
                n = x.shape[0] * x.shape[1] * x.shape[2]
                ema_(self.running_mean, mean.reshape(-1), 1.0 - self.momentum)
                ema_(self.running_var, var.reshape(-1) * (n / max(n - 1, 1)),
                     1.0 - self.momentum)
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
                 track_running_stats: bool = False,
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
                                                   track_running_stats,
                                                   device=device))
            c = out
        self.param_conv = Conv2d(c, 2 * out_channels, 3, **kw)

    def forward(self, x, use_running_average: bool = False):
        for j, i in enumerate(self.structure):
            if i == "pool":
                x = max_pool_nhwc(x)
            else:
                x = getattr(self, f"conv_{j}")(x)
                x = act(getattr(self, f"norm_{j}")(x, use_running_average),
                        self.non_lin)
        loc, log_scale = torch.chunk(self.param_conv(x), 2, dim=-1)
        return loc, F.softplus(log_scale)

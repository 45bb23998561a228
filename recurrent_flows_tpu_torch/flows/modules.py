"""Glow building blocks (NHWC), the counterparts of
``recurrent_flows_tpu.flows.modules``: ``forward`` is the density
direction (x -> z, with the log-determinant), ``reverse`` the sampling
direction.

Weight folds are always on, as in the JAX package's default: the actnorm
of a ``Conv2dNorm`` and the gain of a ``Conv2dZeros`` are folded into their
conv kernels, and the step actnorm into the 1x1 (forward through the
``actnorm_invconv`` kernel). The data-dependent-init pass (``ddi=True``,
see ``flows/ddi.py``) is the exception: there every ActNorm runs unfolded
on its own input, sets its ``bias``/``logs`` from it in place, and uses
the fresh values. BatchNormFlow is not ported yet (ROADMAP.md queue 1,
item 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv2d, act, conv_nhwc
from ..ops.fused import actnorm_invconv, coupling_transform
from ..ops.glowstep import clamp
from ..utils.numerics import batch_reduce, normal_log_prob, split_feature


class ActNorm(nn.Module):
    """Per-channel y = (x + bias)·e^logs; logdet += Σ logs · H·W. Outside
    the DDI pass it is folded into the adjacent conv or 1x1, so only its
    parameters are read."""

    def __init__(self, num_channels: int, *, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))
        self.logs = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x, logdet=None, ddi: bool = False):
        """With ``ddi`` (under ``torch.no_grad()``), first set ``bias`` and
        ``logs`` in place so that the output has zero mean and unit
        standard deviation (ddof=1) per channel over this input."""
        if ddi:
            flat = x.reshape(-1, x.shape[-1])
            self.bias.copy_(-flat.mean(0))
            self.logs.copy_(torch.log(1.0 / (flat.std(0, unbiased=True) + 1e-6)))
        y = (x + self.bias) * torch.exp(self.logs)
        if logdet is not None:
            logdet = logdet + self.logs.sum() * (x.shape[1] * x.shape[2])
        return y, logdet


class InvConv(nn.Module):
    """LU-parameterized invertible 1x1 conv. ``p`` and ``sign_s`` are
    buffers (the JAX package's 'consts' collection)."""

    def __init__(self, num_channels: int, *, device=None, generator=None):
        super().__init__()
        c = num_channels
        gdev = generator.device if generator is not None else "cpu"
        a = torch.randn((c, c), generator=generator, device=gdev).double()
        q, r = torch.linalg.qr(a)
        w0 = (q * torch.sign(torch.diagonal(r))).cpu()  # orthogonal init
        p0, l0, u0 = torch.linalg.lu(w0)
        s0 = torch.diagonal(u0)
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("p", p0.to(**f32))
        self.register_buffer("sign_s", torch.sign(s0).to(**f32))
        self.lower = nn.Parameter(l0.to(**f32))
        self.log_s = nn.Parameter(torch.log(torch.abs(s0)).to(**f32))
        self.upper = nn.Parameter(torch.triu(u0, 1).to(**f32))

    def weight(self, reverse: bool):
        """W = P·L·U, or W⁻¹ = U⁻¹·L⁻¹·Pᵀ by triangular solves."""
        c = self.log_s.shape[0]
        eye = torch.eye(c, device=self.lower.device)
        l_mask = torch.tril(torch.ones_like(eye), -1)
        lower = self.lower * l_mask + eye
        upper = self.upper * l_mask.T + torch.diag(self.sign_s * torch.exp(self.log_s))
        if not reverse:
            return self.p @ lower @ upper
        u_inv = torch.linalg.solve_triangular(upper, eye, upper=True)
        l_inv = torch.linalg.solve_triangular(lower, eye, upper=False,
                                              unitriangular=True)
        return u_inv @ l_inv @ self.p.T

    def forward(self, x, logdet=None, fold_bias=None, fold_logs=None):
        """x·Wᵀ; with ``fold_bias``/``fold_logs`` the step actnorm before it
        is folded in, ((x + b)·e^s)·Wᵀ, through the ``actnorm_invconv``
        kernel, and its logdet Σ s·H·W is accounted here."""
        w = self.weight(reverse=False)
        dlogdet = self.log_s.sum()
        if fold_bias is not None:
            z = actnorm_invconv(x.contiguous(), fold_bias, fold_logs,
                                w.contiguous())
            dlogdet = dlogdet + fold_logs.sum()
        else:
            z = x @ w.T
        if logdet is not None:
            logdet = logdet + dlogdet * (x.shape[1] * x.shape[2])
        return z, logdet

    def reverse(self, x, fold_bias, fold_logs):
        """Inverse 1x1, then the inverse of the step actnorm folded in:
        (y·W⁻ᵀ)·e^{-s} - b == y·(diag(e^{-s})·W⁻¹)ᵀ - b."""
        w = self.weight(reverse=True) * torch.exp(-fold_logs)[:, None]
        return x @ w.T - fold_bias


class Conv2dNorm(nn.Module):
    """Conv (kernel ~ N(0, 0.05²), no bias) + actnorm, the actnorm folded
    into the kernel: conv_{W·e^logs}(x) + b·e^logs. The DDI pass runs the
    actnorm unfolded, on the raw conv output."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 *, device=None, generator=None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel, use_bias=False,
                           kernel_std=0.05, device=device, generator=generator)
        self.actnorm = ActNorm(out_channels, device=device)

    def forward(self, x, ddi: bool = False):
        if ddi:
            return self.actnorm(conv_nhwc(x, self.conv.kernel), ddi=True)[0]
        g = torch.exp(self.actnorm.logs)
        return conv_nhwc(x, self.conv.kernel * g[:, None, None, None],
                         self.actnorm.bias * g)


class Conv2dZeros(nn.Module):
    """Zero-initialized conv with output gain e^{3·logs}, folded:
    conv_{W·g}(x) + b·g."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 *, device=None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel, kernel_std=0.0,
                           device=device)
        self.logs = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x):
        g = torch.exp(self.logs * 3.0)
        return conv_nhwc(x, self.conv.kernel * g[:, None, None, None],
                         self.conv.bias * g)


class AffineCoupling(nn.Module):
    """Conditional affine coupling with 4 clamps: forward
    z2' = (z2 + shift)·e^s, logdet += Σ s; both directions end in the
    ``coupling_transform`` kernel."""

    def __init__(self, x_channels: int, cond_channels: int,
                 hidden_units: int = 256, non_lin: str = "relu",
                 clamp_type: str = "realnvp", *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.non_lin, self.clamp_type = non_lin, clamp_type
        self.net0 = Conv2dNorm(x_channels // 2 + cond_channels, hidden_units, 3, **kw)
        self.net1 = Conv2dNorm(hidden_units, hidden_units, 1, **kw)
        self.net2 = Conv2dZeros(hidden_units, x_channels, 3, device=device)
        if clamp_type == "realnvp":
            half = x_channels // 2
            self.scale = nn.Parameter(torch.zeros(half, device=device))
            self.scale_shift = nn.Parameter(torch.zeros(half, device=device))
        else:
            self.scale = self.scale_shift = None

    def _transform(self, x, condition, reverse: bool, ddi: bool = False):
        z1, z2 = split_feature(x, "split")
        h = act(self.net0(torch.cat([z1, condition], -1), ddi), self.non_lin)
        h = act(self.net1(h, ddi), self.non_lin)
        shift, log_scale = split_feature(self.net2(h), "cross")
        s = clamp(log_scale, self.clamp_type, self.scale, self.scale_shift)
        z2, ld = coupling_transform(z2.contiguous(), shift.contiguous(),
                                    s.contiguous(), reverse=reverse)
        return torch.cat([z1, z2], -1), ld

    def forward(self, x, condition, logdet=None, ddi: bool = False):
        y, ld = self._transform(x, condition, False, ddi)
        return y, (logdet + ld if logdet is not None else None)

    def reverse(self, x, condition):
        """(x, coupling logdet [B]) of the inverse coupling."""
        return self._transform(x, condition, True)


class Split2d(nn.Module):
    """Multiscale split with a learned conditional Gaussian p(z2 | z1, cond):
    forward drops z2 and adds its log-likelihood to the objective, the
    sampling direction draws z2 ~ N(mean, (sigma·T)²)."""

    def __init__(self, x_channels: int, cond_channels: int,
                 make_conditional: bool = True,
                 clamp_function: str = "softplus", non_lin: str = "relu",
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.make_conditional = make_conditional
        self.clamp_function, self.non_lin = clamp_function, non_lin
        cin = x_channels // 2
        if make_conditional:
            c = cond_channels
            self.cond0 = Conv2dNorm(c, c, 3, **kw)
            self.cond1 = Conv2dNorm(c, c, 1, **kw)
            cin += c
        self.conv = Conv2dZeros(cin, x_channels, 3, device=device)

    def _prior(self, z1, condition, ddi: bool = False):
        """(mean, sigma) of p(z2 | z1, condition)."""
        h = z1
        if self.make_conditional:
            cond = act(self.cond0(condition, ddi), self.non_lin)
            cond = act(self.cond1(cond, ddi), self.non_lin)
            h = torch.cat([z1, cond], -1)
        mean, log_scale = split_feature(self.conv(h), "cross")
        if self.clamp_function == "softplus":
            return mean, F.softplus(log_scale) + 1e-8
        return mean, torch.exp(log_scale)

    def forward(self, x, condition, logdet=None, ddi: bool = False):
        z1, z2 = split_feature(x, "split")
        mean, sigma = self._prior(z1, condition, ddi)
        if logdet is not None:
            logdet = logdet + batch_reduce(normal_log_prob(z2, mean, sigma))
        return z1, logdet

    def reverse(self, z1, condition, noise, temperature: float = 1.0):
        mean, sigma = self._prior(z1, condition)
        z2 = mean + sigma * temperature * noise.normal(mean)
        return torch.cat([z1, z2], -1)

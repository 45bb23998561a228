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
the fresh values. A ``Conv2dNorm`` with a batch norm or no norm, and the
``BatchNormFlow`` step norm, have nothing to fold.

Every map is NHWC except inside ``AffineCoupling``'s net, which runs
channel-major: its input ``cat([z1, condition])`` and its two U-wide hidden
maps are contiguous NCHW, and only its C-wide output comes back NHWC for
the ``coupling_transform`` kernel. cuDNN has no channels-last fprop in
float32 with TF32 off; handed NHWC memory it runs its NCHW kernels between
transposes of its own, of the U-wide maps both ways and in the backward
too. Channel-major, only the narrow maps move: z1 (C/2 channels) and the
output (C) per step, the condition once per scale (``ListGlow`` passes it
to its K steps as ``condition_cm``). ``AffineCoupling.channel_major_runs``
counts the nets run so. cuDNN picks other backward kernels for NCHW maps,
not all faster (the 1x1's weight gradient takes about twice as long at
32x32), but a training step is faster in all (``PERF.md`` §6).

On a (data x model) grid (``parallel.mesh``) every log-determinant term is
this rank's share: per-pixel terms times ``pixel_share``, sums over a map
through ``batch_reduce``/``Mesh.share``, and a ``BatchNormFlow`` uses its
own rows of its per-position parameters. There the coupling net stays NHWC,
since ``conv_nhwc``'s halo exchange works on NHWC rows
(``AffineCoupling.nhwc_runs`` counts those nets).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv2d, act, conv_nhwc
from ..ops.fused import actnorm_invconv, coupling_transform
from ..ops.glowstep import clamp
from ..parallel.mesh import batch_mean, grid
from ..utils.numerics import batch_reduce, normal_log_prob, pixel_share, split_feature
from ..utils.running_stats import ema_, flow_stats_update


def to_channel_major(x: torch.Tensor) -> torch.Tensor:
    """An NHWC map as a contiguous [B, C, H, W] copy."""
    return x.permute(0, 3, 1, 2).contiguous()


def _conv_cm(x, kernel, bias=None):
    """kxk conv of a contiguous NCHW map, (k-1)//2 padding per side."""
    return F.conv2d(x, kernel, bias, 1, (kernel.shape[-1] - 1) // 2)


def _per_channel(v, channel_major: bool):
    """A [C] parameter broadcast over an NCHW map, or as it is for NHWC."""
    return v[:, None, None] if channel_major else v


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
            logdet = logdet + self.logs.sum() * pixel_share(x)
        return y, logdet


class BatchNormFlow(nn.Module):
    """RealNVP-style batch-norm bijection with per-position parameters and
    running statistics, all [H, W, C]. The forward in training mode
    normalises with the batch's mean and biased variance over axis 0 (the
    global batch's in a data-parallel step: ``parallel.batch_mean``), eps
    added into the variance (and into what the running variance stores);
    otherwise, and always in reverse, with the running statistics. These
    update, r <- momentum·r + (1-momentum)·batch, only inside
    ``utils.running_stats.updating_running_stats``."""

    def __init__(self, spatial_shape, momentum: float = 0.0, eps: float = 1e-5,
                 *, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        shape = tuple(spatial_shape)
        self.log_gamma = nn.Parameter(torch.zeros(shape, device=device))
        self.beta = nn.Parameter(torch.zeros(shape, device=device))
        self.register_buffer("running_mean", torch.zeros(shape, device=device))
        self.register_buffer("running_var", torch.ones(shape, device=device))

    def forward(self, x, logdet=None, training: bool = True):
        """On a grid where x holds its rows: the rows of ``log_gamma``,
        ``beta`` and the running statistics at those rows."""
        log_gamma, beta = self.log_gamma, self.beta
        g = grid()
        rows = g is not None and g.sharded(x)
        if rows:
            log_gamma, beta = g.rows_of(log_gamma, 0), g.rows_of(beta, 0)
        if training:
            mean = batch_mean(x, 0)
            var = batch_mean((x - mean).square(), 0) + self.eps
            if flow_stats_update():
                ema_(self.running_mean, mean, self.momentum)
                ema_(self.running_var, var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
            if rows:
                mean, var = g.rows_of(mean, 0), g.rows_of(var, 0)
        y = torch.exp(log_gamma) * (x - mean) * torch.rsqrt(var) + beta
        if logdet is not None:
            ld = (log_gamma - 0.5 * torch.log(var)).sum()
            logdet = logdet + (ld if g is None else g.share(ld, x))
        return y, logdet

    def reverse(self, y):
        """The inverse, with the running statistics."""
        return ((y - self.beta) * torch.exp(-self.log_gamma)
                * torch.sqrt(self.running_var) + self.running_mean)


def _orthogonal(c: int, generator) -> torch.Tensor:
    """A random orthogonal [c, c] matrix (float64, CPU): QR of a normal
    draw, the signs of R's diagonal moved into Q."""
    gdev = generator.device if generator is not None else "cpu"
    a = torch.randn((c, c), generator=generator, device=gdev).double()
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))).cpu()


class InvConv(nn.Module):
    """Invertible 1x1 conv: LU-parameterized (``p`` and ``sign_s`` are
    buffers, the JAX package's 'consts' collection), or with
    ``lu_decomposed=False`` a plain ``weight`` [C, C] whose log-determinant
    is slogdet(W) and whose inverse is inv(W)."""

    def __init__(self, num_channels: int, lu_decomposed: bool = True,
                 *, device=None, generator=None):
        super().__init__()
        self.lu_decomposed = lu_decomposed
        w0 = _orthogonal(num_channels, generator)  # orthogonal init
        f32 = dict(dtype=torch.float32, device=device)
        if not lu_decomposed:
            self.weight = nn.Parameter(w0.to(**f32))
            return
        p0, l0, u0 = torch.linalg.lu(w0)
        s0 = torch.diagonal(u0)
        self.register_buffer("p", p0.to(**f32))
        self.register_buffer("sign_s", torch.sign(s0).to(**f32))
        self.lower = nn.Parameter(l0.to(**f32))
        self.log_s = nn.Parameter(torch.log(torch.abs(s0)).to(**f32))
        self.upper = nn.Parameter(torch.triu(u0, 1).to(**f32))

    def matrix(self, reverse: bool):
        """W, or W⁻¹: inv(W) for the plain weight, U⁻¹·L⁻¹·Pᵀ by
        triangular solves under LU (W = P·L·U)."""
        if not self.lu_decomposed:
            return torch.linalg.inv(self.weight) if reverse else self.weight
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

    def log_det_px(self):
        """log|det W|, the log-determinant per pixel."""
        if not self.lu_decomposed:
            return torch.linalg.slogdet(self.weight)[1]
        return self.log_s.sum()

    def forward(self, x, logdet=None, fold_bias=None, fold_logs=None):
        """x·Wᵀ; with ``fold_bias``/``fold_logs`` the step actnorm before it
        is folded in, ((x + b)·e^s)·Wᵀ, through the ``actnorm_invconv``
        kernel, and its logdet Σ s·H·W is accounted here."""
        w = self.matrix(reverse=False)
        dlogdet = self.log_det_px()
        if fold_bias is not None:
            z = actnorm_invconv(x.contiguous(), fold_bias, fold_logs,
                                w.contiguous())
            dlogdet = dlogdet + fold_logs.sum()
        else:
            z = x @ w.T
        if logdet is not None:
            logdet = logdet + dlogdet * pixel_share(x)
        return z, logdet

    def reverse(self, x, fold_bias=None, fold_logs=None):
        """Inverse 1x1, x·W⁻ᵀ; with ``fold_bias``/``fold_logs`` then the
        inverse of the step actnorm folded in:
        (y·W⁻ᵀ)·e^{-s} - b == y·(diag(e^{-s})·W⁻¹)ᵀ - b."""
        w = self.matrix(reverse=True)
        if fold_bias is None:
            return x @ w.T
        return x @ (w * torch.exp(-fold_logs)[:, None]).T - fold_bias


class Conv2dNorm(nn.Module):
    """Conv (kernel ~ N(0, 0.05²)) + ``norm``. 'actnorm' (no conv bias): the
    actnorm folded into the kernel, conv_{W·e^logs}(x) + b·e^logs; the DDI
    pass runs it unfolded, on the raw conv output. 'batchnorm': the conv
    with its bias, then a batch norm over (B, H, W) with the batch's
    statistics only (biased variance, eps 1e-5; the global batch's in a
    data-parallel step) and ``bn_scale``/``bn_bias``.
    'none': the conv with its bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 norm: str = "actnorm", *, device=None, generator=None):
        super().__init__()
        self.norm = norm
        self.conv = Conv2d(in_channels, out_channels, kernel,
                           use_bias=norm != "actnorm", kernel_std=0.05,
                           device=device, generator=generator)
        if norm == "actnorm":
            self.actnorm = ActNorm(out_channels, device=device)
        elif norm == "batchnorm":
            self.bn_scale = nn.Parameter(torch.ones(out_channels, device=device))
            self.bn_bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x, ddi: bool = False, channel_major: bool = False):
        """x NHWC, or with ``channel_major`` contiguous NCHW (the coupling
        net's; the output then is too)."""
        conv = _conv_cm if channel_major else conv_nhwc
        if self.norm != "actnorm":
            y = conv(x, self.conv.kernel, self.conv.bias)
            if self.norm == "batchnorm":
                axes = (0, 2, 3) if channel_major else (0, 1, 2)
                mean = batch_mean(y, axes, keepdim=True)
                var = batch_mean((y - mean).square(), axes, keepdim=True)
                scale, bias = (_per_channel(p, channel_major)
                               for p in (self.bn_scale, self.bn_bias))
                y = (y - mean) * torch.rsqrt(var + 1e-5) * scale + bias
            return y
        if ddi:
            y = conv(x, self.conv.kernel)
            if not channel_major:
                return self.actnorm(y, ddi=True)[0]
            # ActNorm takes channels last: an NHWC view of the NCHW map, whose
            # elementwise result keeps the NCHW memory
            return self.actnorm(y.permute(0, 2, 3, 1), ddi=True)[0].permute(0, 3, 1, 2)
        g = torch.exp(self.actnorm.logs)
        return conv(x, self.conv.kernel * g[:, None, None, None], self.actnorm.bias * g)


class Conv2dZeros(nn.Module):
    """Zero-initialized conv with output gain e^{3·logs}, folded:
    conv_{W·g}(x) + b·g."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 *, device=None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel, kernel_std=0.0,
                           device=device)
        self.logs = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x, channel_major: bool = False):
        """x NHWC, or with ``channel_major`` contiguous NCHW (the output
        too)."""
        g = torch.exp(self.logs * 3.0)
        conv = _conv_cm if channel_major else conv_nhwc
        return conv(x, self.conv.kernel * g[:, None, None, None], self.conv.bias * g)


class AffineCoupling(nn.Module):
    """Conditional affine coupling with 4 clamps: forward
    z2' = (z2 + shift)·e^s, logdet += Σ s; both directions end in the
    ``coupling_transform`` kernel. ``norm`` is the norm of the net's two
    ``Conv2dNorm`` (GlowConfig.coupling_norm). The net runs channel-major
    off a grid, NHWC on one (module docstring); ``channel_major_runs`` and
    ``nhwc_runs`` count the nets run each way."""

    channel_major_runs = 0
    nhwc_runs = 0

    def __init__(self, x_channels: int, cond_channels: int,
                 hidden_units: int = 256, non_lin: str = "relu",
                 clamp_type: str = "realnvp", norm: str = "actnorm",
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.non_lin, self.clamp_type = non_lin, clamp_type
        self.net0 = Conv2dNorm(x_channels // 2 + cond_channels, hidden_units, 3,
                               norm, **kw)
        self.net1 = Conv2dNorm(hidden_units, hidden_units, 1, norm, **kw)
        self.net2 = Conv2dZeros(hidden_units, x_channels, 3, device=device)
        if clamp_type == "realnvp":
            half = x_channels // 2
            self.scale = nn.Parameter(torch.zeros(half, device=device))
            self.scale_shift = nn.Parameter(torch.zeros(half, device=device))
        else:
            self.scale = self.scale_shift = None

    def _net(self, z1, condition, ddi: bool, condition_cm=None):
        """The net's output [B, H, W, C], contiguous NHWC. Off a grid the net
        runs on contiguous NCHW maps: ``condition_cm`` is ``condition`` so
        (made here where not given)."""
        cm = grid() is None
        if cm:
            AffineCoupling.channel_major_runs += 1
            if condition_cm is None:
                condition_cm = to_channel_major(condition)
            # cat reads z1's strided view; its output is contiguous NCHW
            h = torch.cat([z1.permute(0, 3, 1, 2), condition_cm], 1)
        else:
            AffineCoupling.nhwc_runs += 1
            h = torch.cat([z1, condition], -1)
        h = act(self.net0(h, ddi, channel_major=cm), self.non_lin)
        h = act(self.net1(h, ddi, channel_major=cm), self.non_lin)
        out = self.net2(h, channel_major=cm)
        return out.permute(0, 2, 3, 1).contiguous() if cm else out

    def _transform(self, x, condition, reverse: bool, ddi: bool = False,
                   condition_cm=None):
        z1, z2 = split_feature(x, "split")
        shift, log_scale = split_feature(self._net(z1, condition, ddi, condition_cm),
                                         "cross")
        s = clamp(log_scale, self.clamp_type, self.scale, self.scale_shift)
        # z2 and shift are strided views ('split' and 'cross' halves); the
        # kernel reads them where they lie
        z2, ld = coupling_transform(z2, shift, s, reverse=reverse)
        g = grid()
        return torch.cat([z1, z2], -1), (ld if g is None else g.share(ld, z2))

    def forward(self, x, condition, logdet=None, ddi: bool = False, condition_cm=None):
        y, ld = self._transform(x, condition, False, ddi, condition_cm)
        return y, (logdet + ld if logdet is not None else None)

    def reverse(self, x, condition, condition_cm=None):
        """(x, coupling logdet [B]) of the inverse coupling."""
        return self._transform(x, condition, True, condition_cm=condition_cm)


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

"""Multiscale conditional Glow (NHWC), the counterpart of
``recurrent_flows_tpu.flows.glow``: ``f``/``log_prob`` in the density
direction, ``g``/``sample`` in the sampling direction.

A scale's K GlowSteps run one of three ways, the same in both directions:

* the module path: per step the ``actnorm_invconv`` kernel (forward; a
  plain product in reverse), three cuDNN convs on channel-major maps (the
  scale's condition made channel-major once, ``coupling_condition``) and
  the ``coupling_transform`` kernel;
* ``GlowConfig.coupling_impl == 'fused'``: one ``glowstep`` launch per
  GlowStep;
* ``GlowConfig.chain_impl`` 'all' (both directions) or 'sample' (reverse
  only): one ``glowchain`` launch per scale.

The two kernels take a scale only where :func:`kernel_fits`: the step is
the one they compute (relu, actnorm step norm and coupling norm, LU 1x1;
the JAX gates' conditions, and the coupling norm because the kernels'
parameters fold its actnorm), H·W <= 256, and the launch plan has room for
the shape (``ops.glowstep.plan_exists``). Any other scale takes the module
path, decided from shapes and configuration before any launch, as the JAX
gates send their kernel's misfits there.

The kernels return only the coupling's Σ s; the actnorm and 1x1 terms of
the log-determinant are ``static_ld_px·H·W``, added here from the
parameters, so their gradients reach ``logs`` and ``log_s`` by autograd.
The data-dependent-init pass (``ddi=True``) always takes the module path.
With ``flow_norm='batchnorm'`` the step norm is a ``BatchNormFlow``:
``training`` (forward) picks the batch's statistics or the running ones.

On a (data x model) grid (``parallel.mesh``) the module path runs on this
rank's rows. A scale that takes either kernel gathers its rows and its
condition's first, asks ``kernel_fits`` with the whole frame (so every
rank picks the plan of the one-process step), runs the kernel on the whole
frame, then keeps its own rows and its share of the log-determinant, as
GSPMD does around a custom call it cannot partition.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..config import GlowConfig, check_glow_supported
from ..nn.layers import act
from ..ops.glowchain import glowchain
from ..ops.glowstep import GlowStepParams, glowstep, plan_exists
from ..parallel.mesh import grid, own_rows
from ..utils.numerics import (batch_reduce, normal_log_prob, split_feature,
                              squeeze2d, unsqueeze2d)
from ..utils.profiling import span
from .modules import (ActNorm, AffineCoupling, BatchNormFlow, Conv2dNorm, Conv2dZeros,
                      InvConv, Split2d, to_channel_major)

CHAIN_MAX_HW = 256


def kernel_fits(cfg: GlowConfig, b: int, h: int, w: int, c: int, cc: int) -> bool:
    """The ``glowstep``/``glowchain`` kernels compute the GlowSteps of x
    [b, h, w, c] with cc condition channels under ``cfg``."""
    return (cfg.non_lin == "relu"  # the kernels' activation
            and cfg.flow_norm == "actnorm"
            and cfg.lu_decomposed
            and cfg.coupling_norm == "actnorm"
            and h * w <= CHAIN_MAX_HW
            and plan_exists(b, h, w, c, cc, cfg.n_units_affine))


def prep_glowstep_params(step: "GlowStep", reverse: bool):
    """Kernel-ready ``GlowStepParams`` of one GlowStep: the LU-assembled
    1x1 (inverted by triangular solves for the reverse direction), the
    Conv2dZeros e^{3·logs} gain folded into the last conv, and the 'cross'
    split pre-permuted (shift channels first); every leaf contiguous, as the
    kernels take them, and differentiable. Returns (params,
    static_logdet_per_px = Σ actnorm logs + Σ 1x1 log_s)."""
    aff = step.affine
    c = step.channels
    e3 = torch.exp(3.0 * aff.net2.logs)
    dev = e3.device
    perm = torch.cat([torch.arange(0, c, 2, device=dev),
                      torch.arange(1, c, 2, device=dev)])
    wc = (aff.net2.conv.kernel * e3[:, None, None, None])[perm]
    if aff.clamp_type == "realnvp":
        cl_scale, cl_shift = aff.scale, aff.scale_shift
    else:
        cl_scale = cl_shift = torch.zeros(c // 2, device=dev)
    params = GlowStepParams(
        an_bias=step.norm.bias,
        an_logs=step.norm.logs,
        w1x1=step.invconv.matrix(reverse).T.contiguous(),
        # OIHW -> HWIO -> [9, Cin, Cout]
        wa=aff.net0.conv.kernel.permute(2, 3, 1, 0).reshape(9, -1, step.hidden).contiguous(),
        ana_bias=aff.net0.actnorm.bias,
        ana_logs=aff.net0.actnorm.logs,
        wb=aff.net1.conv.kernel[:, :, 0, 0].T.contiguous(),
        anb_bias=aff.net1.actnorm.bias,
        anb_logs=aff.net1.actnorm.logs,
        wc=wc.permute(2, 3, 1, 0).reshape(9, step.hidden, c).contiguous(),
        bias_c=(aff.net2.conv.bias * e3)[perm],
        clamp_scale=cl_scale,
        clamp_shift=cl_shift,
    )
    static_ld_px = step.norm.logs.sum() + step.invconv.log_s.sum()
    return params, static_ld_px


class GlowStep(nn.Module):
    """norm -> invertible 1x1 conv -> conditional affine coupling. The norm
    is an ``ActNorm`` (folded into the 1x1 outside DDI) or, with
    ``flow_norm='batchnorm'``, a ``BatchNormFlow`` over ``spatial_shape``
    (H, W, C)."""

    def __init__(self, channels: int, cond_channels: int, cfg: GlowConfig,
                 spatial_shape=None, *, device=None, generator=None):
        super().__init__()
        self.channels, self.hidden = channels, cfg.n_units_affine
        self.cfg = cfg
        if cfg.flow_norm == "batchnorm":
            self.norm = BatchNormFlow(spatial_shape, cfg.batchnorm_momentum,
                                      device=device)
        else:
            self.norm = ActNorm(channels, device=device)
        self.invconv = InvConv(channels, cfg.lu_decomposed, device=device,
                               generator=generator)
        self.affine = AffineCoupling(channels, cond_channels, cfg.n_units_affine,
                                     cfg.non_lin, cfg.clamp_type, cfg.coupling_norm,
                                     device=device, generator=generator)

    def fused_eligible(self, x, condition) -> bool:
        """This step runs through the ``glowstep`` kernel on ``x`` (on a
        grid, on the whole frame of which x holds rows)."""
        g = grid()
        shape = x.shape if g is None else g.global_shape(x)
        return (self.cfg.coupling_impl == "fused"
                and kernel_fits(self.cfg, *shape, condition.shape[-1]))

    def _fused(self, x, condition, reverse: bool):
        """(y, this step's whole logdet [B]) through the glowstep kernel; on
        a grid, of the gathered frame: own rows and this rank's share."""
        g = grid()
        if g is not None:
            x, condition = g.gather(x), g.gather(condition)
        params, static_ld_px = prep_glowstep_params(self, reverse)
        y, dyn_ld = glowstep(x.contiguous(), condition.contiguous(), params,
                             self.cfg.clamp_type, reverse)
        ld = dyn_ld + static_ld_px * (x.shape[1] * x.shape[2])
        return (y, ld) if g is None else (g.reshard(y), g.share(ld, y))

    def forward(self, x, condition, logdet=None, ddi: bool = False,
                training: bool = True, condition_cm=None):
        """``condition_cm``: ``condition`` channel-major, for the coupling
        net (``ListGlow.coupling_condition``), or None."""
        if not ddi and self.fused_eligible(x, condition):
            y, ld = self._fused(x, condition, False)
            return y, (logdet + ld if logdet is not None else None)
        if self.cfg.flow_norm == "batchnorm":
            x, logdet = self.norm(x, logdet, training)
            x, logdet = self.invconv(x, logdet)
        elif ddi:
            x, logdet = self.norm(x, logdet, ddi=True)
            x, logdet = self.invconv(x, logdet)
        else:
            x, logdet = self.invconv(x, logdet, self.norm.bias, self.norm.logs)
        return self.affine(x, condition, logdet, ddi, condition_cm)

    def reverse(self, x, condition, condition_cm=None):
        if self.fused_eligible(x, condition):
            return self._fused(x, condition, True)[0]
        x, _ = self.affine.reverse(x, condition, condition_cm)
        if self.cfg.flow_norm == "batchnorm":
            return self.norm.reverse(self.invconv.reverse(x))
        return self.invconv.reverse(x, self.norm.bias, self.norm.logs)


class ListGlow(nn.Module):
    """Multiscale conditional Glow with a learned conditional base prior:
    L x [squeeze -> K x GlowStep -> conditional Split2d].

    ``cond_channels[l]`` is the channel count of scale l's condition and
    ``base_channels`` that of the base prior's condition.
    """

    def __init__(self, in_channels: int, image_size: int, cfg: GlowConfig,
                 cond_channels: Sequence[int], base_channels: int,
                 *, device=None, generator=None):
        super().__init__()
        check_glow_supported(cfg)
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        c, hw = in_channels, image_size
        self.scale_hw, self.scale_shapes = [], []
        for l in range(cfg.L):
            c, hw = c * 4, hw // 2
            self.scale_hw.append(hw)
            self.scale_shapes.append((hw, c, cond_channels[l]))
            for k in range(cfg.K):
                self.add_module(f"scale{l}_step{k}",
                                GlowStep(c, cond_channels[l], cfg, (hw, hw, c), **kw))
            if l < cfg.L - 1:
                self.add_module(f"split{l}", Split2d(
                    c, cond_channels[l], cfg.make_conditional,
                    cfg.split2d_act, **kw))
                c //= 2
        self.final_channels, self.final_hw = c, hw
        if cfg.learn_prior:
            up = cfg.n_units_prior
            self.prior0 = Conv2dNorm(base_channels, up, 3, cfg.base_norm, **kw)
            self.prior1 = Conv2dNorm(up, up // 2, 3, cfg.base_norm, **kw)
            self.prior_out = Conv2dZeros(up // 2, 2 * c, device=device)

    def step(self, l: int, k: int) -> GlowStep:
        return getattr(self, f"scale{l}_step{k}")

    # -- base prior -------------------------------------------------------

    def base_params(self, base_condition, batch: int, ddi: bool = False):
        """(mean, log_scale) of the base distribution p(z | base_condition)."""
        if self.cfg.learn_prior:
            h = act(self.prior0(base_condition, ddi), self.cfg.non_lin)
            h = act(self.prior1(h, ddi), self.cfg.non_lin)
            return split_feature(self.prior_out(h), "split")
        shape = (batch, self.final_hw, self.final_hw, self.final_channels)
        zeros = own_rows(torch.zeros(shape, device=base_condition.device))
        return zeros, zeros

    # -- the glowchain kernel ---------------------------------------------

    def chain_eligible(self, l: int, batch: int, reverse: bool = True) -> bool:
        """Scale ``l`` runs through the glowchain kernel in this direction
        on a batch of ``batch``."""
        mode = self.cfg.chain_impl
        hw, c, cc = self.scale_shapes[l]
        return ((mode == "all" or (mode == "sample" and reverse))
                and kernel_fits(self.cfg, batch, hw, hw, c, cc))

    def chain_params(self, l: int, reverse: bool):
        """Scale ``l``'s kernel params stacked [K, ...] in execution order
        (K-1 .. 0 in reverse), differentiable down to the module's
        parameters, and the K steps' summed static logdet per pixel."""
        order = reversed(range(self.cfg.K)) if reverse else range(self.cfg.K)
        preps = [prep_glowstep_params(self.step(l, k), reverse) for k in order]
        params = GlowStepParams(*(torch.stack(leaves).contiguous()
                                  for leaves in zip(*(p for p, _ in preps))))
        return params, sum(s for _, s in preps)

    @torch.no_grad()
    def prepare_chain(self, batch: int) -> dict:
        """Stacked reverse-direction kernel params of every scale that is
        chain-eligible on a batch of ``batch``: {l: GlowStepParams}.
        Computed once per call of ``g``'s caller, not once per frame."""
        return {l: self.chain_params(l, reverse=True)[0]
                for l in range(self.cfg.L) if self.chain_eligible(l, batch)}

    def coupling_condition(self, l: int, x, condition, ddi: bool = False):
        """Scale ``l``'s ``condition`` as its coupling nets take it,
        channel-major, made once for the K steps on the module path; None
        where they take no such copy: on a grid (the nets run NHWC there),
        or where the steps go through the ``glowstep`` kernel."""
        if grid() is not None or (not ddi and self.step(l, 0).fused_eligible(x, condition)):
            return None
        return to_channel_major(condition)

    # -- bijection --------------------------------------------------------

    def f(self, x, conditions: Sequence, logdet, ddi: bool = False,
          training: bool = True):
        """x -> z with the log-determinant and the splits' log-likelihoods
        added to ``logdet`` [B]."""
        cfg = self.cfg
        z = x
        for l in range(cfg.L):
            with span("glow.f.l", l):
                z = squeeze2d(z)
                if not ddi and self.chain_eligible(l, z.shape[0], reverse=False):
                    params, static_ld_px = self.chain_params(l, reverse=False)
                    g, cond = grid(), conditions[l]
                    if g is not None:  # the whole frame (module docstring)
                        z, cond = g.gather(z), g.gather(cond)
                    z, dyn_ld = glowchain(z.contiguous(), cond.contiguous(),
                                          params, cfg.clamp_type, False)
                    ld = dyn_ld + static_ld_px * (z.shape[1] * z.shape[2])
                    if g is not None:
                        z, ld = g.reshard(z), g.share(ld, z)
                    logdet = logdet + ld
                else:
                    cond = conditions[l]
                    cond_cm = self.coupling_condition(l, z, cond, ddi)
                    for k in range(cfg.K):
                        z, logdet = self.step(l, k)(z, cond, logdet, ddi, training, cond_cm)
                if l < cfg.L - 1:
                    z, logdet = getattr(self, f"split{l}")(z, conditions[l],
                                                           logdet, ddi)
        return z, logdet

    def g(self, z, conditions: Sequence, noise, temperature: float = 1.0,
          chain: dict | None = None, training: bool = True):
        """z -> x. ``noise`` draws the split eps, scale L-2 first. The
        reverse of a ``BatchNormFlow`` always uses its running statistics,
        so ``training`` (kept for the JAX signature) changes nothing."""
        cfg = self.cfg
        if chain is None:
            chain = self.prepare_chain(z.shape[0])
        x = z
        for l in reversed(range(cfg.L)):
            with span("glow.g.l", l):
                if l < cfg.L - 1:
                    x = getattr(self, f"split{l}").reverse(
                        x, conditions[l], noise, temperature)
                if l in chain:
                    x, _ = glowchain(x.contiguous(), conditions[l].contiguous(),
                                     chain[l], cfg.clamp_type, True)
                else:
                    cond_cm = self.coupling_condition(l, x, conditions[l])
                    for k in reversed(range(cfg.K)):
                        x = self.step(l, k).reverse(x, conditions[l], cond_cm)
                x = unsqueeze2d(x)
        return x

    # -- densities --------------------------------------------------------

    def log_prob(self, x, conditions, base_condition, noise=None,
                 logdet: float = 0.0, ddi: bool = False,
                 dequantize: bool = True, training: bool = True):
        """(z, nll [B]). With ``dequantize``, ``noise`` draws the uniform
        dequantization noise in [0, 1/n_bins); the -log(n_bins)·D
        correction is always applied."""
        with span("glow.log_prob"):
            b = x.shape[0]
            n_bins = 2.0 ** self.cfg.n_bits
            dims = x.shape[1] * x.shape[2] * x.shape[3]
            if dequantize:
                x = x + noise.uniform(x, 0.0, 1.0 / n_bins)
            const = logdet - math.log(n_bins) * dims
            g = grid()
            obj = torch.full((b,), const if g is None else g.share(const, x),
                             dtype=x.dtype, device=x.device)
            z, obj = self.f(x, conditions, obj, ddi, training)
            mean, log_scale = self.base_params(base_condition, b, ddi)
            obj = obj + batch_reduce(normal_log_prob(z, mean, torch.exp(log_scale)))
            return z, -obj

    def sample(self, conditions, base_condition, noise,
               temperature: float = 0.8, chain: dict | None = None,
               training: bool = True, z=None, eval_params: bool = False):
        """Draw x: z from the base prior at ``temperature`` (the base eps
        first), then ``g`` (the split eps). With ``z`` given, ``g`` maps it
        and no base eps is drawn (the JAX package splits a key for it and
        never uses it). With ``eval_params`` returns (x, (mean, std)) of the
        base distribution."""
        with span("glow.sample"):
            if z is None or eval_params:
                mean, log_scale = self.base_params(base_condition,
                                                   base_condition.shape[0])
            if z is None:
                z = mean + torch.exp(log_scale) * temperature * noise.normal(mean)
            x = self.g(z, conditions, noise, temperature, chain, training)
            if eval_params:
                return x, (mean, torch.exp(log_scale))
        return x

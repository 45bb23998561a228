"""Multiscale conditional Glow (NHWC), the counterpart of
``recurrent_flows_tpu.flows.glow``: ``f``/``log_prob`` in the density
direction, ``g``/``sample`` in the sampling direction.

A scale's K GlowSteps run one of three ways, the same in both directions:

* the module path: per step the ``actnorm_invconv`` kernel (forward; a
  plain product in reverse), three cuDNN convs and the
  ``coupling_transform`` kernel;
* ``GlowConfig.coupling_impl == 'fused'``: one ``glowstep`` launch per
  GlowStep where H·W <= 256;
* ``GlowConfig.chain_impl`` 'all' (both directions) or 'sample' (reverse
  only): one ``glowchain`` launch per scale where H·W <= 256.

The kernels return only the coupling's Σ s; the actnorm and 1x1 terms of
the log-determinant are ``static_ld_px·H·W``, added here from the
parameters, so their gradients reach ``logs`` and ``log_s`` by autograd.
The data-dependent-init pass (``ddi=True``) always takes the module path.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..config import GlowConfig, check_glow_supported
from ..nn.layers import act
from ..ops.glowchain import glowchain
from ..ops.glowstep import GlowStepParams, glowstep
from ..utils.numerics import (batch_reduce, normal_log_prob, split_feature,
                              squeeze2d, unsqueeze2d)
from .modules import ActNorm, AffineCoupling, Conv2dNorm, Conv2dZeros, InvConv, Split2d

CHAIN_MAX_HW = 256


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
        w1x1=step.invconv.weight(reverse).T.contiguous(),
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
    """norm -> invertible 1x1 conv -> conditional affine coupling."""

    def __init__(self, channels: int, cond_channels: int, cfg: GlowConfig,
                 *, device=None, generator=None):
        super().__init__()
        self.channels, self.hidden = channels, cfg.n_units_affine
        self.cfg = cfg
        self.norm = ActNorm(channels, device=device)
        self.invconv = InvConv(channels, device=device, generator=generator)
        self.affine = AffineCoupling(channels, cond_channels, cfg.n_units_affine,
                                     cfg.non_lin, cfg.clamp_type,
                                     device=device, generator=generator)

    def fused_eligible(self, x) -> bool:
        """This step runs through the ``glowstep`` kernel on ``x``."""
        return (self.cfg.coupling_impl == "fused"
                and self.cfg.non_lin == "relu"  # the kernel's activation
                and x.shape[1] * x.shape[2] <= CHAIN_MAX_HW)

    def _fused(self, x, condition, reverse: bool):
        """(y, this step's whole logdet [B]) through the glowstep kernel."""
        params, static_ld_px = prep_glowstep_params(self, reverse)
        y, dyn_ld = glowstep(x.contiguous(), condition.contiguous(), params,
                             self.cfg.clamp_type, reverse)
        return y, dyn_ld + static_ld_px * (x.shape[1] * x.shape[2])

    def forward(self, x, condition, logdet=None, ddi: bool = False):
        if not ddi and self.fused_eligible(x):
            y, ld = self._fused(x, condition, False)
            return y, (logdet + ld if logdet is not None else None)
        if ddi:
            x, logdet = self.norm(x, logdet, ddi=True)
            x, logdet = self.invconv(x, logdet)
        else:
            x, logdet = self.invconv(x, logdet, self.norm.bias, self.norm.logs)
        return self.affine(x, condition, logdet, ddi)

    def reverse(self, x, condition):
        if self.fused_eligible(x):
            return self._fused(x, condition, True)[0]
        x, _ = self.affine.reverse(x, condition)
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
        self.scale_hw = []
        for l in range(cfg.L):
            c, hw = c * 4, hw // 2
            self.scale_hw.append(hw)
            for k in range(cfg.K):
                self.add_module(f"scale{l}_step{k}",
                                GlowStep(c, cond_channels[l], cfg, **kw))
            if l < cfg.L - 1:
                self.add_module(f"split{l}", Split2d(
                    c, cond_channels[l], cfg.make_conditional,
                    cfg.split2d_act, **kw))
                c //= 2
        self.final_channels, self.final_hw = c, hw
        if cfg.learn_prior:
            up = cfg.n_units_prior
            self.prior0 = Conv2dNorm(base_channels, up, 3, **kw)
            self.prior1 = Conv2dNorm(up, up // 2, 3, **kw)
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
        zeros = torch.zeros(shape, device=base_condition.device)
        return zeros, zeros

    # -- the glowchain kernel ---------------------------------------------

    def chain_eligible(self, l: int, reverse: bool = True) -> bool:
        """Scale ``l`` runs through the glowchain kernel in this direction."""
        mode = self.cfg.chain_impl
        return ((mode == "all" or (mode == "sample" and reverse))
                and self.cfg.non_lin == "relu"
                and self.scale_hw[l] ** 2 <= CHAIN_MAX_HW)

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
    def prepare_chain(self) -> dict:
        """Stacked reverse-direction kernel params of every chain-eligible
        scale: {l: GlowStepParams}. Computed once per call of ``g``'s
        caller, not once per frame."""
        return {l: self.chain_params(l, reverse=True)[0]
                for l in range(self.cfg.L) if self.chain_eligible(l)}

    # -- bijection --------------------------------------------------------

    def f(self, x, conditions: Sequence, logdet, ddi: bool = False):
        """x -> z with the log-determinant and the splits' log-likelihoods
        added to ``logdet`` [B]."""
        cfg = self.cfg
        z = x
        for l in range(cfg.L):
            z = squeeze2d(z)
            if not ddi and self.chain_eligible(l, reverse=False):
                params, static_ld_px = self.chain_params(l, reverse=False)
                z, dyn_ld = glowchain(z.contiguous(), conditions[l].contiguous(),
                                      params, cfg.clamp_type, False)
                logdet = logdet + dyn_ld + static_ld_px * (z.shape[1] * z.shape[2])
            else:
                for k in range(cfg.K):
                    z, logdet = self.step(l, k)(z, conditions[l], logdet, ddi)
            if l < cfg.L - 1:
                z, logdet = getattr(self, f"split{l}")(z, conditions[l],
                                                       logdet, ddi)
        return z, logdet

    def g(self, z, conditions: Sequence, noise, temperature: float = 1.0,
          chain: dict | None = None):
        """z -> x. ``noise`` draws the split eps, scale L-2 first."""
        cfg = self.cfg
        if chain is None:
            chain = self.prepare_chain()
        x = z
        for l in reversed(range(cfg.L)):
            if l < cfg.L - 1:
                x = getattr(self, f"split{l}").reverse(
                    x, conditions[l], noise, temperature)
            if l in chain:
                x, _ = glowchain(x.contiguous(), conditions[l].contiguous(),
                                 chain[l], cfg.clamp_type, True)
            else:
                for k in reversed(range(cfg.K)):
                    x = self.step(l, k).reverse(x, conditions[l])
            x = unsqueeze2d(x)
        return x

    # -- densities --------------------------------------------------------

    def log_prob(self, x, conditions, base_condition, noise=None,
                 logdet: float = 0.0, ddi: bool = False,
                 dequantize: bool = True):
        """(z, nll [B]). With ``dequantize``, ``noise`` draws the uniform
        dequantization noise in [0, 1/n_bins); the -log(n_bins)·D
        correction is always applied."""
        b = x.shape[0]
        n_bins = 2.0 ** self.cfg.n_bits
        dims = x.shape[1] * x.shape[2] * x.shape[3]
        if dequantize:
            x = x + noise.uniform(x, 0.0, 1.0 / n_bins)
        obj = torch.full((b,), logdet - math.log(n_bins) * dims,
                         dtype=torch.float32, device=x.device)
        z, obj = self.f(x, conditions, obj, ddi)
        mean, log_scale = self.base_params(base_condition, b, ddi)
        obj = obj + batch_reduce(normal_log_prob(z, mean, torch.exp(log_scale)))
        return z, -obj

    def sample(self, conditions, base_condition, noise,
               temperature: float = 0.8, chain: dict | None = None):
        """Draw x: z from the base prior at ``temperature``, then ``g``.
        Draws the base eps first, then the split eps."""
        mean, log_scale = self.base_params(base_condition,
                                           base_condition.shape[0])
        z = mean + torch.exp(log_scale) * temperature * noise.normal(mean)
        return self.g(z, conditions, noise, temperature, chain)

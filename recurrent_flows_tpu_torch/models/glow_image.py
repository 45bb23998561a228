"""Standalone image-density Glow models, the counterparts of
``recurrent_flows_tpu.models.glow_image``: the port's ``ListGlow`` driven by
other conditions than RFN's.

* ``GlowImage``: unconditional Glow, learned constant conditions per scale
  (``cond_{l}`` [1, H/2^(l+1), W/2^(l+1), cond_channels]) and for the base
  prior (``base``), broadcast over the batch (autograd sums their gradient
  over it, as JAX's ``broadcast_to`` does). Video batches [B, T, H, W, C]
  are taken as B·T i.i.d. frames (BASELINE config 3, Glow on SM-MNIST).
* ``ConditionalGlowImage`` (cGlow, the boxed-CelebA workload): p(x |
  context); per scale a stride-2 3x3 conv with a bias (``enc{l}``), a
  ``NormLayer`` (``encn{l}``) and relu make the condition from the
  previous one, the context image first; the last is the base condition.

Both run the flow's kernels wherever ``ListGlow`` takes them: the module
path's ``actnorm_invconv`` and ``coupling_transform``, ``glowchain`` on the
scales ``flows.glow.kernel_fits`` admits (``chain_impl``). Every condition
reaching the flow is contiguous. Each model has ``cfg`` (its
``GlowConfig``), so that ``Trainer.checkpoint`` writes the JAX meta
(``model_class`` and ``model_config``). Parameters keep the flax names
(``flow``, ``cond_{l}``, ``base``, ``enc{l}``, ``encn{l}``), so
``convert.from_flax`` loads a JAX tree as it is.

Draws come from a ``NoiseSource``, in the JAX package's order: ``loss``,
``log_prob`` and ``ddi`` the dequantization uniform; ``sample`` the base
eps, then one eps per split, scale L-2 first.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import GlowConfig, check_supported
from ..flows.glow import ListGlow
from ..nn.layers import Conv2d, NormLayer, act
from ..utils.numerics import NoiseSource


def _frames(x):
    """[B, T, H, W, C] -> [B·T, H, W, C]; a frame batch as it is."""
    return x.reshape((-1,) + tuple(x.shape[2:])) if x.dim() == 5 else x


class GlowImage(nn.Module):
    """Unconditional Glow on [B, H, W, C] images of ``image_size``, on
    ``device`` (the card unless the caller asks for the CPU), its
    parameters drawn from ``generator`` (a CPU generator seeded 0 when
    None)."""

    def __init__(self, in_channels: int, image_size: int, cfg: GlowConfig,
                 cond_channels: int = 8, base_channels: int = 8, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.flow = ListGlow(in_channels, image_size, cfg, [cond_channels] * cfg.L,
                             base_channels, device=device, generator=generator)
        hw = image_size
        for l in range(cfg.L):
            hw //= 2
            self.register_parameter(f"cond_{l}", nn.Parameter(
                torch.zeros((1, hw, hw, cond_channels), device=device)))
        self.base = nn.Parameter(torch.zeros((1, hw, hw, base_channels), device=device))

    def _broadcast(self, batch: int):
        conds = [getattr(self, f"cond_{l}").expand(batch, -1, -1, -1).contiguous()
                 for l in range(self.cfg.L)]
        return conds, self.base.expand(batch, -1, -1, -1).contiguous()

    def forward(self, x, noise: NoiseSource):
        """nll [B·T or B] of the frames of x (model space)."""
        x = _frames(x)
        conds, base = self._broadcast(x.shape[0])
        return self.flow.log_prob(x, conds, base, noise)[1]

    def ddi(self, x, noise: NoiseSource):
        """The data-dependent-init pass (``flows.ddi``): every ActNorm takes
        its statistics on the frames of x; returns the nll."""
        x = _frames(x)
        conds, base = self._broadcast(x.shape[0])
        return self.flow.log_prob(x, conds, base, noise, ddi=True)[1]

    def loss(self, x, noise: NoiseSource) -> dict:
        """The trainer's contract: {kl_free_bits: 0, kl: 0, nll: the mean
        nll over the frames}."""
        zero = torch.zeros((), device=x.device)
        return dict(kl_free_bits=zero, kl=zero, nll=self(x, noise).mean())

    def sample(self, n: int, noise: NoiseSource, temperature: float = 0.8):
        """n images [n, H, W, C] at ``temperature``."""
        conds, base = self._broadcast(n)
        return self.flow.sample(conds, base, noise, temperature)


class ConditionalGlowImage(nn.Module):
    """cGlow: p(x | context) on [B, H, W, C] images of ``image_size``; the
    context has x's shape."""

    def __init__(self, in_channels: int, image_size: int, cfg: GlowConfig,
                 cond_channels: int = 32, norm_type: str = "none", *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        self.flow = ListGlow(in_channels, image_size, cfg, [cond_channels] * cfg.L,
                             cond_channels, **kw)
        c = in_channels
        for l in range(cfg.L):
            self.add_module(f"enc{l}", Conv2d(c, cond_channels, 3, 2, **kw))
            self.add_module(f"encn{l}", NormLayer(norm_type, cond_channels, device=device))
            c = cond_channels

    def _conditions(self, context):
        """The context pyramid, one stride-2 conv per flow scale; the last
        is also the base condition."""
        conds, h = [], context
        for l in range(self.cfg.L):
            h = act(getattr(self, f"encn{l}")(getattr(self, f"enc{l}")(h)), "relu")
            conds.append(h.contiguous())
        return conds, conds[-1]

    def forward(self, x, context, noise: NoiseSource):
        conds, base = self._conditions(context)
        return self.flow.log_prob(x, conds, base, noise)[1]

    def log_prob(self, x, context, noise: NoiseSource):
        """nll [B] of x given context (model space)."""
        return self(x, context, noise)

    def ddi(self, x, context, noise: NoiseSource):
        """The data-dependent-init pass; returns the nll."""
        conds, base = self._conditions(context)
        return self.flow.log_prob(x, conds, base, noise, ddi=True)[1]

    def sample(self, context, noise: NoiseSource, temperature: float = 0.8):
        """One image per context [B, H, W, C] at ``temperature``."""
        conds, base = self._conditions(context)
        return self.flow.sample(conds, base, noise, temperature)

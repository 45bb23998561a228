"""Low-dimensional flows, the counterparts of
``recurrent_flows_tpu.flows.realnvp2d``: masked affine couplings with exact
inverses on 2-D data (RealNVP), a context-conditioned variant (rotating
two-moons), and 1-D mixture-CDF flows composed autoregressively.

Parameters keep the flax names (``cpl{i}.fc0``/``fc1``/``out``;
``logits``/``means``/``log_scales``; ``f1`` and ``net.layers_0``/``net.layers_2``,
the names flax's ``nn.Sequential`` gives its Dense layers), so
``convert.from_flax`` loads a JAX tree as it is. A sample's base eps comes
from a ``NoiseSource``, in the JAX package's one draw.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..nn.layers import Dense
from ..utils.numerics import NoiseSource

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _std_normal_logprob(z):
    return torch.sum(-0.5 * z ** 2 - _LOG_SQRT_2PI, dim=-1)


class MaskedAffineCoupling(nn.Module):
    """y = mask·x + (1-mask)·(x·e^s + t), (s, t) = MLP(mask·x [, context]),
    s through tanh; the last Dense starts at zero (the identity)."""

    def __init__(self, dim: int, mask: Sequence[float], hidden: int = 64,
                 context_dim: int = 0, *, device="cuda", generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dim, self.context_dim = dim, context_dim
        self.register_buffer("mask", torch.tensor(mask, dtype=torch.float32, device=device),
                             persistent=False)
        self.fc0 = Dense(dim + context_dim, hidden, **kw)
        self.fc1 = Dense(hidden, hidden, **kw)
        self.out = Dense(hidden, 2 * dim, **kw)
        with torch.no_grad():
            self.out.kernel.zero_()

    def forward(self, x, context=None, reverse: bool = False):
        """(y, logdet [B]); in reverse the inverse and -logdet."""
        h = x * self.mask
        if self.context_dim:
            h = torch.cat([h, context], -1)
        h = torch.tanh(self.fc1(torch.tanh(self.fc0(h))))
        s, t = torch.chunk(self.out(h), 2, -1)
        s = torch.tanh(s) * (1 - self.mask)
        t = t * (1 - self.mask)
        if not reverse:
            return x * torch.exp(s) + t, s.sum(-1)
        return (x - t) * torch.exp(-s), -s.sum(-1)


class RealNVP2D(nn.Module):
    """``n_couplings`` couplings with alternating masks (coupling i keeps
    the dimensions j with (j + i) even), a standard-normal base;
    ``context_dim`` > 0 makes it the conditional RealNVP."""

    def __init__(self, dim: int = 2, n_couplings: int = 6, hidden: int = 64,
                 context_dim: int = 0, *, device="cuda", generator=None):
        super().__init__()
        self.dim = dim
        self.n_couplings = n_couplings
        for i in range(n_couplings):
            mask = [1.0 if (j + i) % 2 == 0 else 0.0 for j in range(dim)]
            self.add_module(f"cpl{i}", MaskedAffineCoupling(
                dim, mask, hidden, context_dim, device=device, generator=generator))

    def _couplings(self):
        return [getattr(self, f"cpl{i}") for i in range(self.n_couplings)]

    def f(self, x, context=None):
        """x -> (z, logdet [B])."""
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for c in self._couplings():
            x, ld = c(x, context)
            logdet = logdet + ld
        return x, logdet

    def g(self, z, context=None):
        for c in reversed(self._couplings()):
            z, _ = c(z, context, reverse=True)
        return z

    def log_prob(self, x, context=None):
        z, logdet = self.f(x, context)
        return _std_normal_logprob(z) + logdet

    def sample(self, n: int, noise: NoiseSource, context=None):
        """n draws: z ~ N(0, I) [n, dim] from ``noise``, then ``g``."""
        device = self.cpl0.mask.device
        z = noise.normal(torch.empty((n, self.dim), device=device))
        return self.g(z, context)

    def forward(self, x, context=None):
        return self.log_prob(x, context)


def _mixture_logpdf(v, log_w, means, log_scales):
    zs = (v[..., None] - means) / torch.exp(log_scales)
    comp = -0.5 * zs ** 2 - log_scales - _LOG_SQRT_2PI
    return torch.logsumexp(log_w + comp, -1)


class MixtureCDFFlow(nn.Module):
    """1-D monotone flow x -> the CDF of a K-gaussian mixture (each
    component's CDF approximated by sigmoid(1.702·z)); the log-determinant
    is the mixture's exact log-pdf. Reverse: 60 bisection steps on [-30,
    30], as the JAX package does."""

    def __init__(self, n_components: int = 5, *, device="cuda"):
        super().__init__()
        k = n_components
        self.logits = nn.Parameter(torch.zeros(k, device=device))
        self.means = nn.Parameter(torch.linspace(-2.0, 2.0, k, device=device))
        self.log_scales = nn.Parameter(torch.zeros(k, device=device))

    def cdf(self, v):
        w = torch.softmax(self.logits, -1)
        zs = (v[..., None] - self.means) / torch.exp(self.log_scales)
        return torch.sum(w * torch.sigmoid(1.702 * zs), -1)

    def forward(self, x, reverse: bool = False):
        """(cdf(x), log pdf(x)); in reverse (the inverse CDF of x, None)."""
        if not reverse:
            log_w = torch.log(torch.softmax(self.logits, -1))
            return self.cdf(x), _mixture_logpdf(x, log_w, self.means, self.log_scales)
        lo, hi = torch.full_like(x, -30.0), torch.full_like(x, 30.0)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            too_low = self.cdf(mid) < x
            lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
        return 0.5 * (lo + hi), None


class _Net(nn.Module):
    """flax's ``nn.Sequential([Dense, tanh, Dense])``: ``layers_0``, tanh,
    ``layers_2``."""

    def __init__(self, hidden: int, out: int, **kw):
        super().__init__()
        self.layers_0 = Dense(1, hidden, **kw)
        self.layers_2 = Dense(hidden, out, **kw)

    def forward(self, x):
        return self.layers_2(torch.tanh(self.layers_0(x)))


class AutoregFlow2D(nn.Module):
    """2-D autoregressive CDF flow: z1 = F1(x1), z2 = F2(x2 | x1), the
    conditional mixture's (logits, means, log scales clipped to [-5, 5])
    from an MLP over x1. ``log_prob`` only, as in the JAX package."""

    def __init__(self, n_components: int = 5, hidden: int = 32, *, device="cuda",
                 generator=None):
        super().__init__()
        self.f1 = MixtureCDFFlow(n_components, device=device)
        self.net = _Net(hidden, 3 * n_components, device=device, generator=generator)

    def log_prob(self, x):
        x1, x2 = x[..., 0], x[..., 1]
        _, lp1 = self.f1(x1)
        logits, means, log_scales = torch.chunk(self.net(x1[..., None]), 3, -1)
        log_scales = torch.clamp(log_scales, -5, 5)
        log_w = torch.log(torch.softmax(logits, -1))
        return lp1 + _mixture_logpdf(x2, log_w, means, log_scales)

    def forward(self, x):
        return self.log_prob(x)

"""Discretized mixture-of-logistics likelihood (PixelCNN++), NHWC, the
counterpart of ``recurrent_flows_tpu.ops.mol``.

Plain PyTorch: the JAX package computes it outside any Pallas kernel.
The CDF-difference log-prob with the +/-0.999 edge cases and the 1/255
half-bin (8-bit data in [-1, 1]), the RGB sub-pixel linear coupling, and
Gumbel-max mixture sampling. A sample draws, through a ``NoiseSource``,
the Gumbel uniform [..., n_mix] and then the logistic uniform [..., C],
both in [1e-5, 1 - 1e-5), as the JAX package draws them from its two
split keys.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_HALF_BIN = 1.0 / 255.0
_LOG_127_5 = math.log(127.5)
_U_LOW, _U_HIGH = 1e-5, 1.0 - 1e-5


def _log_prob_from_logits(x):
    return x - torch.logsumexp(x, -1, keepdim=True)


def _logistic_bin_logprob(x, means, log_scales):
    """Per-(pixel, channel, mixture) discretized logistic log prob."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + _HALF_BIN)
    min_in = inv_stdv * (centered - _HALF_BIN)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)  # edge case x ~ 0
    log_one_minus_cdf_min = -F.softplus(min_in)  # edge case x ~ 255
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    inner_inner = torch.where(cdf_delta > 1e-5,
                              torch.log(torch.clamp(cdf_delta, min=1e-12)),
                              log_pdf_mid - _LOG_127_5)
    inner = torch.where(x > 0.999, log_one_minus_cdf_min, inner_inner)
    return torch.where(x < -0.999, log_cdf_plus, inner)


def _split_rgb(logits):
    n_mix = logits.shape[-1] // 10
    l = logits[..., n_mix:].reshape(logits.shape[:-1] + (3, 3 * n_mix))
    return n_mix, logits[..., :n_mix], l


def _split_1d(logits):
    n_mix = logits.shape[-1] // 3
    l = logits[..., n_mix:].reshape(logits.shape[:-1] + (1, 2 * n_mix))
    return n_mix, logits[..., :n_mix], l


def mol_log_prob_rgb(x, logits):
    """log p(x) per pixel: x [B,H,W,3] in [-1,1], logits [B,H,W,10·n_mix]
    -> [B,H,W]."""
    n_mix, logit_probs, l = _split_rgb(logits)
    means = l[..., :n_mix]
    log_scales = torch.clamp(l[..., n_mix:2 * n_mix], min=-7.0)
    coeffs = torch.tanh(l[..., 2 * n_mix:3 * n_mix])
    xe = x[..., None]  # [B,H,W,3,1]
    m2 = means[..., 1, :] + coeffs[..., 0, :] * xe[..., 0, :]
    m3 = (means[..., 2, :] + coeffs[..., 1, :] * xe[..., 0, :]
          + coeffs[..., 2, :] * xe[..., 1, :])
    means = torch.stack([means[..., 0, :], m2, m3], -2)
    lp = _logistic_bin_logprob(xe, means, log_scales)
    log_probs = lp.sum(-2) + _log_prob_from_logits(logit_probs)
    return torch.logsumexp(log_probs, -1)


def mol_log_prob_1d(x, logits):
    """log p(x) per pixel: x [B,H,W,1], logits [B,H,W,3·n_mix] -> [B,H,W]."""
    n_mix, logit_probs, l = _split_1d(logits)
    means = l[..., :n_mix]
    log_scales = torch.clamp(l[..., n_mix:2 * n_mix], min=-7.0)
    lp = _logistic_bin_logprob(x[..., None], means, log_scales)
    log_probs = lp.sum(-2) + _log_prob_from_logits(logit_probs)
    return torch.logsumexp(log_probs, -1)


def _gumbel_select(noise, logit_probs):
    """Gumbel-max mixture indicator -> one-hot [..., n_mix]."""
    u = noise.uniform(logit_probs, _U_LOW, _U_HIGH)
    idx = torch.argmax(logit_probs - torch.log(-torch.log(u)), -1)
    return F.one_hot(idx, logit_probs.shape[-1]).to(logit_probs.dtype)


def _logistic(noise, means, log_scales):
    u = noise.uniform(means, _U_LOW, _U_HIGH)
    return means + torch.exp(log_scales) * (torch.log(u) - torch.log(1.0 - u))


def mol_sample_rgb(noise, logits):
    """Draw x [B,H,W,3] in [-1,1] from the mixture."""
    n_mix, logit_probs, l = _split_rgb(logits)
    sel = _gumbel_select(noise, logit_probs)[..., None, :]  # [B,H,W,1,n_mix]
    means = (l[..., :n_mix] * sel).sum(-1)  # [B,H,W,3]
    log_scales = torch.clamp((l[..., n_mix:2 * n_mix] * sel).sum(-1), min=-7.0)
    coeffs = (torch.tanh(l[..., 2 * n_mix:3 * n_mix]) * sel).sum(-1)
    x = _logistic(noise, means, log_scales)
    x0 = torch.clamp(x[..., 0], -1.0, 1.0)
    x1 = torch.clamp(x[..., 1] + coeffs[..., 0] * x0, -1.0, 1.0)
    x2 = torch.clamp(x[..., 2] + coeffs[..., 1] * x0 + coeffs[..., 2] * x1, -1.0, 1.0)
    return torch.stack([x0, x1, x2], -1)


def mol_sample_1d(noise, logits):
    """Draw x [B,H,W,1] in [-1,1] from the 1-channel mixture."""
    n_mix, logit_probs, l = _split_1d(logits)
    sel = _gumbel_select(noise, logit_probs)[..., None, :]
    means = (l[..., :n_mix] * sel).sum(-1)
    log_scales = torch.clamp((l[..., n_mix:2 * n_mix] * sel).sum(-1), min=-7.0)
    return torch.clamp(_logistic(noise, means, log_scales), -1.0, 1.0)


class DiscretizedMixtureLogits:
    """3-channel likelihood facade."""

    def __init__(self, n_mix: int):
        self.n_mix = n_mix

    def log_prob(self, x, logits):
        return mol_log_prob_rgb(x, logits)

    def sample(self, noise, logits):
        return mol_sample_rgb(noise, logits)


class DiscretizedMixtureLogits1d:
    """1-channel likelihood facade."""

    def __init__(self, n_mix: int):
        self.n_mix = n_mix

    def log_prob(self, x, logits):
        return mol_log_prob_1d(x, logits)

    def sample(self, noise, logits):
        return mol_sample_1d(noise, logits)

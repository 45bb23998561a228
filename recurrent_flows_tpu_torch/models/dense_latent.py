"""Shared submodules of SRNN and VRNN (NHWC), the counterparts of
``recurrent_flows_tpu.models.dense_latent``: the frame features ``PhiX``
(stride-2 convs to H/8 x W/8 x 256), the latent lift ``PhiZ`` (vector z ->
spatial map), the conv + MLP Gaussian heads ``ConvMLPGaussian``, the
transposed-conv ``FrameDecoder`` and the ``LikelihoodHead`` with its four
loss types; and ``DenseLatentModel``, what the two models share on top of
them.

Each batch norm normalises over the batch it is given, so a caller must
hand each net the batch the JAX package hands it. On a (data x model) grid
(``parallel.mesh``) the conv nets run on this rank's rows and the
Gaussian heads gather the rows before their dense layers; ``PhiZ``'s map
keeps its own rows from its conv on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv2d, ConvTranspose2d, Dense, NormLayer
from ..ops.mol import DiscretizedMixtureLogits, DiscretizedMixtureLogits1d
from ..parallel.mesh import grid
from ..utils.numerics import NoiseSource, batch_reduce, normal_log_prob, normal_sample


def _half(n: int) -> int:
    """The extent of a 3x3 stride-2 conv with padding 1 over n."""
    return (n - 1) // 2 + 1


FEAT = 256  # PhiX's channels
ZMAP = 128  # PhiZ's channels


class PhiX(nn.Module):
    """Frame features: [B,H,W,C] -> [B,H/8,W/8,256]; convs ``conv0`` ..
    ``conv3`` (strides 2, 2, 2, 1), each with its ``norm{j}`` and a relu."""

    def __init__(self, in_channels: int, norm_type: str = "batchnorm",
                 track_running_stats: bool = False, *, device=None, generator=None):
        super().__init__()
        c = in_channels
        for j, (ch, stride) in enumerate([(64, 2), (128, 2), (256, 2), (FEAT, 1)]):
            self.add_module(f"conv{j}", Conv2d(c, ch, 3, stride, device=device,
                                               generator=generator))
            self.add_module(f"norm{j}", NormLayer(norm_type, ch, track_running_stats,
                                                  device=device))
            c = ch

    def forward(self, x, use_running_average: bool = False):
        for j in range(4):
            x = getattr(self, f"conv{j}")(x)
            x = F.relu(getattr(self, f"norm{j}")(x, use_running_average))
        return x


class PhiZ(nn.Module):
    """Latent lift: [B,z] -> [B,h,w,128] (two Dense + relu, a 3x3 conv, its
    norm, relu)."""

    def __init__(self, z_dim: int, h: int, w: int, norm_type: str = "batchnorm",
                 track_running_stats: bool = False, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.shape = (h, w, ZMAP)
        d = ZMAP * h * w
        self.fc0 = Dense(z_dim, d, **kw)
        self.fc1 = Dense(d, d, **kw)
        self.conv = Conv2d(ZMAP, ZMAP, 3, **kw)
        self.norm = NormLayer(norm_type, ZMAP, track_running_stats, device=device)

    def forward(self, z, use_running_average: bool = False):
        z = F.relu(self.fc1(F.relu(self.fc0(z))))
        z = self.conv(z.reshape((z.shape[0],) + self.shape))
        return F.relu(self.norm(z, use_running_average))


class ConvMLPGaussian(nn.Module):
    """Spatial input [B,h,w,in] -> (mean, softplus std) [B,z]: a 3x3 stride-2
    ``trunk_conv`` with ``trunk_norm`` and relu, flattened (h, w, c), then
    two 3-layer MLP heads ``mean_fc*`` and ``std_fc*``."""

    def __init__(self, in_channels: int, hw: int, z_dim: int,
                 norm_type: str = "batchnorm", track_running_stats: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.trunk_conv = Conv2d(in_channels, 256, 3, 2, **kw)
        self.trunk_norm = NormLayer(norm_type, 256, track_running_stats, device=device)
        flat = 256 * _half(hw) ** 2
        for name in ("mean", "std"):
            self.add_module(f"{name}_fc0", Dense(flat, 512, **kw))
            self.add_module(f"{name}_fc1", Dense(512, 256, **kw))
            self.add_module(f"{name}_fc2", Dense(256, z_dim, **kw))

    def _head(self, name, h):
        y = F.relu(getattr(self, f"{name}_fc0")(h))
        y = F.relu(getattr(self, f"{name}_fc1")(y))
        return getattr(self, f"{name}_fc2")(y)

    def forward(self, x, use_running_average: bool = False):
        h = F.relu(self.trunk_norm(self.trunk_conv(x), use_running_average))
        g = grid()
        if g is not None:  # the dense heads take the whole map
            h = g.gather(h)
        h = h.reshape(h.shape[0], -1)
        return self._head("mean", h), F.softplus(self._head("std", h))


_DECODER = [("deconv", 512), ("conv", 256), ("deconv", 64), ("conv", 64), ("deconv", 32)]


class FrameDecoder(nn.Module):
    """[B,h,w,in] -> [B,8h,8w,32]: transposed convs (k=4, s=2, with bias)
    ``deconv0/2/4`` and 3x3 convs ``conv1/3``, each with its ``norm{j}``
    and a relu."""

    def __init__(self, in_channels: int, norm_type: str = "batchnorm",
                 track_running_stats: bool = False, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c = in_channels
        for j, (kind, ch) in enumerate(_DECODER):
            layer = (ConvTranspose2d(c, ch, **kw) if kind == "deconv"
                     else Conv2d(c, ch, 3, **kw))
            self.add_module(f"{kind}{j}", layer)
            self.add_module(f"norm{j}", NormLayer(norm_type, ch, track_running_stats,
                                                  device=device))
            c = ch

    def forward(self, x, use_running_average: bool = False):
        for j, (kind, _) in enumerate(_DECODER):
            x = getattr(self, f"{kind}{j}")(x)
            x = F.relu(getattr(self, f"norm{j}")(x, use_running_average))
        return x


class LikelihoodHead(nn.Module):
    """Decoder features -> the output map (``out_conv``) and the NLL or a
    frame estimate, for the loss types bernoulli, gaussian (learned
    ``variance`` through softplus, optional dequantization), mse and mol
    (a discretized mixture of ``n_logistics`` logistics).

    Draws: ``nll`` takes the dequantization uniform U[0, 1/2^n_bits) of
    x's shape for 'gaussian' with ``dequantize`` and nothing otherwise;
    ``decode`` draws the mixture's two uniforms for 'mol' and nothing
    otherwise (``ops.mol``).
    """

    def __init__(self, in_channels: int, channels: int, loss_type: str = "bernoulli",
                 preprocess_range: str = "1.0", n_logistics: int = 5, n_bits: int = 8,
                 dequantize: bool = True, *, device=None, generator=None):
        super().__init__()
        if loss_type not in ("bernoulli", "gaussian", "mse", "mol"):
            raise ValueError(f"undefined loss {loss_type}")
        self.loss_type = loss_type
        self.preprocess_range, self.n_bits, self.dequantize = (preprocess_range, n_bits,
                                                               dequantize)
        kw = dict(device=device, generator=generator)
        if loss_type == "mol":
            self.out_conv = Conv2d(in_channels, n_logistics * (10 if channels > 1 else 3),
                                   3, **kw)
            self.mol = (DiscretizedMixtureLogits(n_logistics) if channels > 1
                        else DiscretizedMixtureLogits1d(n_logistics))
        else:
            self.out_conv = Conv2d(in_channels, channels, 3, **kw)
            self.variance = nn.Parameter(torch.ones(1, device=device))

    def params_from(self, dec):
        """The raw output map (probabilities, means or mixture logits)."""
        y = self.out_conv(dec)
        if self.loss_type == "mol":
            return y
        if self.preprocess_range == "0.5":
            return torch.tanh(y)
        return torch.sigmoid(y)

    def nll(self, dec, x_t, u=None):
        """Per-sample negative log likelihood [B]; ``u`` is the
        dequantization uniform (``dequantization``) where one is drawn."""
        y = self.params_from(dec)
        if self.loss_type == "bernoulli":
            p = torch.clamp(y, 1e-6, 1 - 1e-6)
            return -batch_reduce(x_t * torch.log(p) + (1 - x_t) * torch.log1p(-p))
        if self.loss_type == "gaussian":
            n_bins = 2.0 ** self.n_bits
            x, corr = x_t, 0.0
            if self.dequantize:
                x = x_t + u
                corr = -math.log(n_bins) * x_t.shape[1] * x_t.shape[2] * x_t.shape[3]
                g = grid()
                corr = corr if g is None else g.share(corr, x_t)
            std = F.softplus(self.variance)
            return -batch_reduce(normal_log_prob(x, y, std * torch.ones_like(y))) - corr
        if self.loss_type == "mse":
            return batch_reduce(torch.square(y - x_t))
        return -batch_reduce(self.mol.log_prob(x_t, y))

    def dequantization(self, noise: NoiseSource, x_t):
        """The uniform ``nll`` takes, drawn from ``noise``, or None."""
        if self.loss_type != "gaussian" or not self.dequantize:
            return None
        return noise.uniform(x_t, 0.0, 1.0 / 2.0 ** self.n_bits)

    def decode(self, dec, noise: NoiseSource):
        """The frame estimate of predict/reconstruct/sample."""
        y = self.params_from(dec)
        if self.loss_type == "mol":
            return self.mol.sample(noise, y)
        return y


class DenseLatentModel(nn.Module):
    """What SRNN and VRNN share: their nets, the nets' calls with
    ``eval_norm``, the batched features, the decoder and the IW-ELBO's
    per-step sum."""

    def _make_nets(self, cfg, enc_in: int, prior_in: int, kw: dict) -> None:
        """The shared nets, under the JAX package's names."""
        h = cfg.image_size // 8
        trs = cfg.track_running_stats
        self.phi_x = PhiX(cfg.x_channels, cfg.norm_type, trs, **kw)
        self.phi_z = PhiZ(cfg.z_dim, h, h, cfg.norm_type, trs, **kw)
        self.enc = ConvMLPGaussian(enc_in, h, cfg.z_dim, cfg.norm_type, trs, **kw)
        self.prior = ConvMLPGaussian(prior_in, h, cfg.z_dim, cfg.norm_type, trs, **kw)
        self.dec = FrameDecoder(cfg.h_dim + ZMAP, cfg.norm_type, trs, **kw)
        self.head = LikelihoodHead(32, cfg.x_channels, cfg.loss_type, cfg.preprocess_range,
                                   cfg.n_logistics, cfg.n_bits, cfg.dequantize, **kw)

    @property
    def _ura(self) -> bool:
        """The nets normalise with their running averages."""
        return bool(self.eval_norm and self.cfg.track_running_stats)

    def _phi_x_n(self, x):
        return self.phi_x(x, self._ura)

    def _phi_z_n(self, z):
        return self.phi_z(z, self._ura)

    def _enc_n(self, x):
        return self.enc(x, self._ura)

    def _prior_n(self, x):
        return self.prior(x, self._ura)

    def _decode_features(self, h, z):
        return self.dec(torch.cat([h, self._phi_z_n(z)], -1), self._ura)

    def _features(self, x):
        """``phi_x`` over all B·T frames at once -> [T, B, h, w, 256]."""
        b, t = x.shape[:2]
        flat = self._phi_x_n(x.reshape((b * t,) + x.shape[2:]))
        return flat.reshape((b, t) + flat.shape[1:]).transpose(0, 1)

    def _iw_term(self, h, x_t, em, es, pm, ps, noise, k: int):
        """One frame's importance-weighted log-likelihood [B] over k
        posterior samples, each decoded over its own batch of B (batch
        norm keeps per-sample statistics, as the JAX package's vmap);
        returns it and the first sample."""
        ws, z_first = [], None
        for _ in range(k):
            zx = normal_sample(em, es, noise.normal(em))
            u = self.head.dequantization(noise, x_t)
            lpx = -self.head.nll(self._decode_features(h, zx), x_t, u)
            lpz = normal_log_prob(zx, pm, ps).sum(-1)
            lqzx = normal_log_prob(zx, em, es).sum(-1)
            ws.append(lpx + lpz - lqzx)
            z_first = zx if z_first is None else z_first
        return torch.logsumexp(torch.stack(ws), 0) - math.log(k), z_first

    def _loss_dict(self, kl_loss, nlls):
        kl = batch_reduce(kl_loss).mean()
        return dict(kl_free_bits=kl, kl=kl, nll=torch.stack(nlls).sum(0).mean())

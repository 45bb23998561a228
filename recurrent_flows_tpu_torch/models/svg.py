"""SVG-LP, stochastic video generation with a learned prior, the
counterpart of ``recurrent_flows_tpu.models.svg``.

A VGG encoder to a 1x1 bottleneck with one skip map per stage, the
mirrored decoder, the frame-predictor LSTM and the posterior and
learned-prior Gaussian LSTMs over vector latents (``nn.dense_lstm``);
losses bernoulli, mse and gaussian; the analytic KL between the two
Gaussian LSTMs; ``predict``/``reconstruct``/``sample`` and the
importance-weighted ELBO. SVG runs no kernel of the port: its LSTMs are
dense products and its convs cuDNN's.

All frames are encoded in one pass over B·T (per frame over B in the
rollouts); the decoder runs per frame over B, the IW-ELBO's K samples each
over B (a loop: batch norm keeps per-sample statistics, as the JAX
package's vmap).

Draws, through a ``NoiseSource`` in the JAX package's order. The JAX
package hands the posterior and the prior the same key in a step, so both
would draw the same eps; the port draws it once, for the LSTM whose z is
used:

* ``loss``: per frame the posterior eps [B, z], all drawn before the
  per-frame steps run (a recomputed step sees its forward's draws);
* ``predict``: per context step the posterior eps; per predicted frame
  the prior eps;
* ``reconstruct``: per frame the posterior eps;
* ``sample``: per frame the prior eps;
* ``elbo_importance_weighting``: per frame the posterior eps, then one eps
  per each of the K samples;
* ``stats_refresh``: the posterior eps.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import SVGConfig, check_supported
from ..nn.dense_lstm import SVGGaussianLSTM, SVGLSTM
from ..nn.layers import Conv2d, ConvTranspose2d, NormLayer, max_pool_nhwc, upsample_nearest2x
from ..utils.numerics import (NoiseSource, batch_reduce, float32_precision, normal_kl,
                              normal_log_prob)
from ..utils.running_stats import updating_running_stats

_CHANNELS = (64, 128, 256, 512)
_LAYERS = (2, 2, 3, 3)
# decoder layers per stage: one at the finest scale, 2/3/3 at the coarser
_DEC_LAYERS = (1, 2, 3, 3)


def n_stages(image_size: int) -> int:
    """The encoder's stages (64 -> 4), each ending in a 2x2 pool."""
    return max(1, (image_size.bit_length() - 1) - 2)


class _VGGStack(nn.Module):
    """3x3 conv -> norm -> leaky relu (0.2) layers named ``<name>_conv`` and
    ``<name>_norm``; ``self.layers`` holds the names in order per stage."""

    def _vgg(self, name, cin, cout, norm_type, trs, kw):
        self.add_module(f"{name}_conv", Conv2d(cin, cout, 3, **kw))
        self.add_module(f"{name}_norm", NormLayer(norm_type, cout, trs,
                                                  device=kw["device"]))

    def _run(self, name, x, ura):
        x = getattr(self, f"{name}_conv")(x)
        return F.leaky_relu(getattr(self, f"{name}_norm")(x, ura), 0.2)


class SVGEncoder(_VGGStack):
    """VGG encoder: [B,H,W,C] -> ([B, dim] tanh bottleneck, skip maps, one
    per stage); the bottleneck is a 'VALID' k x k conv over what the pools
    leave (4x4 at 64x64)."""

    def __init__(self, dim: int, image_size: int, in_channels: int,
                 norm_type: str = "batchnorm", track_running_stats: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dim = dim
        self.stages = []
        c = in_channels
        for s in range(n_stages(image_size)):
            ch = _CHANNELS[min(s, len(_CHANNELS) - 1)]
            names = [f"c{s}_{l}" for l in range(_LAYERS[min(s, len(_LAYERS) - 1)])]
            for name in names:
                self._vgg(name, c, ch, norm_type, track_running_stats, kw)
                c = ch
            self.stages.append(names)
        k = image_size >> n_stages(image_size)
        self.bottleneck = Conv2d(c, dim, k, padding=0, **kw)
        self.bottleneck_norm = NormLayer(norm_type, dim, track_running_stats,
                                         device=device)

    def forward(self, x, use_running_average: bool = False):
        skips = []
        for names in self.stages:
            for name in names:
                x = self._run(name, x, use_running_average)
            skips.append(x)
            x = max_pool_nhwc(x)
        x = torch.tanh(self.bottleneck_norm(self.bottleneck(x), use_running_average))
        return x.reshape(x.shape[0], self.dim), skips


class SVGDecoder(_VGGStack):
    """The mirrored decoder: a 'VALID' k x k transposed conv ``up0`` from
    [B, dim] as 1x1, then per stage (coarsest first) nearest 2x, the skip
    map concatenated, ``_DEC_LAYERS`` VGG layers; a 3x3 ``out_conv`` and a
    sigmoid."""

    def __init__(self, dim: int, image_size: int, channels: int = 1,
                 norm_type: str = "batchnorm", track_running_stats: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dim = dim
        ns = n_stages(image_size)
        k = image_size >> ns
        self.up0 = ConvTranspose2d(dim, 512, k, 1, "VALID", **kw)
        self.up0_norm = NormLayer(norm_type, 512, track_running_stats, device=device)
        self.stages = []
        c = 512
        for s in reversed(range(ns)):
            ch = _CHANNELS[min(s, len(_CHANNELS) - 1)]
            n_l = _DEC_LAYERS[min(s, len(_DEC_LAYERS) - 1)]
            c += ch  # the skip map
            names = []
            for l in range(n_l):
                out = ch if l < n_l - 1 else (_CHANNELS[max(s - 1, 0)] if s > 0 else 64)
                self._vgg(f"d{s}_{l}", c, out, norm_type, track_running_stats, kw)
                names.append(f"d{s}_{l}")
                c = out
            self.stages.append((s, names))
        self.out_conv = Conv2d(c, channels, 3, **kw)

    def forward(self, vec, skips, use_running_average: bool = False):
        ura = use_running_average
        x = self.up0(vec.reshape(vec.shape[0], 1, 1, self.dim))
        x = F.leaky_relu(self.up0_norm(x, ura), 0.2)
        for s, names in self.stages:
            x = torch.cat([upsample_nearest2x(x), skips[s]], -1)
            for name in names:
                x = self._run(name, x, ura)
        return torch.sigmoid(self.out_conv(x))


class SVG(nn.Module):
    """SVG-LP on an explicit ``device``, its parameters initialised from
    ``generator`` (a CPU generator seeded 0 when None); ``remat`` and
    ``eval_norm`` as in ``SRNN``."""

    def __init__(self, cfg: SVGConfig, *, remat: bool = True, eval_norm: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg, self.remat, self.eval_norm = cfg, remat, eval_norm
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(device=device, generator=generator)
        trs, g = cfg.track_running_stats, cfg.c_features
        self.encoder = SVGEncoder(g, cfg.image_size, cfg.x_channels, cfg.norm_type, trs,
                                  **kw)
        self.decoder = SVGDecoder(g, cfg.image_size, cfg.x_channels, cfg.norm_type, trs,
                                  **kw)
        self.frame_predictor = SVGLSTM(g + cfg.z_dim, g, cfg.h_dim,
                                       cfg.predictor_rnn_layers, **kw)
        self.posterior = SVGGaussianLSTM(g, cfg.z_dim, cfg.h_dim,
                                         cfg.posterior_rnn_layers, **kw)
        self.prior = SVGGaussianLSTM(g, cfg.z_dim, cfg.h_dim, cfg.prior_rnn_layers, **kw)

    @property
    def _ura(self) -> bool:
        return bool(self.eval_norm and self.cfg.track_running_stats)

    def _enc_n(self, x):
        return self.encoder(x, self._ura)

    def _dec_n(self, vec, skips):
        return self.decoder(vec, skips, self._ura)

    def _encode_all(self, x):
        """The encoder over all B·T frames at once: (h [T, B, dim], skips,
        each [T, B, ...])."""
        b, t = x.shape[:2]
        h, skips = self._enc_n(x.reshape((b * t,) + x.shape[2:]))
        tm = lambda a: a.reshape((b, t) + a.shape[1:]).transpose(0, 1)
        return tm(h), [tm(s) for s in skips]

    def _init_states(self, batch: int, device):
        return (self.frame_predictor.init_state(batch, device),
                self.posterior.init_state(batch, device),
                self.prior.init_state(batch, device))

    def _eps(self, noise, h):
        """One [B, z] standard-normal draw."""
        return noise.normal(h.new_empty((h.shape[0], self.cfg.z_dim)))

    def _nll(self, x_pred, x_t):
        cfg = self.cfg
        if cfg.loss_type == "bernoulli":
            p = torch.clamp(x_pred, 1e-6, 1 - 1e-6)
            return -batch_reduce(x_t * torch.log(p) + (1 - x_t) * torch.log1p(-p))
        if cfg.loss_type == "mse":
            return batch_reduce(torch.square(x_pred - x_t))
        return -batch_reduce(normal_log_prob(x_t, x_pred,
                                             cfg.variance * torch.ones_like(x_pred)))

    def _predict_frame(self, h, z, fp, skip):
        h_pred, fp = self.frame_predictor(torch.cat([h, z], -1), fp)
        return self._dec_n(h_pred, skip), fp

    # ------------------------------------------------------------------
    @torch.no_grad()
    def stats_refresh(self, x, noise: NoiseSource):
        """Refresh the running statistics from frames 0-1 of x, inside
        ``updating_running_stats``: the JAX package's init-only step.
        Returns the nll [B]."""
        with updating_running_stats():
            hs, skips = self._encode_all(x[:, :2])
            fp, po, pr = self._init_states(x.shape[0], x.device)
            z_t = self.posterior(hs[1], po, self._eps(noise, hs[1]))[0]
            x_pred, _ = self._predict_frame(hs[0], z_t, fp, [s[0] for s in skips])
            return self._nll(x_pred, x[:, 1])

    @float32_precision()
    def loss(self, x, noise: NoiseSource):
        """ELBO pieces over x [B, T, H, W, C] (model space): dict of
        kl_free_bits, kl, nll (batch means), in full float32."""
        if x.dim() != 5:
            raise ValueError("x must be [B, T, H, W, C]")
        t = x.shape[1]
        hs, skips = self._encode_all(x)
        states = self._init_states(x.shape[0], x.device)
        eps = [self._eps(noise, hs[0]) for _ in range(t - 1)]
        x_tm = x.transpose(0, 1)

        def step(states, h, h_target, x_t, eps_t, *skip):
            fp, po, pr = states
            z_t, mu_q, std_q, po = self.posterior(h_target, po, eps_t)
            _, mu_p, std_p, pr = self.prior(h, pr)
            x_pred, fp = self._predict_frame(h, z_t, fp, list(skip))
            return (fp, po, pr), self._nll(x_pred, x_t), normal_kl(mu_q, std_q, mu_p, std_p)

        kls, nlls = [], []
        for i in range(t - 1):
            args = (states, hs[i], hs[i + 1], x_tm[i + 1], eps[i], *(s[i] for s in skips))
            if self.remat and torch.is_grad_enabled():
                states, nll, kl = checkpoint(step, *args, use_reentrant=False,
                                             preserve_rng_state=False)
            else:
                states, nll, kl = step(*args)
            kls.append(kl)
            nlls.append(nll)
        kl = batch_reduce(torch.stack(kls).sum(0)).mean()
        return dict(kl_free_bits=kl, kl=kl, nll=torch.stack(nlls).sum(0).mean())

    # ------------------------------------------------------------------
    def _rollout(self, states, frame, n: int, noise: NoiseSource):
        """n frames on from ``frame`` with the learned prior's latents."""
        fp, po, pr = states
        frames = []
        for _ in range(n):
            h, skip = self._enc_n(frame)
            z_t, _, _, pr = self.prior(h, pr, self._eps(noise, h))
            frame, fp = self._predict_frame(h, z_t, fp, skip)
            frames.append(frame)
        return torch.stack(frames)

    @torch.no_grad()
    @float32_precision()
    def predict(self, x, n_predictions: int, n_conditions: int, noise: NoiseSource):
        """Posterior-driven warm-up over the context, then the learned-prior
        rollout. Returns (true_x [n_conditions, B, ...], predictions
        [n_predictions, B, ...]), time-major."""
        fp, po, pr = self._init_states(x.shape[0], x.device)
        hs, _ = self._encode_all(x[:, :n_conditions])
        for i in range(n_conditions - 1):
            z_t, _, _, po = self.posterior(hs[i + 1], po, self._eps(noise, hs[i]))
            _, _, _, pr = self.prior(hs[i], pr)
            _, fp = self.frame_predictor(torch.cat([hs[i], z_t], -1), fp)
        preds = self._rollout((fp, po, pr), x[:, n_conditions - 1], n_predictions, noise)
        return x[:, :n_conditions].transpose(0, 1), preds

    @torch.no_grad()
    @float32_precision()
    def reconstruct(self, x, noise: NoiseSource):
        """Posterior reconstructions of frames 1..T-1: [T-1, B, H, W, C]."""
        hs, skips = self._encode_all(x)
        fp, po, _ = self._init_states(x.shape[0], x.device)
        recons = []
        for i in range(x.shape[1] - 1):
            z_t, _, _, po = self.posterior(hs[i + 1], po, self._eps(noise, hs[i]))
            frame, fp = self._predict_frame(hs[i], z_t, fp, [s[i] for s in skips])
            recons.append(frame)
        return torch.stack(recons)

    @torch.no_grad()
    @float32_precision()
    def sample(self, x, n_samples: int, noise: NoiseSource):
        """Free-running learned-prior rollout seeded by frame 0: [n_samples,
        B, ...]."""
        return self._rollout(self._init_states(x.shape[0], x.device), x[:, 0], n_samples,
                             noise)

    @torch.no_grad()
    @float32_precision()
    def elbo_importance_weighting(self, x, K: int, noise: NoiseSource):
        """The K-sample importance-weighted ELBO (a scalar); the frame
        predictor advances with the posterior's own sample."""
        hs, skips = self._encode_all(x)
        fp, po, pr = self._init_states(x.shape[0], x.device)
        x_tm = x.transpose(0, 1)
        iws = []
        for i in range(x.shape[1] - 1):
            h, skip = hs[i], [s[i] for s in skips]
            z_t, mu_q, std_q, po = self.posterior(hs[i + 1], po, self._eps(noise, h))
            _, mu_p, std_p, pr = self.prior(h, pr)
            ws = []
            for _ in range(K):
                z = mu_q + std_q * self._eps(noise, h)
                x_pred, _ = self._predict_frame(h, z, fp, skip)
                ws.append(-self._nll(x_pred, x_tm[i + 1])
                          + normal_log_prob(z, mu_p, std_p).sum(-1)
                          - normal_log_prob(z, mu_q, std_q).sum(-1))
            iws.append(torch.logsumexp(torch.stack(ws), 0) - math.log(K))
            _, fp = self.frame_predictor(torch.cat([h, z_t], -1), fp)
        return -torch.stack(iws).sum(0).mean()

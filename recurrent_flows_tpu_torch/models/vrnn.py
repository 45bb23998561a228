"""VRNN, the variational RNN with dense latents, the counterpart of
``recurrent_flows_tpu.models.vrnn``.

A ConvLSTM (``lstm``, the ``convlstm_gates`` kernel on the card) over
[phi_x(x_{t-1}) | phi_z(z_{t-1})], the prior p(z_t | h_t), the encoder
q(z_t | h_t, phi_x(x_t)), the transposed-conv decoder with the four
likelihoods, ``predict``/``reconstruct``/``sample`` and the
importance-weighted ELBO. The recurrence consumes the previous posterior
sample, so the LSTM runs inside the per-frame step; the frame features
are computed once over all B·T frames (per frame over B in the rollout).

Draws, through a ``NoiseSource`` in the JAX package's order (u and decode
as in ``models.srnn``):

* ``loss``: per frame the posterior eps, then u; all drawn before the
  per-frame steps run (a recomputed step sees its forward's draws);
* ``predict``: per context step the prior eps, then the posterior eps; per
  predicted frame the prior eps, then decode;
* ``reconstruct``: per frame the posterior eps, then decode;
* ``sample``: per frame the prior eps, then decode;
* ``elbo_importance_weighting``: per frame, for each of the K samples the
  posterior eps and u;
* ``stats_refresh``: u, then decode.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import VRNNConfig, check_supported
from ..nn.convlstm import ConvLSTMCell
from ..utils.numerics import (NoiseSource, expand_to_batch, float32_precision,
                              normal_kl, normal_sample)
from ..utils.running_stats import updating_running_stats
from .dense_latent import FEAT, ZMAP, DenseLatentModel


class VRNN(DenseLatentModel):
    """VRNN on an explicit ``device``, its parameters initialised from
    ``generator`` (a CPU generator seeded 0 when None); ``remat`` and
    ``eval_norm`` as in ``SRNN``."""

    def __init__(self, cfg: VRNNConfig, *, remat: bool = True, eval_norm: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg, self.remat, self.eval_norm = cfg, remat, eval_norm
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(device=device, generator=generator)
        h = cfg.image_size // 8
        self._make_nets(cfg, cfg.h_dim + FEAT, cfg.h_dim, kw)
        self.lstm = ConvLSTMCell(FEAT + ZMAP, cfg.h_dim, (h, h), **kw)
        for name, shape in (("h_0", (1, h, h, cfg.h_dim)), ("c_0", (1, h, h, cfg.h_dim)),
                            ("z_0", (1, cfg.z_dim)), ("z_0x", (1, cfg.z_dim))):
            self.register_parameter(name, nn.Parameter(torch.zeros(shape, device=device)))

    def get_inits(self, batch: int):
        """(h_0, c_0, z_0, z_0x) broadcast to the batch."""
        return tuple(expand_to_batch(p, batch) for p in (self.h_0, self.c_0, self.z_0, self.z_0x))

    def _advance(self, feat_prev, zprev, h, c):
        return self.lstm(torch.cat([feat_prev, self._phi_z_n(zprev)], -1), h, c)

    def _enc_params(self, h, feat_t):
        return self._enc_n(torch.cat([h, feat_t], -1))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def stats_refresh(self, x, noise: NoiseSource):
        """Refresh the running statistics from frames 0-1 of x, inside
        ``updating_running_stats``: the JAX package's init-only pass.
        Returns the nll [B]."""
        with updating_running_stats():
            feats = self._features(x[:, :2])
            h0, c0, _, z0x = self.get_inits(x.shape[0])
            ht, _ = self._advance(feats[0], z0x, h0, c0)
            self._prior_n(ht)
            em, _ = self._enc_params(ht, feats[1])
            dec = self._decode_features(ht, em)
            nll = self.head.nll(dec, x[:, 1], self.head.dequantization(noise, x[:, 1]))
            self.head.decode(dec, noise)
        return nll

    @float32_precision()
    def loss(self, x, noise: NoiseSource):
        """ELBO pieces over x [B, T, H, W, C] (model space): dict of
        kl_free_bits, kl, nll (batch means), in full float32."""
        if x.dim() != 5:
            raise ValueError("x must be [B, T, H, W, C]")
        t = x.shape[1]
        feats = self._features(x)
        h, c, _, zxprev = self.get_inits(x.shape[0])
        x_tm = x.transpose(0, 1)
        draws = [(noise.normal(zxprev), self.head.dequantization(noise, x_tm[0]))
                 for _ in range(t - 1)]

        def step(h, c, zxprev, x_t, feat_prev, feat_t, eps, u):
            h, c = self._advance(feat_prev, zxprev, h, c)
            pm, ps = self._prior_n(h)
            em, es = self._enc_params(h, feat_t)
            zx_t = normal_sample(em, es, eps)
            nll = self.head.nll(self._decode_features(h, zx_t), x_t, u)
            return h, c, zx_t, normal_kl(em, es, pm, ps), nll

        kls, nlls = [], []
        for i in range(t - 1):
            args = (h, c, zxprev, x_tm[i + 1], feats[i], feats[i + 1], *draws[i])
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(step, *args, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = step(*args)
            h, c, zxprev, kl, nll = out
            kls.append(kl)
            nlls.append(nll)
        return self._loss_dict(torch.stack(kls).sum(0), nlls)

    # ------------------------------------------------------------------
    def _rollout(self, h, c, zprev, frame, n: int, noise: NoiseSource):
        """n frames on from ``frame``, continuing the prior latent chain."""
        frames = []
        for _ in range(n):
            h, c = self._advance(self._phi_x_n(frame), zprev, h, c)
            pm, ps = self._prior_n(h)
            zprev = normal_sample(pm, ps, noise.normal(pm))
            frame = self.head.decode(self._decode_features(h, zprev), noise)
            frames.append(frame)
        return torch.stack(frames)

    @torch.no_grad()
    @float32_precision()
    def predict(self, x, n_predictions: int, n_conditions: int, noise: NoiseSource):
        """The warm-up advances the LSTM with the posterior samples, the
        rollout continues the prior's chain. Returns (true_x [n_conditions,
        B, ...], predictions [n_predictions, B, ...]), time-major."""
        feats = self._features(x[:, :n_conditions])
        h, c, zprev, zxprev = self.get_inits(x.shape[0])
        for i in range(n_conditions - 1):
            h, c = self._advance(feats[i], zxprev, h, c)
            pm, ps = self._prior_n(h)
            zprev = normal_sample(pm, ps, noise.normal(pm))
            em, es = self._enc_params(h, feats[i + 1])
            zxprev = normal_sample(em, es, noise.normal(em))
        preds = self._rollout(h, c, zprev, x[:, n_conditions - 1], n_predictions, noise)
        return x[:, :n_conditions].transpose(0, 1), preds

    @torch.no_grad()
    @float32_precision()
    def reconstruct(self, x, noise: NoiseSource):
        """Posterior reconstructions of frames 1..T-1: [T-1, B, H, W, C]."""
        feats = self._features(x)
        h, c, _, zxprev = self.get_inits(x.shape[0])
        recons = []
        for i in range(x.shape[1] - 1):
            h, c = self._advance(feats[i], zxprev, h, c)
            em, es = self._enc_params(h, feats[i + 1])
            zxprev = normal_sample(em, es, noise.normal(em))
            recons.append(self.head.decode(self._decode_features(h, zxprev), noise))
        return torch.stack(recons)

    @torch.no_grad()
    @float32_precision()
    def sample(self, x, n_samples: int, noise: NoiseSource):
        """Free-running prior rollout seeded by frame 0: [n_samples, B, ...]."""
        h, c, zprev, _ = self.get_inits(x.shape[0])
        return self._rollout(h, c, zprev, x[:, 0], n_samples, noise)

    @torch.no_grad()
    @float32_precision()
    def elbo_importance_weighting(self, x, K: int, noise: NoiseSource):
        """The K-sample importance-weighted ELBO (a scalar); the LSTM
        advances with the first posterior sample."""
        feats = self._features(x)
        h, c, _, zxprev = self.get_inits(x.shape[0])
        x_tm = x.transpose(0, 1)
        iws = []
        for i in range(x.shape[1] - 1):
            h, c = self._advance(feats[i], zxprev, h, c)
            pm, ps = self._prior_n(h)
            em, es = self._enc_params(h, feats[i + 1])
            iw, zxprev = self._iw_term(h, x_tm[i + 1], em, es, pm, ps, noise, K)
            iws.append(iw)
        return -torch.stack(iws).sum(0).mean()

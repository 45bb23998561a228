"""SRNN, the stochastic RNN with a ConvLSTM backbone and dense latents, the
counterpart of ``recurrent_flows_tpu.models.srnn``.

A deterministic ConvLSTM (``lstm_h``) over the frame features, an optional
backward smoothing ConvLSTM (``lstm_a``), vector latents lifted to maps,
the residual posterior (``res_q``), latent overshooting (``D``), the four
likelihoods of ``LikelihoodHead``, ``predict``/``reconstruct``/``sample``
and the importance-weighted ELBO. Both ConvLSTMs run the
``convlstm_gates`` kernel on the card.

Each net sees the batch the JAX package gives it, since batch norm
normalises over it: ``phi_x`` runs over all B·T frames at once in the
loss, ``reconstruct`` and the IW-ELBO, over the B·n_conditions context
frames and then per frame over B in ``predict``; the overshooting prior
over (T-1-d)·B rows; the IW-ELBO's K samples each over B (a loop, not
folded into the batch).

The frameworks cannot share a PRNG, so every draw goes through a
:class:`~recurrent_flows_tpu_torch.utils.numerics.NoiseSource`, in the JAX
package's order ("u" is the likelihood's dequantization uniform, drawn
only for 'gaussian' with ``dequantize``; "decode" the mixture's two
uniforms, drawn only for 'mol'):

* ``loss``: per frame the posterior eps, the prior eps (it only feeds the
  next frame's prior under ``res_q=False``), u; then one eps per overshoot
  depth [T-1-d, B, z]; all are drawn before the per-frame steps run, so a
  step recomputed in the backward sees the draws of its forward;
* ``predict``: per context step the prior eps; per predicted frame the
  prior eps, then decode;
* ``reconstruct``: per frame the posterior eps, then decode;
* ``sample``: per frame the prior eps, then decode;
* ``elbo_importance_weighting``: per frame, for each of the K samples the
  posterior eps and u, then the prior eps of the next step's chain;
* ``stats_refresh``: u, then decode.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import SRNNConfig, check_supported
from ..nn.convlstm import ConvLSTMCell, conv_lstm_scan
from ..utils.numerics import (NoiseSource, expand_to_batch, float32_precision,
                              normal_kl, normal_sample)
from ..utils.running_stats import updating_running_stats
from .dense_latent import FEAT, ZMAP, DenseLatentModel

class SRNN(DenseLatentModel):
    """SRNN on an explicit ``device``, its parameters initialised from
    ``generator`` (a CPU generator seeded 0 when None). With ``remat``,
    ``loss`` recomputes each per-frame step in the backward. ``eval_norm``
    (torch's ``model.eval()``) normalises with the running averages where
    ``cfg.track_running_stats`` keeps them."""

    def __init__(self, cfg: SRNNConfig, *, remat: bool = True, eval_norm: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg, self.remat, self.eval_norm = cfg, remat, eval_norm
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(device=device, generator=generator)
        h = cfg.image_size // 8
        enc_in = (cfg.a_dim + ZMAP if cfg.enable_smoothing
                  else cfg.h_dim + ZMAP + FEAT)
        self._make_nets(cfg, enc_in, cfg.h_dim + ZMAP, kw)
        self.lstm_h = ConvLSTMCell(FEAT, cfg.h_dim, (h, h), **kw)
        if cfg.enable_smoothing:
            self.lstm_a = ConvLSTMCell(cfg.h_dim + FEAT, cfg.a_dim, (h, h), **kw)
        for name, shape in (("h_0", (1, h, h, cfg.h_dim)), ("c_0", (1, h, h, cfg.h_dim)),
                            ("a_0", (1, h, h, cfg.a_dim)), ("ca_0", (1, h, h, cfg.a_dim)),
                            ("z_0", (1, cfg.z_dim)), ("z_0x", (1, cfg.z_dim))):
            self.register_parameter(name, nn.Parameter(torch.zeros(shape, device=device)))

    def get_inits(self, batch: int):
        """The learned [1, ...] initial states, broadcast to the batch."""
        return tuple(expand_to_batch(p, batch) for p in (
            self.h_0, self.c_0, self.a_0, self.ca_0, self.z_0, self.z_0x))

    def _prior_params(self, ht, z):
        return self._prior_n(torch.cat([ht, self._phi_z_n(z)], -1))

    def _unroll(self, x):
        """Features of x [B, T, ...], the h-LSTM's states hs [T-1, ...]
        after frames 0..T-2, and the smoothing states as_ (None without
        smoothing), scanned backward."""
        feats = self._features(x)
        h0, c0, a0, ca0, _, _ = self.get_inits(x.shape[0])
        hs, _, _ = conv_lstm_scan(self.lstm_h, feats[:-1], h0, c0)
        as_ = None
        if self.cfg.enable_smoothing:
            as_, _, _ = conv_lstm_scan(self.lstm_a, torch.cat([hs, feats[1:]], -1),
                                       a0, ca0, reverse=True)
        return feats, hs, as_

    def _enc_in(self, ht, at, feat_t, zxprev):
        if self.cfg.enable_smoothing:
            return torch.cat([at, self._phi_z_n(zxprev)], -1)
        return torch.cat([ht, self._phi_z_n(zxprev), feat_t], -1)

    def _encode(self, ht, at, feat_t, zxprev):
        """The posterior's (mean, std); under res_q its mean is the prior's
        over (ht, zxprev) plus the encoder's."""
        enc_mean, enc_std = self._enc_n(self._enc_in(ht, at, feat_t, zxprev))
        if self.cfg.res_q:
            enc_mean = self._prior_params(ht, zxprev)[0] + enc_mean
        return enc_mean, enc_std

    def _posterior(self, ht, at, feat_t, zprev, zxprev):
        """(enc_mean, enc_std, prior_mean, prior_std) of one step; under
        res_q the prior is the one over (ht, zxprev)."""
        enc_mean, enc_std = self._enc_n(self._enc_in(ht, at, feat_t, zxprev))
        prior_mean, prior_std = self._prior_params(ht, zxprev if self.cfg.res_q else zprev)
        if self.cfg.res_q:
            enc_mean = prior_mean + enc_mean
        return enc_mean, enc_std, prior_mean, prior_std

    # ------------------------------------------------------------------
    @torch.no_grad()
    def stats_refresh(self, x, noise: NoiseSource):
        """Refresh the running statistics from frames 0-1 of x [B, T>=2,
        ...], inside ``updating_running_stats``: the JAX package's init-only
        pass (each net once, ``phi_z`` three times). Returns the nll [B]."""
        cfg = self.cfg
        with updating_running_stats():
            feats = self._features(x[:, :2])
            h0, c0, a0, ca0, z0, z0x = self.get_inits(x.shape[0])
            ht, _ = self.lstm_h(feats[0], h0, c0)
            at = None
            if cfg.enable_smoothing:
                at, _ = self.lstm_a(torch.cat([ht, feats[1]], -1), a0, ca0)
            enc_mean, _ = self._enc_n(self._enc_in(ht, at, feats[1], z0x))
            self._prior_params(ht, z0)
            dec = self._decode_features(ht, enc_mean)
            nll = self.head.nll(dec, x[:, 1], self.head.dequantization(noise, x[:, 1]))
            self.head.decode(dec, noise)
        return nll

    @float32_precision()
    def loss(self, x, noise: NoiseSource):
        """ELBO pieces over x [B, T, H, W, C] (model space): dict of
        kl_free_bits, kl, nll (batch means). Runs in full float32 (TF32
        off); a backward pass should run under ``float32_precision()`` too."""
        cfg = self.cfg
        if x.dim() != 5:
            raise ValueError("x must be [B, T, H, W, C]")
        t = x.shape[1]
        feats, hs, as_ = self._unroll(x)
        z0, z0x = self.get_inits(x.shape[0])[4:]
        x_tm = x.transpose(0, 1)
        draws = [(noise.normal(z0), noise.normal(z0),
                  self.head.dequantization(noise, x_tm[0])) for _ in range(t - 1)]
        over = [noise.normal(z0.expand((t - 1 - d,) + z0.shape))
                for d in range(min(cfg.D + 1, t - 1))] if cfg.D > 0 else []

        def step(zprev, zxprev, x_t, ht, at, feat_t, eps_q, eps_p, u):
            em, es, pm, ps = self._posterior(ht, at, feat_t, zprev, zxprev)
            z_tx = normal_sample(em, es, eps_q)
            z_t = normal_sample(pm, ps, eps_p)
            nll = self.head.nll(self._decode_features(ht, z_tx), x_t, u)
            return z_t, z_tx, normal_kl(em, es, pm, ps), nll, em, es

        zprev, zxprev = z0, z0x
        kls, nlls, ems, ess, zx_prevs = [], [], [], [], []
        for i in range(t - 1):
            args = (zprev, zxprev, x_tm[i + 1], hs[i],
                    as_[i] if as_ is not None else None, feats[i + 1], *draws[i])
            zx_prevs.append(zxprev)
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(step, *args, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = step(*args)
            zprev, zxprev, kl, nll, em, es = out
            kls.append(kl)
            nlls.append(nll)
            ems.append(em)
            ess.append(es)
        if cfg.D == 0:
            kl_loss = torch.stack(kls).sum(0)  # [B, z]
        else:
            kl_loss = self._overshoot_kl(hs, torch.stack(ems), torch.stack(ess),
                                         torch.stack(zx_prevs), over)
        return self._loss_dict(kl_loss, nlls)

    def _overshoot_kl(self, hs, enc_means, enc_stds, zx_prevs, eps):
        """Latent overshooting over all start frames at once for each depth
        d: the prior re-rolled from the stored posterior chain over
        (T-1-d)·B rows, accumulating overshot_w·KL(q || p) / D_t with D_t =
        min(T-1-t, D+1); for d > 0 no gradient flows into q."""
        cfg = self.cfg
        n_t = hs.shape[0]
        d_t = torch.clamp(n_t - torch.arange(n_t, device=hs.device),
                          max=cfg.D + 1).to(hs.dtype)
        acc = torch.zeros_like(enc_means)
        zprev = zx_prevs
        for d, eps_d in enumerate(eps):
            n = n_t - d
            zp = zprev[:n]
            inp = torch.cat([hs[d:].reshape((-1,) + hs.shape[2:]),
                             self._phi_z_n(zp.reshape(-1, zp.shape[-1]))], -1)
            pm, ps = self._prior_n(inp)
            pm, ps = pm.reshape(zp.shape), ps.reshape(zp.shape)
            zprev = pm + ps * eps_d
            em, es = enc_means[d:], enc_stds[d:]
            if d > 0:
                em, es = em.detach(), es.detach()
            w = (cfg.overshot_w / d_t[:n]).reshape(n, 1, 1)
            acc = acc + torch.cat([w * normal_kl(em, es, pm, ps), torch.zeros_like(acc[n:])])
        return acc.sum(0)

    # ------------------------------------------------------------------
    def _rollout(self, h, c, zprev, frame, n: int, noise: NoiseSource):
        """n frames on from ``frame`` and (h, c, zprev): per frame phi_x over
        B, the h-LSTM, a prior sample and the decoded frame."""
        frames = []
        for _ in range(n):
            h, c = self.lstm_h(self._phi_x_n(frame), h, c)
            pm, ps = self._prior_params(h, zprev)
            zprev = normal_sample(pm, ps, noise.normal(pm))
            frame = self.head.decode(self._decode_features(h, zprev), noise)
            frames.append(frame)
        return torch.stack(frames)

    @torch.no_grad()
    @float32_precision()
    def predict(self, x, n_predictions: int, n_conditions: int, noise: NoiseSource):
        """Prior-chain warm-up over the context, then the rollout. x: [B,
        T>=n_conditions, H, W, C] in model space. Returns (true_x
        [n_conditions, B, ...], predictions [n_predictions, B, ...]),
        time-major. This and every method below run in full float32."""
        feats = self._features(x[:, :n_conditions])
        h0, c0, _, _, zprev, _ = self.get_inits(x.shape[0])
        hs, h, c = conv_lstm_scan(self.lstm_h, feats[:-1], h0, c0)
        for ht in hs:
            pm, ps = self._prior_params(ht, zprev)
            zprev = normal_sample(pm, ps, noise.normal(pm))
        preds = self._rollout(h, c, zprev, x[:, n_conditions - 1], n_predictions, noise)
        return x[:, :n_conditions].transpose(0, 1), preds

    @torch.no_grad()
    @float32_precision()
    def reconstruct(self, x, noise: NoiseSource):
        """Posterior reconstructions of frames 1..T-1 of x [B, T, ...]:
        [T-1, B, H, W, C]."""
        feats, hs, as_ = self._unroll(x)
        zxprev = self.get_inits(x.shape[0])[5]
        recons = []
        for i in range(hs.shape[0]):
            em, es = self._encode(hs[i], as_[i] if as_ is not None else None,
                                  feats[i + 1], zxprev)
            zxprev = normal_sample(em, es, noise.normal(em))
            recons.append(self.head.decode(self._decode_features(hs[i], zxprev), noise))
        return torch.stack(recons)

    @torch.no_grad()
    @float32_precision()
    def sample(self, x, n_samples: int, noise: NoiseSource):
        """Free-running prior rollout seeded by frame 0 of x: [n_samples,
        B, H, W, C]."""
        h, c, _, _, zprev, _ = self.get_inits(x.shape[0])
        return self._rollout(h, c, zprev, x[:, 0], n_samples, noise)

    @torch.no_grad()
    @float32_precision()
    def elbo_importance_weighting(self, x, K: int, noise: NoiseSource):
        """The K-sample importance-weighted ELBO (a scalar): per frame the
        posterior and prior of the chain, K posterior samples weighted by
        p(x|z)p(z)/q(z|x); the chain advances with the first sample and a
        fresh prior sample."""
        feats, hs, as_ = self._unroll(x)
        zprev, zxprev = self.get_inits(x.shape[0])[4:]
        x_tm = x.transpose(0, 1)
        iws = []
        for i in range(hs.shape[0]):
            em, es, pm, ps = self._posterior(hs[i], as_[i] if as_ is not None else None,
                                             feats[i + 1], zprev, zxprev)
            iw, zxprev = self._iw_term(hs[i], x_tm[i + 1], em, es, pm, ps, noise, K)
            zprev = normal_sample(pm, ps, noise.normal(pm))
            iws.append(iw)
        return -torch.stack(iws).sum(0).mean()

"""RFN, the recurrent flow network, the counterpart of
``recurrent_flows_tpu.models.rfn``.

Two programs are ported. The autoregressive rollout: ``predict`` (warm-up
over the context frames, then per frame extractor -> ConvLSTM -> prior ->
upscaler -> ``ListGlow.sample``). The training objective: ``loss`` (one
extractor call over all frames, the h-LSTM and the optional reverse
a-LSTM, then per frame encoder, prior, KL, upscaler and
``ListGlow.log_prob``), with ``ddi`` for the data-dependent init.
``reconstruct``, ``sample`` and the diagnostics come later (ROADMAP.md
queue 1).

The frameworks cannot share a PRNG, so every draw goes through a
:class:`~recurrent_flows_tpu_torch.utils.numerics.NoiseSource`, in the
JAX package's order. ``predict``: per warm-up step the prior eps then the
encoder eps (drawn even though ``predict`` never uses it); per predicted
frame the prior eps, the flow's base eps, then one eps per split, scale
L-2 first. ``loss``: per frame the prior eps, the encoder eps and the
dequantization uniform, then one eps per overshoot depth; all are drawn
before the per-frame steps run, so a step recomputed in the backward
sees the draws of its forward. ``ddi``: the encoder eps, then the
dequantization uniform.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import RFNConfig, check_supported
from ..flows.glow import ListGlow
from ..nn.convlstm import ConvLSTMCell, conv_lstm_scan
from ..nn.layers import SimpleParamNet
from ..nn.vgg import VGGDownscaler, VGGUpscaler, downscaler_layer_sizes
from ..utils.numerics import (NoiseSource, batch_reduce, float32_precision,
                              free_bits_kl, normal_kl, normal_sample)


class RFN(nn.Module):
    """RFN on an explicit ``device``, its parameters initialised from
    ``generator`` (a CPU generator seeded 0 when None). With ``remat``,
    ``loss`` keeps no activations of its per-frame steps and recomputes
    each step in the backward (``torch.utils.checkpoint``)."""

    def __init__(self, cfg: RFNConfig, *, remat: bool = True, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.remat = remat
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(device=device, generator=generator)
        self._use_skip_list = not (cfg.skip_connection_flow == "without_skip"
                                   and not cfg.skip_connection_features)
        sizes = downscaler_layer_sizes(cfg.extractor_structure, cfg.x_channels,
                                       cfg.image_size, cfg.structure_scaler)
        feat_c = sizes[-1][2]
        hu = cfg.image_size // (2 ** cfg.L)
        self.extractor = VGGDownscaler(
            cfg.extractor_structure, cfg.x_channels,
            norm_type=cfg.norm_type_features, non_lin="relu",
            scale=cfg.structure_scaler, skip_con=self._use_skip_list,
            tanh=cfg.downscaler_tanh, **kw)
        skip_ch = [s[2] for s in sizes]
        self.upscaler = VGGUpscaler(
            cfg.upscaler_structure, cfg.h_dim + cfg.z_dim,
            skip_channels=skip_ch if cfg.skip_connection_features else None,
            norm_type=cfg.norm_type_features, non_lin="leakyrelu",
            scale=cfg.structure_scaler, tanh=cfg.upscaler_tanh, **kw)
        self.lstm = ConvLSTMCell(feat_c, cfg.h_dim, (hu, hu), **kw)
        if cfg.enable_smoothing:
            self.a_lstm = ConvLSTMCell(cfg.h_dim + feat_c, cfg.a_dim, (hu, hu), **kw)
            enc_in = cfg.a_dim + cfg.z_dim
        else:
            enc_in = cfg.h_dim + cfg.z_dim + feat_c
        self.prior = SimpleParamNet(cfg.prior_structure, cfg.h_dim + cfg.z_dim,
                                    cfg.z_dim, norm_type=cfg.norm_type,
                                    non_lin="leakyrelu", **kw)
        self.encoder = SimpleParamNet(cfg.encoder_structure, enc_in, cfg.z_dim,
                                      norm_type=cfg.norm_type,
                                      non_lin="leakyrelu", **kw)
        # upscaler outputs, high-res first, then the skip-mode combination
        up_ch = [[i for i in b if isinstance(i, int)][-1]
                 for b in cfg.upscaler_structure][::-1]
        mode = cfg.skip_connection_flow
        cond_ch = [skip_ch[l] if mode == "only_skip" else
                   up_ch[l] + (skip_ch[l] if mode == "with_skip" else 0)
                   for l in range(cfg.L)]
        self.flow = ListGlow(cfg.x_channels, cfg.image_size, cfg.glow, cond_ch,
                             cfg.h_dim + cfg.z_dim, **kw)
        for name, dim in (("h_0", cfg.h_dim), ("c_0", cfg.h_dim),
                          ("a_0", cfg.a_dim), ("ca_0", cfg.a_dim),
                          ("z_0", cfg.z_dim), ("z_0x", cfg.z_dim)):
            self.register_parameter(name, nn.Parameter(
                torch.zeros((1, hu, hu, dim), device=device)))

    # ------------------------------------------------------------------
    def get_inits(self, batch: int):
        """The learned [1, ...] initial states, broadcast to the batch."""
        rep = lambda p: p.expand((batch,) + p.shape[1:])
        return (rep(self.h_0), rep(self.c_0), rep(self.a_0), rep(self.ca_0),
                rep(self.z_0), rep(self.z_0x))

    def _features(self, x):
        """One extractor call over all B·T frames: [B,T,H,W,C] -> (per-block
        maps [T,B,h,w,c] or None, the last block's map)."""
        b, t = x.shape[:2]
        out = self.extractor(x.reshape((b * t,) + x.shape[2:]))

        def tm(a):
            return a.reshape((b, t) + a.shape[1:]).transpose(0, 1)

        if self._use_skip_list:
            feats = [tm(o) for o in out]
            return feats, feats[-1]
        return None, tm(out)

    def _flow_conditions(self, ht, zt, skips_prev):
        """Upscaler conditions + the skip-mode combination for one step."""
        cfg = self.cfg
        hz = torch.cat([ht, zt], -1)
        if cfg.skip_connection_features:
            conds = self.upscaler(hz, skip_list=skips_prev)
        else:
            conds = self.upscaler(hz)
        if cfg.skip_connection_flow == "with_skip":
            conds = [torch.cat([c, s], -1) for c, s in zip(conds, skips_prev)]
        elif cfg.skip_connection_flow == "only_skip":
            conds = list(skips_prev)
        return conds, hz

    def _unroll_a(self, hs, f_last, a0, ca0):
        """Reverse smoothing a-LSTM: a_j from [h_j, feat_{j+1}]."""
        as_, _, _ = conv_lstm_scan(self.a_lstm, torch.cat([hs, f_last[1:]], -1),
                                   a0, ca0, reverse=True)
        return as_

    def _posterior_prior(self, ht, at, feat_t, zprev, zxprev):
        """Encoder and prior parameters of one step: (enc_mean, enc_std,
        prior_mean, prior_std), with the residual posterior under res_q."""
        cfg = self.cfg
        if cfg.enable_smoothing:
            enc_in = torch.cat([at, zxprev], -1)
        else:
            enc_in = torch.cat([ht, zxprev, feat_t], -1)
        enc_mean, enc_std = self.encoder(enc_in)
        if cfg.res_q:
            prior_mean, prior_std = self.prior(torch.cat([ht, zxprev], -1))
            enc_mean = prior_mean + enc_mean
        else:
            prior_mean, prior_std = self.prior(torch.cat([ht, zprev], -1))
        return enc_mean, enc_std, prior_mean, prior_std

    # ------------------------------------------------------------------
    def ddi(self, x, noise: NoiseSource):
        """The data-dependent-init pass over frames 0-1 of x [B, T>=2, H, W,
        C]: one step of the loss with every ActNorm of the flow in ``ddi``
        mode, which sets it in place (call it through
        ``flows.ddi.data_dependent_init``). Returns the nll [B]."""
        cfg = self.cfg
        b = x.shape[0]
        feats, f_last = self._features(x[:, :2])
        h0, c0, a0, ca0, _, z0x = self.get_inits(b)
        ht, _ = self.lstm(f_last[0], h0, c0)
        if cfg.enable_smoothing:
            at, _ = self.a_lstm(torch.cat([ht, f_last[1]], -1), a0, ca0)
            enc_in = torch.cat([at, z0x], -1)
        else:
            enc_in = torch.cat([ht, z0x, f_last[1]], -1)
        enc_mean, enc_std = self.encoder(enc_in)
        zxt = normal_sample(enc_mean, enc_std, noise.normal(enc_mean))
        skips_prev = [f[0] for f in feats] if feats is not None else None
        conds, hz = self._flow_conditions(ht, zxt, skips_prev)
        _, nll = self.flow.log_prob(x[:, 1], conds, hz, noise, ddi=True)
        return nll

    @float32_precision()
    def loss(self, x, noise: NoiseSource, logdet: float = 0.0):
        """ELBO pieces over a sequence x [B, T, H, W, C] (model space):
        dict of kl_free_bits, kl, nll (batch means); the trainer combines
        them as nll + beta·kl_free_bits. Runs in full float32 (TF32 off);
        a backward pass should run under ``float32_precision()`` too."""
        cfg = self.cfg
        if x.dim() != 5:
            raise ValueError("x must be [B, T, H, W, C]")
        b, t = x.shape[:2]
        feats, f_last = self._features(x)
        h0, c0, a0, ca0, z0, z0x = self.get_inits(b)
        hs, _, _ = conv_lstm_scan(self.lstm, f_last[:-1], h0, c0)
        as_ = self._unroll_a(hs, f_last, a0, ca0) if cfg.enable_smoothing else None
        x_tm = x.transpose(0, 1)
        n_bins = 2.0 ** cfg.glow.n_bits
        draws = [(noise.normal(z0), noise.normal(z0),
                  noise.uniform(x_tm[0], 0.0, 1.0 / n_bins))
                 for _ in range(t - 1)]

        def step(zprev, zxprev, x_t, ht, at, feat_t, sk_prev, eps_p, eps_q, u):
            enc_mean, enc_std, prior_mean, prior_std = self._posterior_prior(
                ht, at, feat_t, zprev, zxprev)
            zt = normal_sample(prior_mean, prior_std, eps_p)
            zxt = normal_sample(enc_mean, enc_std, eps_q)
            conds, hz = self._flow_conditions(ht, zxt, sk_prev)
            kl = normal_kl(enc_mean, enc_std, prior_mean, prior_std)
            _, nll = self.flow.log_prob(x_t + u, conds, hz, logdet=logdet,
                                        dequantize=False)
            return zt, zxt, kl, enc_mean, enc_std, nll

        zprev, zxprev = z0, z0x
        kls, enc_means, enc_stds, zx_prevs, nlls = [], [], [], [], []
        for i in range(t - 1):
            args = (zprev, zxprev, x_tm[i + 1], hs[i],
                    as_[i] if as_ is not None else None, f_last[i + 1],
                    [f[i] for f in feats] if feats is not None else None,
                    *draws[i])
            zx_prevs.append(zxprev)
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(step, *args, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = step(*args)
            zprev, zxprev, kl, enc_mean, enc_std, nll = out
            kls.append(kl)
            enc_means.append(enc_mean)
            enc_stds.append(enc_std)
            nlls.append(nll)

        nll_loss = torch.stack(nlls).sum(0)  # [B]
        if cfg.D == 0:
            kl_loss = torch.stack(kls).sum(0)  # [B, hu, wu, z]
        else:
            kl_loss = self._overshoot_kl(hs, torch.stack(enc_means),
                                         torch.stack(enc_stds),
                                         torch.stack(zx_prevs), noise)
        kl_fb = free_bits_kl(kl_loss, cfg.free_bits) if cfg.free_bits > 0 else kl_loss
        return dict(kl_free_bits=batch_reduce(kl_fb).mean(),
                    kl=batch_reduce(kl_loss).mean(), nll=nll_loss.mean())

    def _overshoot_kl(self, hs, enc_means, enc_stds, zx_prevs, noise):
        """Latent-overshooting KL, over all start frames at once for each
        depth d: the prior is re-rolled from the stored posterior chain,
        accumulating overshot_w·KL(q || p) / D_t with D_t = min(T-1-t, D+1);
        for d > 0 no gradient flows into q."""
        cfg = self.cfg
        n_t = hs.shape[0]  # T-1
        d_t = torch.clamp(n_t - torch.arange(n_t, device=hs.device),
                          max=cfg.D + 1).to(hs.dtype)
        acc = torch.zeros_like(enc_means)  # [T-1, B, hu, wu, z]
        zprev = zx_prevs
        for d in range(min(cfg.D + 1, n_t)):
            n = n_t - d
            inp = torch.cat([hs[d:], zprev[:n]], -1)
            pm, ps = self.prior(inp.reshape((-1,) + inp.shape[2:]))
            pm = pm.reshape((n,) + inp.shape[1:4] + (-1,))
            ps = ps.reshape(pm.shape)
            zprev = pm + ps * noise.normal(pm)
            em, es = enc_means[d:], enc_stds[d:]
            if d > 0:
                em, es = em.detach(), es.detach()
            w = (cfg.overshot_w / d_t[:n]).reshape((n, 1, 1, 1, 1))
            acc = acc + torch.cat([w * normal_kl(em, es, pm, ps),
                                   torch.zeros_like(acc[n:])])
        return acc.sum(0)

    # ------------------------------------------------------------------
    def _warmup(self, x, n_conditions: int, noise: NoiseSource,
                kl_temperature: float = 1.0):
        """Advance the posterior/prior chain over the conditioning frames.
        Returns the final (h, c, zprev, zxprev)."""
        cfg = self.cfg
        b = x.shape[0]
        _, f_last = self._features(x[:, :n_conditions])
        h0, c0, a0, ca0, zprev, zxprev = self.get_inits(b)
        hs, h_t, c_t = conv_lstm_scan(self.lstm, f_last[:-1], h0, c0)
        as_ = self._unroll_a(hs, f_last, a0, ca0) if cfg.enable_smoothing else None
        for t in range(n_conditions - 1):
            enc_mean, enc_std, prior_mean, prior_std = self._posterior_prior(
                hs[t], as_[t] if as_ is not None else None, f_last[t + 1],
                zprev, zxprev)
            zprev = normal_sample(prior_mean, prior_std * kl_temperature,
                                  noise.normal(prior_mean))
            zxprev = normal_sample(enc_mean, enc_std, noise.normal(enc_mean))
        return h_t, c_t, zprev, zxprev

    @torch.no_grad()
    @float32_precision()
    def predict(self, x, n_predictions: int, n_conditions: int,
                noise: NoiseSource, kl_temperature: float = 1.0,
                temperature: float | None = None):
        """Warm-up on the conditioning frames, then the autoregressive flow
        rollout. x: [B, T>=n_conditions, H, W, C] in model space.

        Returns (true_x [n_conditions,B,H,W,C], predictions [n_pred,...]),
        time-major. The chain kernel's stacked parameters are prepared once
        per call. ``temperature`` defaults to ``cfg.temperature``. Runs in
        full float32 (TF32 off), whatever the caller's settings.
        """
        temperature = self.cfg.temperature if temperature is None else temperature
        chain = self.flow.prepare_chain()
        h, c, zprev, _ = self._warmup(x, n_conditions, noise, kl_temperature)
        prediction = x[:, n_conditions - 1]
        preds = []
        for _ in range(n_predictions):
            if self._use_skip_list:
                cond_list = self.extractor(prediction)
                condition = cond_list[-1]
            else:
                cond_list = None
                condition = self.extractor(prediction)
            h, c = self.lstm(condition, h, c)
            prior_mean, prior_std = self.prior(torch.cat([h, zprev], -1))
            zprev = normal_sample(prior_mean, prior_std * kl_temperature,
                                  noise.normal(prior_mean))
            conds, hz = self._flow_conditions(h, zprev, cond_list)
            prediction = self.flow.sample(conds, hz, noise, temperature, chain)
            preds.append(prediction)
        return x[:, :n_conditions].transpose(0, 1), torch.stack(preds)

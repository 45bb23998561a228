"""RFN, the recurrent flow network: its serving path, the counterpart of
``recurrent_flows_tpu.models.rfn``.

This slice ports the autoregressive rollout: ``predict`` (warm-up over the
context frames, then per frame extractor -> ConvLSTM -> prior -> upscaler
-> ``ListGlow.sample``). ``loss``, ``reconstruct``, ``sample`` and the
diagnostics come later (ROADMAP.md queue 1).

The frameworks cannot share a PRNG, so every draw goes through a
:class:`~recurrent_flows_tpu_torch.utils.numerics.NoiseSource`, in the
JAX package's order: per warm-up step the prior eps then the encoder eps
(drawn even though ``predict`` never uses it); per predicted frame the
prior eps, the flow's base eps, then one eps per split, scale L-2 first.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import RFNConfig, check_supported
from ..flows.glow import ListGlow
from ..nn.convlstm import ConvLSTMCell, conv_lstm_scan
from ..nn.layers import SimpleParamNet
from ..nn.vgg import VGGDownscaler, VGGUpscaler, downscaler_layer_sizes
from ..utils.numerics import NoiseSource, float32_precision, normal_sample


class RFN(nn.Module):
    """RFN on an explicit ``device``, its parameters initialised from
    ``generator`` (a CPU generator seeded 0 when None)."""

    def __init__(self, cfg: RFNConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
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
        if cfg.enable_smoothing:
            as_, _, _ = conv_lstm_scan(
                self.a_lstm, torch.cat([hs, f_last[1:]], -1), a0, ca0,
                reverse=True)
        for t in range(n_conditions - 1):
            ht = hs[t]
            if cfg.enable_smoothing:
                enc_in = torch.cat([as_[t], zxprev], -1)
            else:
                enc_in = torch.cat([ht, zxprev, f_last[t + 1]], -1)
            enc_mean, enc_std = self.encoder(enc_in)
            if cfg.res_q:
                prior_mean, prior_std = self.prior(torch.cat([ht, zxprev], -1))
                enc_mean = prior_mean + enc_mean
            else:
                prior_mean, prior_std = self.prior(torch.cat([ht, zprev], -1))
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

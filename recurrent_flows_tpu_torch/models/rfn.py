"""RFN, the recurrent flow network, the counterpart of
``recurrent_flows_tpu.models.rfn``.

The autoregressive rollout ``predict`` (warm-up over the context frames,
then per frame extractor -> ConvLSTM -> prior -> upscaler ->
``ListGlow.sample``) and the free-running ``sample`` from frame 0. The
training objective ``loss`` (one extractor call over all frames, the
h-LSTM and the optional reverse a-LSTM, then per frame encoder, prior, KL,
upscaler and ``ListGlow.log_prob``), with ``ddi`` for the data-dependent
init. ``reconstruct`` (posterior reconstructions and the flow's x -> z ->
x), the diagnostics ``param_analysis``, ``probability_future`` and
``reconstruct_elbo_gap`` over the shared posterior/prior scan, and the
interpolation API ``get_zt_ht_from_seq`` / ``predicts_from_zt_ht``.
``init_running_stats`` and ``stats_refresh`` are the passes that update
running statistics (``flow_norm='batchnorm'``, ``track_running_stats``);
``eval_norm`` normalises the feature nets with them. On a (data x model)
grid (``parallel.mesh``, a ``Trainer`` step) ``loss`` runs on this rank's
rows of every frame and returns its share of the sums.

The frameworks cannot share a PRNG, so every draw goes through a
:class:`~recurrent_flows_tpu_torch.utils.numerics.NoiseSource`, in the
JAX package's order. A flow sample draws the base eps, then one eps per
split, scale L-2 first; given z it draws the split eps only.

* the posterior scan (``predict``'s warm-up and the diagnostics): per
  step the prior eps, then the encoder eps;
* ``predict``: the scan over the context frames; per predicted frame the
  prior eps, then a flow sample;
* ``sample``: per frame the prior eps, then a flow sample;
* ``reconstruct``: per frame the encoder eps, the dequantization
  uniform, the split eps of ``recons_flow`` (x -> z -> x), then a flow
  sample for ``recons``;
* ``param_analysis``: the scan over all frames, then a flow sample per
  frame;
* ``probability_future``: the scan over the context frames, then one
  dequantization uniform per future frame, which the prior and the
  posterior latent share, as in the JAX package;
* ``reconstruct_elbo_gap``: the scan over all frames, then per frame and
  latent (prior, posterior) the dequantization uniform and, with
  ``sample``, the split eps of ``recons_flow`` and a flow sample;
* ``get_zt_ht_from_seq``: the scan; ``predicts_from_zt_ht``: a flow sample;
* ``loss``: per frame the prior eps, the encoder eps and the
  dequantization uniform, then one eps per overshoot depth; all are drawn
  before the per-frame steps run, so a step recomputed in the backward
  sees the draws of its forward;
* ``ddi`` and ``stats_refresh``: the encoder eps, then the dequantization
  uniform; ``init_running_stats``: the dequantization uniform.
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
from ..utils.numerics import (NoiseSource, batch_reduce, expand_to_batch,
                              float32_precision, free_bits_kl, normal_kl,
                              normal_sample)
from ..utils.profiling import span
from ..utils.running_stats import updating_running_stats


class RFN(nn.Module):
    """RFN on an explicit ``device``, its parameters initialised from
    ``generator`` (a CPU generator seeded 0 when None). With ``remat``,
    ``loss`` keeps no activations of its per-frame steps and recomputes
    each step in the backward (``torch.utils.checkpoint``). ``eval_norm``
    (torch's ``model.eval()`` for the batch norms of the extractor,
    upscaler, prior and encoder) normalises them with their running
    averages where ``cfg.track_running_stats`` keeps them."""

    def __init__(self, cfg: RFNConfig, *, remat: bool = True,
                 eval_norm: bool = False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.remat = remat
        self.eval_norm = eval_norm
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
            tanh=cfg.downscaler_tanh, track_running_stats=cfg.track_running_stats,
            **kw)
        skip_ch = [s[2] for s in sizes]
        self.upscaler = VGGUpscaler(
            cfg.upscaler_structure, cfg.h_dim + cfg.z_dim,
            skip_channels=skip_ch if cfg.skip_connection_features else None,
            norm_type=cfg.norm_type_features, non_lin="leakyrelu",
            scale=cfg.structure_scaler, tanh=cfg.upscaler_tanh,
            track_running_stats=cfg.track_running_stats, **kw)
        self.lstm = ConvLSTMCell(feat_c, cfg.h_dim, (hu, hu), **kw)
        if cfg.enable_smoothing:
            self.a_lstm = ConvLSTMCell(cfg.h_dim + feat_c, cfg.a_dim, (hu, hu), **kw)
            enc_in = cfg.a_dim + cfg.z_dim
        else:
            enc_in = cfg.h_dim + cfg.z_dim + feat_c
        self.prior = SimpleParamNet(cfg.prior_structure, cfg.h_dim + cfg.z_dim,
                                    cfg.z_dim, norm_type=cfg.norm_type,
                                    non_lin="leakyrelu",
                                    track_running_stats=cfg.track_running_stats, **kw)
        self.encoder = SimpleParamNet(cfg.encoder_structure, enc_in, cfg.z_dim,
                                      norm_type=cfg.norm_type, non_lin="leakyrelu",
                                      track_running_stats=cfg.track_running_stats, **kw)
        # upscaler outputs, high-res first, then the skip-mode combination
        up_ch = self.upscaler.out_channels
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
    @property
    def _ura(self) -> bool:
        """The feature nets normalise with their running averages."""
        return bool(self.eval_norm and self.cfg.track_running_stats)

    def _extract(self, x):
        with span("rfn.extract"):
            return self.extractor(x, self._ura)

    def _enc_net(self, x):
        return self.encoder(x, self._ura)

    def _prior_net(self, x):
        return self.prior(x, self._ura)

    def get_inits(self, batch: int):
        """The learned [1, ...] initial states, broadcast to the batch."""
        return tuple(expand_to_batch(p, batch) for p in (
            self.h_0, self.c_0, self.a_0, self.ca_0, self.z_0, self.z_0x))

    def _features(self, x):
        """One extractor call over all B·T frames: [B,T,H,W,C] -> (per-block
        maps [T,B,h,w,c] or None, the last block's map)."""
        b, t = x.shape[:2]
        out = self._extract(x.reshape((b * t,) + x.shape[2:]))

        def tm(a):
            return a.reshape((b, t) + a.shape[1:]).transpose(0, 1)

        if self._use_skip_list:
            feats = [tm(o) for o in out]
            return feats, feats[-1]
        return None, tm(out)

    def _flow_conditions(self, ht, zt, skips_prev):
        """Upscaler conditions + the skip-mode combination for one step."""
        cfg = self.cfg
        with span("rfn.flow_conditions"):
            hz = torch.cat([ht, zt], -1)
            if cfg.skip_connection_features:
                conds = self.upscaler(hz, skips_prev, self._ura)
            else:
                conds = self.upscaler(hz, use_running_average=self._ura)
            if cfg.skip_connection_flow == "with_skip":
                conds = [torch.cat([c, s], -1) for c, s in zip(conds, skips_prev)]
            elif cfg.skip_connection_flow == "only_skip":
                conds = list(skips_prev)
        return conds, hz

    def _unroll(self, x):
        """Features of x [B, T, H, W, C] and the recurrent states over them:
        (feats, f_last, hs [T-1, ...], the h-LSTM's last (h, c), as_ or
        None). hs[t] is the state after frames 0..t; as_[t] the smoothing
        a-LSTM's, scanned backward from the last frame."""
        cfg = self.cfg
        with span("rfn.unroll"):
            feats, f_last = self._features(x)
            h0, c0, a0, ca0, _, _ = self.get_inits(x.shape[0])
            with span("rfn.convlstm_scan"):
                hs, h_t, c_t = conv_lstm_scan(self.lstm, f_last[:-1], h0, c0)
                as_ = None
                if cfg.enable_smoothing:
                    as_, _, _ = conv_lstm_scan(self.a_lstm, torch.cat([hs, f_last[1:]], -1),
                                               a0, ca0, reverse=True)
        return feats, f_last, hs, (h_t, c_t), as_

    def _encode(self, ht, at, feat_t, zxprev):
        """The encoder's (mean, std) before the residual posterior."""
        if self.cfg.enable_smoothing:
            return self._enc_net(torch.cat([at, zxprev], -1))
        return self._enc_net(torch.cat([ht, zxprev, feat_t], -1))

    def _posterior_prior(self, ht, at, feat_t, zprev, zxprev):
        """Encoder and prior parameters of one step: (enc_mean, enc_std,
        prior_mean, prior_std), with the residual posterior under res_q."""
        cfg = self.cfg
        with span("rfn.posterior_prior"):
            enc_mean, enc_std = self._encode(ht, at, feat_t, zxprev)
            if cfg.res_q:
                prior_mean, prior_std = self._prior_net(torch.cat([ht, zxprev], -1))
                enc_mean = prior_mean + enc_mean
            else:
                prior_mean, prior_std = self._prior_net(torch.cat([ht, zprev], -1))
        return enc_mean, enc_std, prior_mean, prior_std

    # ------------------------------------------------------------------
    def _first_step(self, x):
        """Frames 0-1 of x [B, T>=2, H, W, C] up to the flow: (conditions,
        base condition, encoder mean and std) of frame 1."""
        cfg = self.cfg
        b = x.shape[0]
        feats, f_last = self._features(x[:, :2])
        h0, c0, a0, ca0, _, z0x = self.get_inits(b)
        ht, _ = self.lstm(f_last[0], h0, c0)
        at = None
        if cfg.enable_smoothing:
            at, _ = self.a_lstm(torch.cat([ht, f_last[1]], -1), a0, ca0)
        enc_mean, enc_std = self._encode(ht, at, f_last[1], z0x)
        return ht, _skips(feats, 0), enc_mean, enc_std

    def ddi(self, x, noise: NoiseSource, *, ddi: bool = True):
        """The data-dependent-init pass over frames 0-1 of x [B, T>=2, H, W,
        C]: one step of the loss with every ActNorm of the flow in ``ddi``
        mode, which sets it in place (call it through
        ``flows.ddi.data_dependent_init``). Returns the nll [B]. With
        ``ddi=False`` the same pass leaves the ActNorms as they are
        (``stats_refresh``)."""
        ht, skips_prev, enc_mean, enc_std = self._first_step(x)
        zxt = normal_sample(enc_mean, enc_std, noise.normal(enc_mean))
        conds, hz = self._flow_conditions(ht, zxt, skips_prev)
        _, nll = self.flow.log_prob(x[:, 1], conds, hz, noise, ddi=ddi)
        return nll

    @torch.no_grad()
    def stats_refresh(self, x, noise: NoiseSource):
        """Refresh the running statistics (the flow's BatchNormFlow and the
        NormLayers that track them) from x [B, T>=2, H, W, C]: the DDI pass
        with ``ddi=False``, its flow on frame 1 only, inside
        ``updating_running_stats``. Returns the nll [B]."""
        with updating_running_stats():
            return self.ddi(x, noise, ddi=False)

    @torch.no_grad()
    def init_running_stats(self, x, noise: NoiseSource):
        """What the JAX package's ``model.init`` leaves in the
        ``batch_stats`` collection: one pass of frames 0-1 with the
        encoder's mean as the latent, inside
        ``updating_running_stats(initializing=True)``, so the flow's
        BatchNormFlows keep this batch's statistics (the NormLayers keep
        0 and 1). Draws the dequantization uniform. Returns the nll [B]."""
        ht, skips_prev, enc_mean, _ = self._first_step(x)
        with updating_running_stats(initializing=True):
            conds, hz = self._flow_conditions(ht, enc_mean, skips_prev)
            _, nll = self.flow.log_prob(x[:, 1], conds, hz, noise)
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
        feats, f_last, hs, _, as_ = self._unroll(x)
        z0, z0x = self.get_inits(b)[4:]
        x_tm = x.transpose(0, 1)
        n_bins = 2.0 ** cfg.glow.n_bits
        draws = [(noise.normal(z0), noise.normal(z0),
                  noise.uniform(x_tm[0], 0.0, 1.0 / n_bins))
                 for _ in range(t - 1)]

        def step(zprev, zxprev, x_t, ht, at, feat_t, sk_prev, eps_p, eps_q, u):
            with span("rfn.step"):
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
                    _skips(feats, i), *draws[i])
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
        with span("rfn.overshoot_kl"):
            cfg = self.cfg
            n_t = hs.shape[0]  # T-1
            d_t = torch.clamp(n_t - torch.arange(n_t, device=hs.device),
                              max=cfg.D + 1).to(hs.dtype)
            acc = torch.zeros_like(enc_means)  # [T-1, B, hu, wu, z]
            zprev = zx_prevs
            for d in range(min(cfg.D + 1, n_t)):
                n = n_t - d
                inp = torch.cat([hs[d:], zprev[:n]], -1)
                pm, ps = self._prior_net(inp.reshape((-1,) + inp.shape[2:]))
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
    def _posterior_scan(self, x, noise: NoiseSource, kl_temperature: float = 1.0):
        """The posterior/prior chain over x [B, T, H, W, C]. Returns (steps,
        hs, feats, last): ``steps`` one dict per step t < T-1 of prior_mean,
        prior_std, enc_mean, enc_std, zt (prior sample, its std scaled by
        ``kl_temperature``) and zxt (posterior sample), stacked by
        ``_time_major`` where a caller reads them all; ``last`` the
        h-LSTM's (h, c) and the last (zt, zxt)."""
        with span("rfn.posterior_scan"):
            b, t = x.shape[:2]
            feats, f_last, hs, (h_t, c_t), as_ = self._unroll(x)
            zprev, zxprev = self.get_inits(b)[4:]
            steps = []
            for i in range(t - 1):
                enc_mean, enc_std, prior_mean, prior_std = self._posterior_prior(
                    hs[i], as_[i] if as_ is not None else None, f_last[i + 1],
                    zprev, zxprev)
                zprev = normal_sample(prior_mean, prior_std * kl_temperature,
                                      noise.normal(prior_mean))
                zxprev = normal_sample(enc_mean, enc_std, noise.normal(enc_mean))
                steps.append(dict(prior_mean=prior_mean, prior_std=prior_std,
                                  enc_mean=enc_mean, enc_std=enc_std, zt=zprev,
                                  zxt=zxprev))
        return steps, hs, feats, (h_t, c_t, zprev, zxprev)

    def _rollout(self, h, c, zprev, frame, n: int, noise: NoiseSource,
                 kl_temperature: float, temperature: float):
        """The autoregressive loop of ``predict`` and ``sample``: n frames on
        from ``frame`` and the recurrent state (h, c, zprev), [n, B, ...].
        The chain kernel's stacked parameters are prepared once."""
        with span("rfn.prepare_chain"):
            chain = self.flow.prepare_chain(frame.shape[0])
        frames = []
        for _ in range(n):
            with span("rfn.rollout.frame"):
                if self._use_skip_list:
                    cond_list = self._extract(frame)
                    condition = cond_list[-1]
                else:
                    cond_list = None
                    condition = self._extract(frame)
                with span("rfn.lstm"):
                    h, c = self.lstm(condition, h, c)
                with span("rfn.prior"):
                    prior_mean, prior_std = self._prior_net(torch.cat([h, zprev], -1))
                    zprev = normal_sample(prior_mean, prior_std * kl_temperature,
                                          noise.normal(prior_mean))
                conds, hz = self._flow_conditions(h, zprev, cond_list)
                frame = self.flow.sample(conds, hz, noise, temperature, chain)
            frames.append(frame)
        return torch.stack(frames)

    @torch.no_grad()
    @float32_precision()
    def predict(self, x, n_predictions: int, n_conditions: int,
                noise: NoiseSource, kl_temperature: float = 1.0,
                temperature: float | None = None):
        """Warm-up on the conditioning frames, then the autoregressive flow
        rollout. x: [B, T>=n_conditions, H, W, C] in model space.

        Returns (true_x [n_conditions,B,H,W,C], predictions [n_pred,...]),
        time-major. ``temperature`` defaults to ``cfg.temperature``. This
        and every method below run in full float32 (TF32 off), whatever the
        caller's settings.
        """
        temperature = self.cfg.temperature if temperature is None else temperature
        _, _, _, (h, c, zprev, _) = self._posterior_scan(
            x[:, :n_conditions], noise, kl_temperature)
        preds = self._rollout(h, c, zprev, x[:, n_conditions - 1], n_predictions,
                              noise, kl_temperature, temperature)
        return x[:, :n_conditions].transpose(0, 1), preds

    @torch.no_grad()
    @float32_precision()
    def sample(self, x, n_samples: int, noise: NoiseSource,
               temperature: float | None = None):
        """Free-running prior rollout seeded by frame 0 of x [B, T>=1, H, W,
        C]: [n_samples, B, H, W, C]."""
        temperature = self.cfg.temperature if temperature is None else temperature
        h, c, _, _, zprev, _ = self.get_inits(x.shape[0])
        return self._rollout(h, c, zprev, x[:, 0], n_samples, noise, 1.0, temperature)

    @torch.no_grad()
    @float32_precision()
    def reconstruct(self, x, noise: NoiseSource, temperature: float | None = None):
        """Posterior reconstructions and the flow's bijection check over x
        [B, T, H, W, C]: (recons, recons_flow), time-major [T-1, B, H, W, C].
        ``recons`` samples frame t+1 from the base prior under the posterior
        conditions; ``recons_flow`` maps the dequantized frame x -> z -> x.
        The chain kernel's stacked parameters are prepared once."""
        cfg = self.cfg
        temperature = cfg.temperature if temperature is None else temperature
        b, t = x.shape[:2]
        chain = self.flow.prepare_chain(b)
        feats, f_last, hs, _, as_ = self._unroll(x)
        zxprev = self.get_inits(b)[5]
        x_tm = x.transpose(0, 1)
        recons, recons_flow = [], []
        for i in range(t - 1):
            ht = hs[i]
            enc_mean, enc_std = self._encode(ht, as_[i] if as_ is not None else None,
                                             f_last[i + 1], zxprev)
            if cfg.res_q:
                enc_mean = self._prior_net(torch.cat([ht, zxprev], -1))[0] + enc_mean
            zxprev = normal_sample(enc_mean, enc_std, noise.normal(enc_mean))
            conds, hz = self._flow_conditions(ht, zxprev, _skips(feats, i))
            z, _ = self.flow.log_prob(x_tm[i + 1], conds, hz, noise)
            recons_flow.append(self.flow.sample(conds, hz, noise, temperature,
                                                chain, z=z))
            recons.append(self.flow.sample(conds, hz, noise, temperature, chain))
        return torch.stack(recons), torch.stack(recons_flow)

    # -- diagnostics ---------------------------------------------------------

    @torch.no_grad()
    @float32_precision()
    def param_analysis(self, x, noise: NoiseSource) -> dict:
        """Prior, posterior and base-distribution parameters per frame of x
        [B, T, H, W, C], and a flow sample (temperature 1) under the
        posterior conditions: dict(mu_p, std_p, mu_q, std_q, mu_flow,
        std_flow, predictions), all time-major [T-1, ...]."""
        steps, hs, feats, _ = self._posterior_scan(x, noise)
        outs = _time_major(steps)
        chain = self.flow.prepare_chain(x.shape[0])
        preds, mus, stds = [], [], []
        for i in range(hs.shape[0]):
            conds, _ = self._flow_conditions(hs[i], outs["zxt"][i], _skips(feats, i))
            base = torch.cat([hs[i], outs["zt"][i]], -1)
            pred, (mu, std) = self.flow.sample(conds, base, noise, 1.0, chain,
                                               eval_params=True)
            preds.append(pred)
            mus.append(mu)
            stds.append(std)
        return dict(mu_p=outs["prior_mean"], std_p=outs["prior_std"],
                    mu_q=outs["enc_mean"], std_q=outs["enc_std"],
                    mu_flow=torch.stack(mus), std_flow=torch.stack(stds),
                    predictions=torch.stack(preds))

    @torch.no_grad()
    @float32_precision()
    def probability_future(self, x, n_conditions: int, noise: NoiseSource):
        """NLL of each frame of x [B, T, H, W, C] after the first
        ``n_conditions``, under the context frozen at ``n_conditions`` with
        the prior's and the posterior's latent: [B, 2, T - n_conditions]
        (0 = prior, 1 = posterior)."""
        n_bins = 2.0 ** self.cfg.glow.n_bits
        steps, hs, feats, _ = self._posterior_scan(x[:, :n_conditions], noise)
        ht = hs[-1]
        sk = _skips(feats, n_conditions - 2)
        futures = x.transpose(0, 1)[n_conditions:]
        futures = [x_t + noise.uniform(x_t, 0.0, 1.0 / n_bins) for x_t in futures]
        nlls = []
        for zk in (steps[-1]["zt"], steps[-1]["zxt"]):
            conds, base = self._flow_conditions(ht, zk, sk)
            nlls.append(torch.stack([self.flow.log_prob(x_t, conds, base,
                                                        dequantize=False)[1]
                                     for x_t in futures]))
        return torch.stack(nlls).permute(2, 0, 1)

    @torch.no_grad()
    @float32_precision()
    def reconstruct_elbo_gap(self, x, noise: NoiseSource, sample: bool = True):
        """Per-frame NLL under the prior's and the posterior's latent, and
        the per-frame KL, over x [B, T, H, W, C]. Returns (recons,
        recons_flow, kld [T-1, B], nll [2, T-1, B]); with ``sample`` the
        reconstructions are [T-1, 2, B, H, W, C] (0 = prior, 1 =
        posterior), else None."""
        temperature = self.cfg.temperature
        steps, hs, feats, _ = self._posterior_scan(x, noise)
        outs = _time_major(steps)
        kld = normal_kl(outs["enc_mean"], outs["enc_std"], outs["prior_mean"],
                        outs["prior_std"]).sum((2, 3, 4))
        chain = self.flow.prepare_chain(x.shape[0]) if sample else None
        x_tm = x.transpose(0, 1)
        nlls, recons, recons_flow = [], [], []
        for i in range(hs.shape[0]):
            for zk in (outs["zt"][i], outs["zxt"][i]):
                conds, base = self._flow_conditions(hs[i], zk, _skips(feats, i))
                z, nll = self.flow.log_prob(x_tm[i + 1], conds, base, noise)
                nlls.append(nll)
                if sample:
                    recons_flow.append(self.flow.sample(conds, base, noise, temperature,
                                                        chain, z=z))
                    recons.append(self.flow.sample(conds, base, noise, temperature,
                                                   chain))
        t1 = hs.shape[0]
        nll = torch.stack(nlls).reshape((t1, 2) + nlls[0].shape).transpose(0, 1)
        if not sample:
            return None, None, kld, nll
        shape = (t1, 2) + recons[0].shape
        return (torch.stack(recons).reshape(shape),
                torch.stack(recons_flow).reshape(shape), kld, nll)

    @torch.no_grad()
    @float32_precision()
    def get_zt_ht_from_seq(self, x, n_conditions: int, noise: NoiseSource):
        """The (posterior z_t, h_t, previous frame's skips) context at the
        end of the first ``n_conditions`` frames of x: the latent
        interpolation API."""
        steps, hs, feats, _ = self._posterior_scan(x[:, :n_conditions], noise)
        return steps[-1]["zxt"], hs[-1], _skips(feats, n_conditions - 2)

    @torch.no_grad()
    @float32_precision()
    def predicts_from_zt_ht(self, zt, ht, skips, noise: NoiseSource):
        """A frame decoded from an explicit (z_t, h_t, skips) context."""
        conds, base = self._flow_conditions(ht, zt, skips)
        return self.flow.sample(conds, base, noise, self.cfg.temperature)


def _time_major(steps):
    """``_posterior_scan``'s per-step dicts as one dict of [T-1, ...]."""
    return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}


def _skips(feats, i: int):
    """Frame i's extractor maps, high-res first, or None without a skip list."""
    return [f[i] for f in feats] if feats is not None else None

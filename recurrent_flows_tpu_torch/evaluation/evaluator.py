"""Offline evaluation suite, the counterpart of
``recurrent_flows_tpu.evaluation.evaluator``: best-of-N rollout metrics,
dataset bits/dim, FVD, the IW-ELBO and RFN's posterior-health
diagnostics, and the qualitative figures.

* ``get_eval_values``: the main protocol. Per test batch, ``resamples``
  stochastic rollouts; per sequence the best of them by its mean metric
  (SSIM/PSNR max, MSE/LPIPS min) and the mean over them;
* ``get_loss``: dataset bits/dim over resampled losses;
* ``get_fvd_values``: rollouts -> FVD;
* ``importance_weighted_elbo``, ``probability_future_bpp``, ``elbo_gap``;
* ``compare_bpp``: bits/dim of several models on one batch;
* ``plot_temperatures`` / ``plot_diversity`` / ``plot_long_rollout`` /
  ``plot_random_samples`` / ``get_interpolations`` / ``param_plots`` and
  ``plot_eval_curves``: the figures, drawn in numpy (``training.plots``)
  and written by ``data.png.write_png`` where a ``path`` asks for one, so
  they need no matplotlib. A strip is the frames of one row, up to 20
  (``plots.frame_grid``: [H', n·(W+1) - 1], RGB for RGB frames).

The model, the metrics and the embedders run on ``device``. Each
resample is its own ``predict`` call: a model with batch norms normalises
each resample over its own batch, as the JAX package's ``vmap`` over keys
does (folding the resamples into the batch would change the statistics).
A batch's tracks reach the host once. Data and noise come from one
``torch.Generator`` on the device, seeded with ``seed``; ``noise`` (a
function of (call, batch index, resample index) returning a
``NoiseSource``) replaces each call's draws, so a test can replay the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..data.png import write_png
from ..training.plots import boxed_grid, frame_grid, line_panel
from ..utils.numerics import NoiseSource
from .fvd import fvd
from .lpips import lpips_distance
from .metrics import eval_seq

METRICS = ("ssim", "psnr", "mse", "lpips")


@dataclasses.dataclass
class EvalSettings:
    n_conditions: int = 5
    n_predictions: int = 10
    resamples: int = 5
    n_batches: int = 4
    batch_size: int = 8
    temperature: Optional[float] = None  # None = model default
    data_range: float = 1.0
    # FVD over the first fvd_horizon predicted frames only (thesis protocol:
    # 13). None = all n_predictions.
    fvd_horizon: Optional[int] = None


def _bits_per_dim(out, x) -> float:
    """(kl + nll) / (ln 2 · H·W·C · (T-1)) of a loss dict on x [B,T,H,W,C]."""
    dims = x.shape[2] * x.shape[3] * x.shape[4]
    return float(out["kl"] + out["nll"]) / (math.log(2.0) * dims * (x.shape[1] - 1))


class Evaluator:
    """Evaluates a model of the port (RFN, SRNN, VRNN, SVG) that holds its
    weights, on ``device`` (the card unless the caller asks for the CPU).

    Args:
      model: the model; moved to ``device``.
      data: sampler with ``.sample(generator, batch_size)`` -> [B, T, H, W,
        C] in model space (the port's ``MovingMNIST`` protocol).
      settings: ``EvalSettings``.
      postprocess: maps model space to [0, 1] image space for the image
        metrics; identity when None.
      seed: seeds the generator of data and noise.
      noise: optional ``noise(call, batch, resample) -> NoiseSource`` that
        replaces the draws of each model call.
    """

    def __init__(self, model, data, settings: EvalSettings, postprocess=None,
                 device="cuda", seed: int = 0, noise=None):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.data = data
        self.s = settings
        self.post = postprocess or (lambda a: a)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._noise = noise

    # ------------------------------------------------------------------
    def _draws(self, call: str, batch: int = 0, resample: int = 0) -> NoiseSource:
        if self._noise is not None:
            return self._noise(call, batch, resample)
        return NoiseSource(generator=self.generator)

    def _sample(self, batch_size: int):
        x = self.data.sample(self.generator, batch_size)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _predict(self, x, n_predictions: int, noise, **kw):
        """``model.predict`` from x's first n_conditions frames: [B, n, H, W,
        C]."""
        with torch.no_grad():
            _, preds = self.model.predict(x, n_predictions, self.s.n_conditions, noise, **kw)
        return preds.transpose(0, 1)

    def _loss(self, x, noise) -> float:
        with torch.no_grad():
            return _bits_per_dim(self.model.loss(x, noise), x)

    # ------------------------------------------------------------------
    def get_eval_values(self, with_lpips: bool = True,
                        save_grids_dir: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Best-of-N and mean per-frame tracks [N_seq, n_predictions] of
        SSIM, PSNR, MSE (and LPIPS), with a summary (mean, 95% CI, n) of
        the best tracks, plus bits/dim. With ``save_grids_dir`` the best and
        the worst rollout by SSIM are saved as frame strips, ``best.png``
        and ``worst.png``."""
        s = self.s
        names = METRICS if with_lpips else METRICS[:3]
        best = {m: [] for m in names}
        mean = {m: [] for m in names}
        bpds = []
        extreme = dict(best_score=-np.inf, worst_score=np.inf, best_vid=None, worst_vid=None)
        for i in range(s.n_batches):
            x = self._sample(s.batch_size)
            true_future = self.post(x[:, s.n_conditions: s.n_conditions + s.n_predictions])
            tracks = {m: [] for m in names}
            preds_all = []
            for r in range(s.resamples):
                preds = self.post(self._predict(x, s.n_predictions,
                                                self._draws("eval", i, r)))
                res = eval_seq(true_future, preds, s.data_range)
                for m in METRICS[:3]:
                    tracks[m].append(res[m])
                if with_lpips:
                    b, t = true_future.shape[:2]
                    lp = lpips_distance((true_future * 2 - 1).reshape((-1,) + preds.shape[2:]),
                                        (preds * 2 - 1).reshape((-1,) + preds.shape[2:]))
                    tracks["lpips"].append(lp.reshape(b, t))
                if save_grids_dir is not None:
                    preds_all.append(preds)
            # one transfer per batch: [metric, resample, B, T]
            host = torch.stack([torch.stack(tracks[m]) for m in names]).cpu().numpy()
            for m, a in zip(names, host):
                seq_score = a.mean(-1)  # [R, B]
                pick = seq_score.argmax(0) if m in ("ssim", "psnr") else seq_score.argmin(0)
                best[m].append(a[pick, np.arange(a.shape[1])])
                mean[m].append(a.mean(0))
            if save_grids_dir is not None:
                scores = host[0].mean(-1)  # SSIM [R, B]
                r, b = np.unravel_index(scores.argmax(), scores.shape)
                if scores[r, b] > extreme["best_score"]:
                    extreme["best_score"] = float(scores[r, b])
                    extreme["best_vid"] = preds_all[r][b].cpu().numpy()
                r, b = np.unravel_index(scores.argmin(), scores.shape)
                if scores[r, b] < extreme["worst_score"]:
                    extreme["worst_score"] = float(scores[r, b])
                    extreme["worst_vid"] = preds_all[r][b].cpu().numpy()
            bpds.append(self._loss(x, self._draws("eval_loss", i)))
        result = {"bits_per_dim": float(np.mean(bpds)),
                  # the sample size, so a reader can judge the best-of-N
                  # estimates
                  "n_sequences": s.n_batches * s.batch_size}
        for m in names:
            b_all = np.concatenate(best[m], 0)  # [N_seq, T]
            result[f"{m}_best"] = b_all
            result[f"{m}_mean"] = np.concatenate(mean[m], 0)
            seq_scores = b_all.mean(-1)
            n = len(seq_scores)
            result[f"{m}_best_summary"] = dict(
                mean=float(seq_scores.mean()),
                ci95=float(1.96 * seq_scores.std(ddof=1) / np.sqrt(n)) if n > 1
                else float("nan"),
                n=n)
        if save_grids_dir is not None and extreme["best_vid"] is not None:
            _save_strip(extreme["best_vid"], os.path.join(save_grids_dir, "best.png"))
            _save_strip(extreme["worst_vid"], os.path.join(save_grids_dir, "worst.png"))
            result["best_ssim_seq"] = extreme["best_score"]
            result["worst_ssim_seq"] = extreme["worst_score"]
        return result

    def get_loss(self, resamples: int = 3) -> float:
        """Dataset bits/dim averaged over resampled losses."""
        s = self.s
        vals = []
        for i in range(s.n_batches):
            x = self._sample(s.batch_size)
            vals += [self._loss(x, self._draws("loss", i, r)) for r in range(resamples)]
        return float(np.mean(vals))

    def get_fvd_values(self, embedder: str = "auto") -> Dict:
        """Rollouts against the true futures -> FVD, over the first
        ``settings.fvd_horizon`` predicted frames (thesis protocol: 13),
        capped at n_predictions: a rollout has no more frames to compare."""
        s = self.s
        horizon = min(s.fvd_horizon or s.n_predictions, s.n_predictions)
        real, fake = [], []
        for i in range(s.n_batches):
            x = self._sample(s.batch_size)
            preds = self.post(self._predict(x, s.n_predictions, self._draws("fvd", i)))
            real.append(self.post(x[:, s.n_conditions: s.n_conditions + horizon]))
            fake.append(preds[:, :horizon])
        return fvd(torch.cat(real), torch.cat(fake), embedder=embedder)

    def importance_weighted_elbo(self, K: int = 20) -> float:
        """The tighter bound, for a model that has it (SRNN, VRNN, SVG)."""
        s = self.s
        vals = []
        for i in range(s.n_batches):
            x = self._sample(s.batch_size)
            with torch.no_grad():
                vals.append(float(self.model.elbo_importance_weighting(
                    x, K, self._draws("iw_elbo", i))))
        return float(np.mean(vals))

    def probability_future_bpp(self) -> Dict[str, np.ndarray]:
        """Bits per pixel against the horizon under the context frozen at
        n_conditions, with the prior's and the posterior's latent: mean and
        std tracks [n_predictions] over the protocol's sequences."""
        if not hasattr(type(self.model), "probability_future"):
            raise NotImplementedError("model has no probability_future API")
        s = self.s
        curves = []
        for i in range(s.n_batches):
            x = self._sample(s.batch_size)[:, : s.n_conditions + s.n_predictions]
            nlls = self.model.probability_future(x, s.n_conditions,
                                                 self._draws("probability_future", i))
            dims = x.shape[2] * x.shape[3] * x.shape[4]
            curves.append(nlls.cpu().numpy() / (math.log(2.0) * dims))
        c = np.concatenate(curves, 0)  # [N_seq, 2, horizon]
        return dict(bpp_prior=c[:, 0].mean(0), bpp_posterior=c[:, 1].mean(0),
                    bpp_prior_std=c[:, 0].std(0), bpp_posterior_std=c[:, 1].std(0),
                    n_sequences=c.shape[0])

    def elbo_gap(self) -> Dict[str, np.ndarray]:
        """Per-frame NLL (bits/dim) under the prior's and the posterior's
        latent and the KL: mean tracks [T-1] and the amortization gap
        (prior NLL - posterior NLL, bits/dim)."""
        if not hasattr(type(self.model), "reconstruct_elbo_gap"):
            raise NotImplementedError("model has no reconstruct_elbo_gap API")
        s = self.s
        klds, nlls = [], []
        for i in range(s.n_batches):
            x = self._sample(s.batch_size)[:, : s.n_conditions + s.n_predictions]
            _, _, kld, nll = self.model.reconstruct_elbo_gap(x, self._draws("elbo_gap", i),
                                                             sample=False)
            scale = math.log(2.0) * x.shape[2] * x.shape[3] * x.shape[4]
            klds.append(kld.cpu().numpy().T / scale)  # [B, T-1]
            nlls.append(nll.cpu().numpy().transpose(2, 0, 1) / scale)
        kld = np.concatenate(klds, 0)  # [N_seq, T-1]
        nll = np.concatenate(nlls, 0)  # [N_seq, 2, T-1] (0 = prior, 1 = posterior)
        return dict(nll_prior=nll[:, 0].mean(0), nll_posterior=nll[:, 1].mean(0),
                    kld=kld.mean(0), amortization_gap=float((nll[:, 0] - nll[:, 1]).mean()),
                    n_sequences=kld.shape[0])

    # ------------------------------------------------------------------
    def plot_long_rollout(self, n_frames: int = 80, path: Optional[str] = None):
        """A long rollout of the first sequence: [n_frames, H, W, C]; ``path``
        gets its strip."""
        x = self._sample(self.s.batch_size)
        grid = self.post(self._predict(x, n_frames, self._draws("long_rollout")))[0]
        grid = grid.cpu().numpy()
        if path:
            _save_strip(grid, path)
        return grid

    def plot_temperatures(self, temperatures=(0.3, 0.5, 0.7, 1.0), kl_temperatures=(1.0,),
                          path: Optional[str] = None):
        """Rollout grids over (flow temperature, prior kl_temperature) pairs:
        dict[(t, kt)] -> predictions [n_predictions, B, H, W, C]. The model
        keeps every attribute (``eval_norm`` among them): RFN's ``predict``
        takes both temperatures; a model without them rolls out as it is."""
        s = self.s
        x = self._sample(s.batch_size)
        takes = inspect.signature(self.model.predict).parameters
        out, rows = {}, []
        for i, (t, kt) in enumerate((t, kt) for t in temperatures for kt in kl_temperatures):
            kw = {}
            if "temperature" in takes:
                kw["temperature"] = t
            if "kl_temperature" in takes:
                kw["kl_temperature"] = kt
            preds = self._predict(x, s.n_predictions, self._draws("temperatures", 0, i), **kw)
            out[(t, kt)] = self.post(preds.transpose(0, 1)).cpu().numpy()
            rows.append(out[(t, kt)][:, 0])
        if path:
            _save_strip(np.concatenate(rows, -3), path)
        return out

    def get_interpolations(self, n_alphas: int = 8, n_conditions: int = 4,
                           path: Optional[str] = None):
        """Frames decoded from a linear interpolation of the (z_t, h_t)
        contexts of two sequences: [n_alphas, B, H, W, C]."""
        if not hasattr(type(self.model), "get_zt_ht_from_seq"):
            raise NotImplementedError("model has no latent interpolation API")
        x1 = self._sample(self.s.batch_size)
        x2 = self._sample(self.s.batch_size)
        z1, h1, skips = self.model.get_zt_ht_from_seq(x1, n_conditions,
                                                      self._draws("interp_context", 0, 0))
        z2, h2, _ = self.model.get_zt_ht_from_seq(x2, n_conditions,
                                                  self._draws("interp_context", 0, 1))
        frames = []
        for i, a in enumerate(np.linspace(0.0, 1.0, n_alphas)):
            a = float(a)
            f = self.model.predicts_from_zt_ht((1 - a) * z1 + a * z2, (1 - a) * h1 + a * h2,
                                               skips, self._draws("interpolations", 0, i))
            frames.append(self.post(f).cpu().numpy())
        grid = np.stack(frames)
        if path:
            _save_strip(grid[:, 0], path)
        return grid

    def param_plots(self, sync_data, path: Optional[str] = None):
        """Prior, posterior and base-distribution parameter trajectories on
        synchronized data (``sync_data.sample(generator, batch_size)`` ->
        (x, hit_boundary)), with the bounces marked. Returns the
        trajectories; ``path`` gets two 120x300 panels one above the other
        ([240, 300, 3]): the means (mu_p, mu_q, mu_flow) and the standard
        deviations, each in the palette's first three colours, a grey line
        at every bounce."""
        if not hasattr(type(self.model), "param_analysis"):
            raise NotImplementedError("model has no param_analysis")
        x, hits = sync_data.sample(self.generator, self.s.batch_size)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        out = self.model.param_analysis(x, self._draws("param_analysis"))
        traj = {k: v.reshape(v.shape[0], -1).mean(-1).cpu().numpy()
                for k, v in out.items() if k != "predictions"}
        traj["hit_boundary"] = np.asarray(torch.as_tensor(hits).cpu())[0]
        if path:
            marks = [t for t, hit in enumerate(traj["hit_boundary"][1:]) if hit]
            _write(path, np.concatenate([
                line_panel([traj[n] for n in names], height=120, width=300, marks=marks)
                for names in (("mu_p", "mu_q", "mu_flow"), ("std_p", "std_q", "std_flow"))]))
        return traj

    def plot_random_samples(self, n_sequences: int = 5, n_show: int = 7,
                            path: Optional[str] = None):
        """Grid of rollouts, sequences by rows, time by columns, the context
        boxed red and the predictions green: [n_sequences, n_show, H, W, C].
        ``path`` gets the RGB grid of ``plots.boxed_grid`` (2-pixel frames):
        [n_sequences·(H+5) - 1, n_show·(W+5) - 1, 3]."""
        s = self.s
        x = self._sample(max(s.batch_size, n_sequences))
        preds = self.post(self._predict(x, s.n_predictions, self._draws("random_samples")))
        seq = torch.cat([self.post(x[:, : s.n_conditions]), preds], 1).cpu().numpy()
        n_show = min(n_show, seq.shape[1])
        if path:
            _write(path, boxed_grid(seq[:n_sequences, :n_show], s.n_conditions))
        return seq[:n_sequences, :n_show]

    def plot_diversity(self, n_samples: int = 5, path: Optional[str] = None):
        """Several rollouts of the first sequence from the same context:
        [n_samples, n_predictions, H, W, C]."""
        x = self._sample(self.s.batch_size)
        rows = [self.post(self._predict(x, self.s.n_predictions,
                                        self._draws("diversity", 0, r)))[0].cpu().numpy()
                for r in range(n_samples)]
        if path:
            _save_strip(np.concatenate(rows, -3), path)
        return np.stack(rows)


def plot_eval_curves(results: dict, path: str, metrics=METRICS):
    """Per-frame metric curves with mean ± 2 standard errors, one panel per
    metric, one line per experiment. ``results``: {experiment_name:
    get_eval_values() dict}. ``path`` gets one 120x200 ``plots.line_panel``
    per metric that some experiment has, side by side ([120, 200·n, 3]),
    each experiment's band shaded under its line; no text."""
    avail = [m for m in metrics if any(f"{m}_best" in r for r in results.values())]
    panels = []
    for m in avail:
        series, bands = [], []
        for r in results.values():
            track = r.get(f"{m}_best")
            if track is None:
                continue
            track = np.asarray(track)
            mean = track.mean(0)
            std = track.std(0) / max(np.sqrt(track.shape[0]), 1.0)
            series.append(mean)
            bands.append((mean - 2 * std, mean + 2 * std))
        panels.append(line_panel(series, bands=bands))
    _write(path, np.concatenate(panels, 1))


def compare_bpp(models: dict, x, seed: int = 0, noise=None) -> Dict[str, float]:
    """Bits/dim of each model of {name: model} on one batch x [B, T, H, W,
    C] (model space, on the models' device), each loss on the same noise:
    a generator seeded with ``seed``, or ``noise(name) -> NoiseSource``."""
    out = {}
    for name, model in models.items():
        draws = noise(name) if noise is not None else NoiseSource(
            generator=torch.Generator(device=x.device).manual_seed(seed))
        with torch.no_grad():
            out[name] = _bits_per_dim(model.loss(x, draws), x)
    return out


def _write(path, image):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, image)


def _save_strip(frames, path):
    """frames [N, H, W, C] as one row of tiles, up to 20."""
    _write(path, frame_grid([("strip", np.asarray(frames)[:, None])], max_frames=20))

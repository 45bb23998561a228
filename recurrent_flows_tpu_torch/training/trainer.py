"""Training harness of the port, the counterpart of
``recurrent_flows_tpu.training.trainer``: ``Trainer.build`` (data-dependent
init on the first batch, Adam), ``train_step`` (preprocess -> ``model.loss``
-> backward -> optional global-norm clip -> Adam), ``train_epoch`` and
``refresh_stats`` (running statistics from a fresh batch). ``fit``, plots
and checkpoints come later (ROADMAP.md queue 1).

    model = RFN(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, tcfg, batches).build()   # batches: [B,T,H,W,C] in [0,1]
    metrics = trainer.train_step(next(iter(batches)), beta=1.0, lr=1e-4)

A step runs in full float32 with TF32 off, forward and backward
(``utils.float32_precision``), as the JAX package computes. It moves no
running statistic (they update only in ``build`` and ``refresh_stats``),
and Adam steps the parameters only, never the buffers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..flows.ddi import data_dependent_init
from ..utils.numerics import NoiseSource, float32_precision
from ..utils.running_stats import has_running_stats
from .schedules import BetaSchedule, PlateauScheduler, linear_lr


def preprocess(x, n_bits: int = 8, rng_range: str = "0.5", scale: int = 255,
               reverse: bool = False):
    """n-bit quantization to [-0.5, 0.5] ('0.5') or [0, 1] ('1.0').

    Forward expects data in [0, 1]; reverse maps back to bytes.
    'none' passes through; 'minmax' rescales to [-1, 1].
    """
    n_bins = 2.0 ** n_bits
    if rng_range == "none":
        return x
    if rng_range == "minmax":
        if not reverse:
            return x * 2.0 - 1.0
        return torch.clamp((x + 1.0) * 0.5 * 255.0, 0, 255).to(torch.uint8)
    if not reverse:
        x = x * scale
        if n_bits < 8:
            x = torch.floor(x / 2 ** (8 - n_bits))
        x = x / n_bins
        if rng_range == "0.5":
            x = x - 0.5
        return x
    if rng_range == "0.5":
        x = x + 0.5
    x = x * n_bins
    return torch.clamp(torch.floor(x) * (256.0 / n_bins), 0, 255).to(torch.uint8)


def bits_per_dim(kl, nll, dims: int, t: int):
    """-elbo / (ln 2 · C·H·W · (T-1))."""
    return (kl + nll) / (math.log(2.0) * dims * t)


def clip_by_global_norm_(grads, max_norm: float):
    """Scale ``grads`` in place so that their global L2 norm is at most
    ``max_norm``: g·max_norm/‖g‖ where ‖g‖ >= max_norm, untouched below
    (no epsilon in the denominator, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the norm before clipping."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
    return norm


class Trainer:
    """Trains a model with the loss contract ``loss(x, noise) -> {nll, kl,
    kl_free_bits}`` on one device.

    ``data`` is an iterable of numpy batches [B, T, H, W, C] in [0, 1].
    The noise of the loss comes from a ``torch.Generator`` on the device,
    seeded with ``tcfg.seed``; ``build`` and ``train_step`` take a
    ``NoiseSource`` in its place (tests replay the JAX package's draws).
    """

    def __init__(self, model, tcfg, data, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.tcfg = tcfg
        self.data = data
        self.losses: list = []
        self.kl_hist: list = []
        self.recon_hist: list = []
        self.bits_hist: list = []
        self.counter = 0  # optimizer steps taken, for the annealing
        self.stop = False
        self.beta_schedule = BetaSchedule(tcfg.beta_max, tcfg.beta_min,
                                          tcfg.beta_steps)
        self.plateau = PlateauScheduler(tcfg.learning_rate, tcfg.patience_lr,
                                        tcfg.factor_lr, tcfg.min_lr)
        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.optimizer = None
        self._aux_iter = None

    def _to_model_space(self, batch):
        t = self.tcfg
        x = torch.as_tensor(np.asarray(batch, np.float32), device=self.device)
        return preprocess(x, t.n_bits, t.preprocess_range, t.preprocess_scale)

    def _host_batch(self):
        """The next batch of a persistent iterator over ``data``, cycling."""
        if self._aux_iter is None:
            self._aux_iter = iter(self.data)
        try:
            return next(self._aux_iter)
        except StopIteration:
            self._aux_iter = iter(self.data)
            return next(self._aux_iter)

    def build(self, run_ddi: bool = True, noise: NoiseSource | None = None):
        """On the first batch (TF32 off): the running statistics the JAX
        package's ``model.init`` leaves (where the flow has BatchNormFlows:
        ``model.init_running_stats``), then the data-dependent init of the
        flow's ActNorms (in place); then the Adam optimizer."""
        init_stats = (hasattr(self.model, "init_running_stats")
                      and self.model.cfg.glow.flow_norm == "batchnorm")
        run_ddi = run_ddi and hasattr(self.model, "ddi")
        if init_stats or run_ddi:
            x = self._to_model_space(self._host_batch())
            noise = noise or NoiseSource(generator=self.generator)
            with float32_precision():
                if init_stats:
                    self.model.init_running_stats(x, noise)
                if run_ddi:
                    data_dependent_init(self.model, x, noise)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=self.tcfg.learning_rate)
        return self

    def train_step(self, batch, beta: float, lr: float,
                   noise: NoiseSource | None = None) -> dict:
        """One optimizer step on ``batch`` [B, T, H, W, C] in [0, 1].
        Returns loss, kl, nll and bits (per dimension) as 0-d tensors on
        the device; reading them waits for the step."""
        tcfg = self.tcfg
        x = self._to_model_space(batch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        with float32_precision():
            out = self.model.loss(
                x, noise or NoiseSource(generator=self.generator))
            loss = out["nll"] + beta * out["kl_free_bits"]
            loss.backward()
        if tcfg.grad_clip > 0:
            clip_by_global_norm_([p.grad for p in self.model.parameters()
                                  if p.grad is not None], tcfg.grad_clip)
        self.optimizer.step()
        dims = x.shape[2] * x.shape[3] * x.shape[4]
        kl, nll = out["kl"].detach(), out["nll"].detach()
        return dict(loss=loss.detach(), kl=kl, nll=nll,
                    bits=bits_per_dim(kl, nll, dims, x.shape[1] - 1))

    def refresh_stats(self, noise: NoiseSource | None = None) -> None:
        """Update the running statistics (``model.stats_refresh``, TF32
        off) from the next batch of ``data``, so that the sampling
        direction and ``eval_norm`` see trained statistics. Nothing to do
        for a model without running statistics."""
        if not has_running_stats(self.model):
            return
        x = self._to_model_space(self._host_batch())
        with float32_precision():
            self.model.stats_refresh(
                x, noise or NoiseSource(generator=self.generator))

    def train_epoch(self, steps: int | None = None) -> float:
        """Up to ``steps`` optimizer steps over ``data`` with beta and the
        learning rate from the schedules; the metrics are read from the
        device once, at the end. Returns the running mean loss per frame."""
        tcfg = self.tcfg
        steps = steps if steps is not None else tcfg.steps_per_epoch
        pending = []
        for _, batch in zip(range(steps), self.data):
            beta = self.beta_schedule(self.counter)
            if tcfg.scheduler_type == "linear":
                lr, self.stop = linear_lr(tcfg.learning_rate, self.counter,
                                          tcfg.linear_start_step,
                                          tcfg.linear_num_steps)
            else:
                lr = self.plateau.lr
            pending.append(self.train_step(batch, beta, lr))
            self.counter += 1
            if self.stop:
                break
        t = tcfg.n_frames - 1
        for m in pending:
            self.losses.append(float(m["loss"]) / t)
            self.kl_hist.append(float(m["kl"]) / t)
            self.recon_hist.append(float(m["nll"]) / t)
            self.bits_hist.append(float(m["bits"]))
        return float(np.mean(self.losses)) if self.losses else float("nan")

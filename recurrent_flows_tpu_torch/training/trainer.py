"""Training harness of the port, the counterpart of
``recurrent_flows_tpu.training.trainer``: ``Trainer.build`` (data-dependent
init on the first batch, Adam), ``train_step`` (preprocess -> ``model.loss``
-> backward -> optional global-norm clip -> Adam), ``train_epoch``,
``fit`` (epochs with the schedules, early stopping, checkpoints ``last``
and, after epoch 50, ``best``, ``status``, plots), ``checkpoint``/``load``
and ``refresh_stats`` (running statistics from a fresh batch).

    data = MovingMNIST(digit_size=32, seq_len=10, device="cuda")
    model = RFN(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, tcfg, data, "runs/rfn").build()
    trainer.fit(n_epochs=10)      # runs/rfn/{model_folder,png_folder}

Every family of ``models`` (RFN, SRNN, VRNN, SVG) takes the same calls;
with a preset: ``mcfg, tcfg = srnn_mnist()``, then ``SRNN(mcfg,
device="cuda")`` in place of the RFN. So does ``models.GlowImage`` (frames
taken as i.i.d. images; its plots are ``losses.png`` alone).

``data`` is either a generator with ``.sample(generator, batch_size)``
(the batch is made on the device, by the trainer's ``torch.Generator``) or
an iterable of batches [B,T,H,W,C] in [0, 1] (numpy arrays or tensors; a
tensor on the device stays there).

Data-parallel (``dp``, a ``parallel.DataParallel``; ``torchrun`` and the
CLIs' ``--multigpu``): ``tcfg.batch_size`` is the global batch. Rank 0
runs the one-process program: it draws every batch and the
data-dependent init, then sends each batch to all ranks
(``DataParallel.scatter``); every rank trains on its slice with noise of
its own. The batch norms of a step take the global batch's statistics,
the gradients and the logged metrics are averaged over the ranks
(``parallel/data_parallel.py``), and ``build`` broadcasts rank 0's
initialised model. Only rank 0 refreshes running statistics, plots and
writes files (folders, checkpoints, ``status.txt``, ``metrics.jsonl``).
One rank computes what one process computes, bit for bit.

A (data x model) grid (``dp`` a ``parallel.Mesh`` from ``make_mesh(n_data,
n_model)``, the counterpart of the JAX ``Trainer(..., mesh=...)``; no CLI
flag makes one, as none does in JAX) also shards frame height over
'model': each step takes this rank's rows of its batch slice
(``parallel.spatial_constraint``), the layers exchange halo rows and
gather where they must (``parallel/mesh.py``), every rank draws the global
noise from the one stream of rank 0 and keeps its part, and the
gradients and metrics are summed over 'model' and averaged over 'data'.
The step equals the one-process step to float32 rounding.

A step runs in full float32 with TF32 off, forward and backward
(``utils.float32_precision``), as the JAX package computes. It moves no
running statistic (they update only in ``build`` and ``refresh_stats``),
and Adam steps the parameters only, never the buffers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from ..flows.ddi import data_dependent_init
from ..models import split_reconstruction
from ..parallel.mesh import spatial_constraint
from ..utils.numerics import NoiseSource, float32_precision
from ..utils.profiling import StepTimer, span, trace
from ..utils.running_stats import has_running_stats
from .checkpoint import load_state, read_meta, save_checkpoint
from .schedules import BetaSchedule, EarlyStopping, PlateauScheduler, linear_lr


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


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator: ``seed`` on rank 0 (the
    one-process stream), another stream on every other rank."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence((seed, rank)).generate_state(1, np.uint64)[0] >> 1)


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
    kl_free_bits}`` on one device, writing under ``workdir`` (checkpoints,
    ``status.txt`` and ``metrics.jsonl`` in ``model_folder``, plots in
    ``png_folder``; only ``fit``, ``checkpoint``, ``load``, ``status`` and
    ``plotter`` need it).

    The noise of the loss and the generated batches come from one
    ``torch.Generator`` on the device, seeded with ``tcfg.seed`` (another
    seed on a data-parallel rank other than 0, ``rank_seed``); ``build``,
    ``train_step`` and ``plot_rows`` take a ``NoiseSource`` in its place
    (tests replay the JAX package's draws). ``dp`` makes the trainer one
    rank of a data-parallel group (module docstring).
    """

    def __init__(self, model, tcfg, data, workdir: str | None = None, device="cuda",
                 dp=None):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.tcfg = tcfg
        self.data = data
        self.workdir = workdir
        self.dp = dp
        self.losses: list = []
        self.kl_hist: list = []
        self.recon_hist: list = []
        self.bits_hist: list = []
        self.epoch_i = 0
        self.counter = 0  # optimizer steps taken, for the annealing
        self.plot_counter = 0
        self.best_loss = float("inf")
        self.stop = False
        self.beta_schedule = BetaSchedule(tcfg.beta_max, tcfg.beta_min,
                                          tcfg.beta_steps)
        self.plateau = PlateauScheduler(tcfg.learning_rate, tcfg.patience_lr,
                                        tcfg.factor_lr, tcfg.min_lr)
        self.early = EarlyStopping(tcfg.patience_es)
        self.step_timer = StepTimer()
        # data-parallel ranks draw their own slices from streams of their
        # own; a grid's ranks all draw the global noise from rank 0's
        own_stream = dp is not None and dp.n_model == 1
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(tcfg.seed, dp.rank if own_stream else 0))
        self.optimizer = None
        self._aux_iter = None

    @property
    def primary(self) -> bool:
        """This process writes the files (no group, or rank 0)."""
        return self.dp is None or self.dp.primary

    def _to_model_space(self, batch):
        t = self.tcfg
        if not isinstance(batch, torch.Tensor):
            batch = np.asarray(batch, np.float32)
        x = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        return preprocess(x, t.n_bits, t.preprocess_range, t.preprocess_scale)

    def _host_batch(self):
        """A batch for build, refresh_stats and the plots: a fresh one from a
        generator, else the next of a persistent iterator over ``data``,
        cycling."""
        if hasattr(self.data, "sample"):
            return self.data.sample(self.generator, self.tcfg.batch_size)
        if self._aux_iter is None:
            self._aux_iter = iter(self.data)
        try:
            return next(self._aux_iter)
        except StopIteration:
            self._aux_iter = iter(self.data)
            return next(self._aux_iter)

    def _folder(self, *parts) -> str:
        if self.workdir is None:
            raise ValueError("this Trainer has no workdir")
        return os.path.join(self.workdir, *parts)

    def build(self, run_ddi: bool = True, noise: NoiseSource | None = None):
        """Make ``workdir``'s folders; for RFN, on the first batch (TF32
        off): the running statistics the JAX package's ``model.init`` leaves
        (where the flow has BatchNormFlows: ``model.init_running_stats``),
        then the data-dependent init of the flow's ActNorms (in place); then
        the Adam optimizer. A model without ``ddi`` (SRNN, VRNN, SVG) takes
        no batch here: its ``init`` leaves running statistics at 0 and 1.
        Data-parallel, rank 0 initialises and every rank then takes its
        parameters and buffers."""
        if self.workdir is not None and self.primary:
            for sub in ("png_folder", "model_folder"):
                os.makedirs(self._folder(sub), exist_ok=True)
        glow = getattr(self.model.cfg, "glow", None)
        init_stats = (hasattr(self.model, "init_running_stats") and glow is not None
                      and glow.flow_norm == "batchnorm")
        run_ddi = run_ddi and hasattr(self.model, "ddi")
        if (init_stats or run_ddi) and self.primary:
            x = self._to_model_space(self._host_batch())
            noise = noise or NoiseSource(generator=self.generator)
            with float32_precision():
                if init_stats:
                    self.model.init_running_stats(x, noise)
                if run_ddi:
                    data_dependent_init(self.model, x, noise)
        if self.dp is not None:
            self.dp.broadcast_(self.model)
        self.optimizer = self._adam()
        return self

    def _adam(self):
        return torch.optim.Adam(self.model.parameters(), lr=self.tcfg.learning_rate)

    def train_step(self, batch, beta: float, lr: float,
                   noise: NoiseSource | None = None) -> dict:
        """One optimizer step on ``batch`` [B, T, H, W, C] in [0, 1] (this
        rank's slice of the global batch where data-parallel; on a grid,
        whole frames, of which the step takes this rank's rows; ``noise``
        then gives the global draws). Returns loss, kl, nll and bits (per
        dimension, of the global batch) as 0-d tensors on the device;
        reading them waits for the step."""
        tcfg, dp = self.tcfg, self.dp
        x = self._to_model_space(batch)
        dims, t = x.shape[2] * x.shape[3] * x.shape[4], x.shape[1] - 1
        noise = noise or NoiseSource(generator=self.generator)
        if dp is not None:
            x, noise = spatial_constraint(dp, x), dp.noise(noise)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        with float32_precision(), (dp.active() if dp is not None
                                   else contextlib.nullcontext()):
            with span("train.forward"):
                out = self.model.loss(x, noise)
                loss = out["nll"] + beta * out["kl_free_bits"]
            with span("train.backward"):
                loss.backward()
        if dp is not None:  # summed over 'model', averaged over 'data'
            with span("train.dp_reduce"):
                dp.reduce_grads_(p.grad for p in self.model.parameters() if p.grad is not None)
        if tcfg.grad_clip > 0:
            with span("train.clip"):
                clip_by_global_norm_([p.grad for p in self.model.parameters()
                                      if p.grad is not None], tcfg.grad_clip)
        with span("train.adam"):
            self.optimizer.step()
        metrics = dict(loss=loss.detach(), kl=out["kl"].detach(), nll=out["nll"].detach())
        if dp is not None:
            metrics = dp.reduce_metrics(metrics)
        metrics["bits"] = bits_per_dim(metrics["kl"], metrics["nll"], dims, t)
        return metrics

    def refresh_stats(self, noise: NoiseSource | None = None) -> None:
        """Update the running statistics (``model.stats_refresh``, TF32
        off) from a fresh batch, so that the sampling direction and
        ``eval_norm`` see trained statistics. Nothing to do for a model
        without running statistics."""
        if not has_running_stats(self.model):
            return
        x = self._to_model_space(self._host_batch())
        with float32_precision():
            self.model.stats_refresh(
                x, noise or NoiseSource(generator=self.generator))

    def train_epoch(self, steps: int | None = None, profile_dir: str | None = None) -> float:
        """Up to ``steps`` optimizer steps (a generator makes a batch per
        step; an iterable is read from its start and may end first) with
        beta and the learning rate from the schedules. The metrics are read
        from the device once, at the end; one step in 50 is also timed to
        the device's end (``step_timer``). With ``profile_dir`` the epoch
        runs under ``utils.profiling.trace``. Returns the running mean loss
        per frame."""
        with trace(profile_dir):
            return self._run_epoch(steps if steps is not None else self.tcfg.steps_per_epoch)

    def _run_epoch(self, steps: int) -> float:
        tcfg = self.tcfg
        generator = hasattr(self.data, "sample")
        it = None if generator or not self.primary else iter(self.data)
        pending = []
        t0 = time.perf_counter()
        for step_i in range(steps):
            time_this = step_i % 50 == 0
            if time_this:
                self.step_timer.start()
            batch = None
            if self.primary:  # data-parallel, rank 0 draws for every rank
                batch = (self.data.sample(self.generator, tcfg.batch_size) if generator
                         else next(it, None))
            if self.dp is not None:
                batch = self.dp.scatter(batch)
            if batch is None:
                break
            beta = self.beta_schedule(self.counter)
            if tcfg.scheduler_type == "linear":
                lr, self.stop = linear_lr(tcfg.learning_rate, self.counter,
                                          tcfg.linear_start_step,
                                          tcfg.linear_num_steps)
            else:
                lr = self.plateau.lr
            metrics = self.train_step(batch, beta, lr)
            if time_this:
                self.step_timer.stop(metrics["loss"])
            self.counter += 1
            pending.append(metrics)
            if self.stop:
                break
        if pending:
            fetched = [{k: float(v) for k, v in m.items()} for m in pending]
            self.step_timer.note_window(len(pending), time.perf_counter() - t0)
            t = tcfg.n_frames - 1
            for m in fetched:
                self.losses.append(m["loss"] / t)
                self.kl_hist.append(m["kl"] / t)
                self.recon_hist.append(m["nll"] / t)
                self.bits_hist.append(m["bits"])
        return float(np.mean(self.losses)) if self.losses else float("nan")

    def fit(self, n_epochs: int | None = None, plot: bool = True,
            plot_every: int = 1):
        """``n_epochs`` epochs (``tcfg.n_epochs``), as the JAX package's
        ``fit``: after each, the plots (a failure is printed, never
        raised), ``last`` every ``tcfg.checkpoint_every`` epochs, at the
        last epoch and on a stop, ``best`` from epoch 51 on, the plateau
        schedule and ``status`` (plots and files on rank 0 only where
        data-parallel)."""
        n_epochs = n_epochs if n_epochs is not None else self.tcfg.n_epochs
        for _ in range(n_epochs):
            self.epoch_i += 1
            epoch_loss = self.train_epoch()
            if plot and self.epoch_i % plot_every == 0 and self.primary:
                try:
                    self.plotter()
                except Exception as e:  # plotting must never kill training
                    print(f"plotter failed: {e!r}")
            ck_every = self.tcfg.checkpoint_every
            early_stop = self.early.step(epoch_loss)
            if (self.epoch_i % ck_every == 0 or self.epoch_i == n_epochs
                    or self.stop or early_stop):
                # an early stop on an off-cadence epoch still saves 'last'
                self.checkpoint("last")
            if early_stop or self.stop:
                break
            if self.early.best_loss < self.best_loss and self.epoch_i > 50:
                self.best_loss = self.early.best_loss
                self.checkpoint("best")
            if self.tcfg.scheduler_type == "plateau":
                self.plateau.step(epoch_loss)
            self.status(epoch_loss)
        return self

    # -- persistence ----------------------------------------------------------

    def checkpoint(self, name: str):
        """Save ``model_folder/<name>`` (``training.checkpoint``), the
        running statistics refreshed first so that the sampling direction
        of the saved model sees trained ones. A failed refresh raises and
        saves nothing: a checkpoint with stale statistics would be served
        with ``eval_norm`` as if they were trained. Data-parallel, only
        rank 0 refreshes and saves."""
        if not self.primary:
            return
        self.refresh_stats()
        cfg = getattr(self.model, "cfg", None)
        meta = dict(
            model_class=type(self.model).__name__,
            model_config=dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else None,
            train_config=dataclasses.asdict(self.tcfg),
            epoch=self.epoch_i,
            counter=self.counter,
            plot_counter=self.plot_counter,
            losses=self.losses[-10000:],
            kl_loss=self.kl_hist[-10000:],
            recon_loss=self.recon_hist[-10000:],
            bits_per_dim=self.bits_hist[-10000:],
            best_loss=self.best_loss,
            plateau_lr=self.plateau.lr,
        )
        save_checkpoint(self._folder("model_folder", name), self.model,
                        self.optimizer, self.counter, meta)

    def load(self, name: str = "last"):
        """Resume from ``model_folder/<name>``, a port checkpoint or a JAX
        one exported to npz: the model's parameters and buffers, Adam's
        state (made here if ``build`` was not called), the counters and the
        histories."""
        path = self._folder("model_folder", name)
        if self.optimizer is None:
            self.optimizer = self._adam()
        load_state(path, self.model, self.optimizer)
        meta = read_meta(path)
        self.epoch_i = meta["epoch"]
        self.counter = meta["counter"]
        self.plot_counter = meta["plot_counter"]
        self.losses = meta["losses"]
        self.kl_hist = meta["kl_loss"]
        self.recon_hist = meta["recon_loss"]
        self.bits_hist = meta["bits_per_dim"]
        self.best_loss = meta["best_loss"]
        self.plateau.lr = meta.get("plateau_lr", self.tcfg.learning_rate)
        return self

    def status(self, epoch_loss: float):
        """Append the epoch's record to ``metrics.jsonl`` and its line to
        ``status.txt``, with the JAX package's fields (rank 0 only)."""
        if not self.primary:
            return
        beta_now = self.beta_schedule(self.counter)
        last = lambda h: h[-1] if h else None
        rec = dict(epoch=self.epoch_i, loss=epoch_loss, kl=last(self.kl_hist),
                   nll=last(self.recon_hist), bits=last(self.bits_hist),
                   beta=beta_now, lr=self.plateau.lr, step=self.counter,
                   step_stats=self.step_timer.stats())
        with open(self._folder("model_folder", "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        nan = float("nan")
        kl, nll, bits = (nan if v is None else v for v in (rec["kl"], rec["nll"], rec["bits"]))
        with open(self._folder("model_folder", "status.txt"), "a") as f:
            f.write(f"epoch {self.epoch_i} loss {epoch_loss:.4f} "
                    f"kl {kl:.4f} nll {nll:.4f} "
                    f"bits {bits:.4f} beta {beta_now:.5f} "
                    f"lr {self.plateau.lr:.6f}\n")

    # -- plots ----------------------------------------------------------------

    def plot_rows(self, noise: NoiseSource | None = None) -> list:
        """The device part of the plots, on a fresh batch: (name, uint8
        frames [T, B, H, W, C]) for the batch itself, a free-running sample
        from its frame 0, the context followed by the prediction, the
        posterior reconstructions and, where ``reconstruct`` also returns
        it (RFN), the flow's x -> z -> x. Refreshes the running statistics
        first."""
        tcfg, model = self.tcfg, self.model
        self.refresh_stats()
        x = self._to_model_space(self._host_batch())
        noise = noise or NoiseSource(generator=self.generator)
        true_x, preds = model.predict(x, tcfg.n_predictions, tcfg.n_conditions, noise)
        recons, recons_flow = split_reconstruction(model.reconstruct(x, noise))
        samples = model.sample(x, x.shape[1], noise)

        def post(a):
            return preprocess(a, tcfg.n_bits, tcfg.preprocess_range,
                              tcfg.preprocess_scale, reverse=True).cpu().numpy()

        rows = [("true", post(x.transpose(0, 1))),
                ("sample|frame0", post(samples)),
                ("prediction", post(torch.cat([true_x, preds]))),
                ("recon", post(recons))]
        if recons_flow is not None:
            rows.append(("recon-bijection", post(recons_flow)))
        return rows

    def plotter(self):
        """``png_folder/losses.png`` (the four histories: bits per dim, loss,
        KL, NLL, as polylines) and ``samples<n>.png`` (the rows of
        ``plot_rows``, first sequence, up to 10 frames), drawn in numpy
        (``training.plots``) and written by ``data.png.write_png``. A model
        without ``predict`` (``GlowImage``) gets ``losses.png`` alone and
        leaves ``plot_counter`` as it is, as the JAX ``plotter`` does."""
        from ..data.png import write_png
        from .plots import frame_grid, loss_panel

        predicts = hasattr(type(self.model), "predict")
        rows = self.plot_rows() if predicts else None
        png = self._folder("png_folder")
        write_png(os.path.join(png, "losses.png"), loss_panel(
            [self.bits_hist, self.losses, self.kl_hist, self.recon_hist]))
        if not predicts:
            return
        write_png(os.path.join(png, f"samples{self.plot_counter}.png"), frame_grid(rows))
        self.plot_counter += 1

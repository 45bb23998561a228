"""Entry ``train``: the program's training step, ``Trainer.train_step``
(loss, backward, Adam), closed loop, back to back, on a pool of batches
made on the device from the seed and cycled.

Set-up builds the one trainer the window uses and drives it through the
first ``check_steps`` steps on distinct batches with the window's own call
and noise; what the check compares is read from them (each step's loss,
the first gradient from Adam's first moment after one step, each leaf's
change after the last). After the window the reference takes the same
steps from the same weights, batches and draws.
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, flops, harness, program, traffic, weights, yardstick
from benchmark.reference.common import Draws, precision, train_steps
from benchmark.seeds import derive
from benchmark.window import Window


class Entry:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.ref = harness.reference(cell)
        t = cell.traffic
        self.beta, self.lr, self.n_check = t["beta"], t["lr"], t["check_steps"]
        self.noise_seed = derive(seed, "noise")
        self.phases = program.Phases(device)
        self.i = 0

    def setup(self):
        from recurrent_flows_tpu_torch.training.trainer import Trainer

        cfg = self.cell.config
        self.model, self.tcfg = program.build(self.cell, self.seed, self.device, self.ref,
                                              self.phases)
        self.trainer = Trainer(self.model, self.tcfg, None, device=self.device).build(
            run_ddi=False)
        self.pool = traffic.pool(self.cell.traffic, cfg["model"], derive(self.seed, "traffic"),
                                 self.device)
        self.phases.mark("trainer and inputs")
        self.noise = program.noise(self.noise_seed, self.device)
        params = dict(self.model.named_parameters())
        start = {k: v.detach().clone() for k, v in params.items()}
        losses, grad = [], {}
        for i in range(self.n_check):
            losses.append(self.step()["loss"])
            self.phases.mark(f"check step {i + 1}", sync=True)
            if i == 0:
                beta1 = self.trainer.optimizer.param_groups[0]["betas"][0]
                state = self.trainer.optimizer.state
                grad = {k: float(state[p]["exp_avg"].norm()) / (1.0 - beta1)
                        for k, p in params.items() if p in state}
        change = {k: float((params[k].detach() - start[k]).norm()) for k in params}
        self.prog = dict(losses=[float(v) for v in losses], grad=grad, change=change)
        yardstick.sync(self.device)

    def step(self):
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        return self.trainer.train_step(batch, self.beta, self.lr, noise=self.noise)

    def window(self, seconds: float) -> Window:
        losses = []
        yardstick.sync(self.device)
        t0 = time.perf_counter()
        while not losses or time.perf_counter() - t0 < seconds:
            losses.append(self.step()["loss"])
        yardstick.sync(self.device)
        dt = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        t = self.cell.traffic
        self.window_result = Window(attempted=len(losses), failed=failed, seconds=dt,
                                    frames=len(losses) * t["batch"] * t["frames"],
                                    latencies=[])
        return self.window_result

    def traced(self, units: int):
        return yardstick.profile(self.step, units, self.window_result, self.cell, self.device)

    def release(self):
        del self.trainer, self.model, self.noise
        self.pool = self.pool[:self.n_check]

    def reference_steps(self, tf32: bool = False, fault=None) -> dict:
        """The reference's first steps from the seed's weights (with
        ``fault`` applied to its loss)."""
        cfg, tcfg = self.cell.config["model"], self.cell.config["train"]
        p = weights.make(self.ref, cfg, self.seed, self.device)
        learned = {k: p[k] for k in weights.learned_names(self.ref, cfg)}
        consts = {k: v for k, v in p.items() if k not in learned}
        loss = self.ref.loss if fault is None else fault(self.ref.loss)
        xs = [self.ref.train_inputs(cfg, tcfg, b) for b in self.pool[:self.n_check]]
        with precision(tf32):
            losses, grads, change = train_steps(
                lambda leaves, x, draws: loss({**consts, **leaves}, cfg, x, draws),
                learned, xs, self.beta, self.lr, Draws(self.noise_seed, self.device),
                tcfg["grad_clip"])
        return dict(losses=losses, grad=grads[0], change=change)

    def check(self) -> dict:
        self.ref_steps = self.reference_steps()
        numbers, self.where = compare.train_numbers(self.prog, self.ref_steps)
        return numbers

    def flops_per_unit(self) -> float:
        t = self.cell.traffic
        return flops.train_step(self.ref, self.cell.config["model"], t["batch"], t["frames"])

"""The system under test, as the benchmark builds it: the port's model of
a configuration file, its kernels built (into the port's own ``_build/``
in the checkout), and the benchmark's weights loaded into it. This module
and the entries are the only ones that import the port."""

from __future__ import annotations

import time

import torch

from . import weights, yardstick


class Phases:
    """Seconds of each part of the set-up, for the log."""

    def __init__(self, device):
        self.device, self.t, self.seconds = device, time.perf_counter(), []

    def mark(self, name: str, sync: bool = False):
        if sync:
            yardstick.sync(self.device)
        now = time.perf_counter()
        self.seconds.append((name, now - self.t))
        self.t = now


def build(cell, seed: int, device, ref, phases: Phases):
    """(model, train config) of ``cell``'s configuration on ``device``,
    holding the weights ``weights.make`` draws from ``seed``."""
    from recurrent_flows_tpu_torch import config as C, models

    phases.mark("imports of the program")
    if device.type == "cuda":
        from recurrent_flows_tpu_torch.ops import _build

        _build.build_all()
        phases.mark("kernels built or loaded")
    spec = cell.config
    mcfg = C.config_from_dict(getattr(C, spec["config_class"]), spec["model"])
    tcfg = C.config_from_dict(C.TrainConfig, spec["train"])
    model = getattr(models, spec["family"])(
        mcfg, remat=tcfg.remat, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    phases.mark("model built", sync=True)
    model.load_state_dict(weights.make(ref, spec["model"], seed, device), strict=True)
    phases.mark("weights drawn and loaded", sync=True)
    return model, tcfg


def noise(seed: int, device):
    """The program's noise source on a generator seeded ``seed``, the one
    ``reference.common.Draws(seed)`` replays."""
    from recurrent_flows_tpu_torch.utils.numerics import NoiseSource

    return NoiseSource(generator=torch.Generator(device=device).manual_seed(seed))

"""Serving path: a ``Predictor`` answers rollout requests on one device.

The counterpart of ``recurrent_flows_tpu.serving``:

    model = RFN(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, tcfg, n_conditions=5, n_predictions=10,
                     device="cuda")
    pred.warmup(batch_size=8)
    frames = pred.predict(context_frames)  # [B, n_pred, H, W, C] in [0,1]

The sampling noise comes from a ``torch.Generator`` on the device, seeded
once and advanced by every request. Requests run in full float32 with
TF32 off (``RFN.predict`` pins it). ``reconstruct``, ``sample``,
``from_checkpoint`` and ``export`` come later (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from .training.trainer import preprocess
from .utils.numerics import NoiseSource


class Predictor:
    """Fixed-configuration inference over a model on ``device`` (the
    card, unless the caller asks for the CPU)."""

    def __init__(self, model, tcfg, n_conditions: int = 5,
                 n_predictions: int = 10, temperature: float | None = None,
                 seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.tcfg = tcfg
        self.n_conditions = n_conditions
        self.n_predictions = n_predictions
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # -- data-space conversion ------------------------------------------------

    def _to_model_space(self, frames):
        t = self.tcfg
        x = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
        return preprocess(x, t.n_bits, t.preprocess_range, t.preprocess_scale)

    def _to_image_space(self, x):
        t = self.tcfg
        if t.preprocess_range == "0.5":
            x = x + 0.5
        elif t.preprocess_range == "minmax":
            x = (x + 1.0) * 0.5
        return torch.clamp(x, 0.0, 1.0).cpu().numpy()

    # -- public API ---------------------------------------------------------

    def warmup(self, batch_size: int, image_size: int | None = None,
               channels: int | None = None):
        """Run one request at the serving shape: builds and loads every
        kernel, so the first real request pays no build."""
        img = image_size or self.model.cfg.image_size
        c = channels or self.model.cfg.x_channels
        self.predict(np.zeros((batch_size, self.n_conditions, img, img, c),
                              np.float32))
        return self

    def predict(self, context_frames, noise: NoiseSource | None = None):
        """context [B, >=n_conditions, H, W, C] in [0,1] -> future frames
        [B, n_pred, H, W, C] in [0,1]. ``noise`` replaces the generator's
        draws (tests inject the JAX package's)."""
        x = self._to_model_space(context_frames[:, : self.n_conditions])
        if noise is None:
            noise = NoiseSource(generator=self.generator)
        _, preds = self.model.predict(x, self.n_predictions, self.n_conditions,
                                      noise, temperature=self.temperature)
        return self._to_image_space(preds.transpose(0, 1))

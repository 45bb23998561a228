"""Serving path: a ``Predictor`` answers requests on one device.

The counterpart of ``recurrent_flows_tpu.serving``:

    pred = Predictor.from_checkpoint("runs/rfn/model_folder/last",
                                     n_conditions=5, n_predictions=10)
    pred.warmup(batch_size=8)
    frames = pred.predict(context_frames)  # [B, n_pred, H, W, C] in [0,1]
    recons = pred.reconstruct(frames)      # [B, T-1, H, W, C]
    samples = pred.sample(frames[:, 0], 10)

or over a model in hand, ``Predictor(model, tcfg, device="cuda")``, of any
family (RFN, SRNN, VRNN, SVG). The sampling noise comes from a
``torch.Generator`` on the device, seeded once and advanced by every
request. Requests run in full float32 with TF32 off
(the model's methods pin it). ``export`` is not ported (ROADMAP.md queue
1, item 4b).
"""

from __future__ import annotations

import numpy as np
import torch

from .models import split_reconstruction
from .training.checkpoint import load_model_from_checkpoint
from .training.trainer import preprocess
from .utils.numerics import NoiseSource


class Predictor:
    """Fixed-configuration inference over a model on ``device`` (the
    card, unless the caller asks for the CPU). ``temperature`` replaces
    ``cfg.temperature`` on every endpoint where the config has one (RFN),
    and is ignored otherwise, as the JAX package does."""

    def __init__(self, model, tcfg, n_conditions: int = 5,
                 n_predictions: int = 10, temperature: float | None = None,
                 seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.tcfg = tcfg
        self.n_conditions = n_conditions
        self.n_predictions = n_predictions
        self.temperature = temperature
        # the endpoints' temperature argument, for a model that takes one
        self._temp = (dict(temperature=temperature) if hasattr(model.cfg, "temperature")
                      else {})
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, device="cuda", **kw) -> "Predictor":
        """A Predictor over the model of a checkpoint directory, the port's
        own (``state.pt``) or a JAX one exported to ``state.npz``, with
        ``meta.json`` beside it."""
        model, tcfg, _ = load_model_from_checkpoint(ckpt_dir, device=device)
        return cls(model, tcfg, device=device, **kw)

    # -- data-space conversion ------------------------------------------------

    def _to_model_space(self, frames):
        t = self.tcfg
        if not isinstance(frames, torch.Tensor):
            frames = np.asarray(frames, np.float32)
        x = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        return preprocess(x, t.n_bits, t.preprocess_range, t.preprocess_scale)

    def _to_image_space(self, x):
        t = self.tcfg
        if t.preprocess_range == "0.5":
            x = x + 0.5
        elif t.preprocess_range == "minmax":
            x = (x + 1.0) * 0.5
        return torch.clamp(x, 0.0, 1.0).cpu().numpy()

    def _noise(self, noise):
        return noise if noise is not None else NoiseSource(generator=self.generator)

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
        draws (tests inject the JAX package's), on every endpoint."""
        x = self._to_model_space(context_frames[:, : self.n_conditions])
        _, preds = self.model.predict(x, self.n_predictions, self.n_conditions,
                                      self._noise(noise), **self._temp)
        return self._to_image_space(preds.transpose(0, 1))

    def reconstruct(self, frames, noise: NoiseSource | None = None):
        """frames [B, T, H, W, C] in [0,1] -> posterior reconstructions of
        frames 1..T-1, [B, T-1, H, W, C] in [0,1]."""
        recons, _ = split_reconstruction(self.model.reconstruct(
            self._to_model_space(frames), self._noise(noise), **self._temp))
        return self._to_image_space(recons.transpose(0, 1))

    def sample(self, seed_frame, n_frames: int, noise: NoiseSource | None = None):
        """Free run from one frame: seed [B, H, W, C] in [0,1] -> [B,
        n_frames, H, W, C] in [0,1]."""
        x = self._to_model_space(seed_frame[:, None])
        samples = self.model.sample(x, n_frames, self._noise(noise), **self._temp)
        return self._to_image_space(samples.transpose(0, 1))

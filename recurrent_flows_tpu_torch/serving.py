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
(the model's methods pin it).

The deployment artifact (``Predictor.export``, ``load_exported``, the CLI
``python -m recurrent_flows_tpu_torch.cli.export_serving``):

    blob = pred.export("rfn.pt2", batch_size=8)
    serve = load_exported("rfn.pt2")        # or load_exported(blob)
    frames = serve(context_frames, seed=7)  # == Predictor(seed=7).predict(...)
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from . import ops  # noqa: F401  (registers the rft:: operators an artifact names)
from .models import split_reconstruction
from .training.checkpoint import load_model_from_checkpoint
from .training.trainer import preprocess
from .utils.numerics import NoiseSource, RecordingNoise, draw_list, float32_precision
from .utils.profiling import span

# the artifact's own record, stored beside the program
_META = "rft_serving.json"
# the names a device may be given by in ``export(platforms=...)``
_PLATFORMS = {"cuda": ("cuda", "gpu"), "cpu": ("cpu",)}


def to_image_space(x: torch.Tensor, tcfg) -> torch.Tensor:
    """Model space -> [0, 1], clipped (the inverse of ``preprocess``'s range)."""
    if tcfg.preprocess_range == "0.5":
        x = x + 0.5
    elif tcfg.preprocess_range == "minmax":
        x = (x + 1.0) * 0.5
    return torch.clamp(x, 0.0, 1.0)


class _ServeProgram(torch.nn.Module):
    """The exported request: (context [B, n_cond, H, W, C] in [0, 1],
    *draws) -> frames [B, n_pred, H, W, C] in [0, 1], the draws replayed
    in order into the model's ``predict``."""

    def __init__(self, pred: "Predictor"):
        super().__init__()
        self.model, self.tcfg, self.temp = pred.model, pred.tcfg, pred._temp
        self.n_conditions, self.n_predictions = pred.n_conditions, pred.n_predictions

    def forward(self, context, *draws):
        t = self.tcfg
        x = preprocess(context, t.n_bits, t.preprocess_range, t.preprocess_scale)
        _, preds = self.model.predict(x, self.n_predictions, self.n_conditions,
                                      NoiseSource(replay=draws), **self.temp)
        return to_image_space(preds.transpose(0, 1), t)


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
        return to_image_space(x, self.tcfg).cpu().numpy()

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
        with span("serve.to_model_space"):
            x = self._to_model_space(context_frames[:, : self.n_conditions])
        with span("serve.model"):
            _, preds = self.model.predict(x, self.n_predictions, self.n_conditions,
                                          self._noise(noise), **self._temp)
        with span("serve.to_image_space"):
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

    # -- deployment export ----------------------------------------------------

    def export(self, path: str | None = None, *, batch_size: int,
               image_size: int | None = None, channels: int | None = None,
               platforms=None) -> bytes:
        """Serialize the end-to-end predict program (image-space preprocess
        -> ``model.predict`` -> postprocess with the clip) to one
        ``torch.export`` artifact (``.pt2``), exported on ``self.device``
        with the weights in it, and return its bytes (written to ``path``
        too, where given). :func:`load_exported` serves it with no model
        code, config or checkpoint; the port's ``ops`` package must be
        importable where it is loaded, since the program calls the
        ``rft::`` kernel operators (``ops.library``), and loading raises
        where they are not registered.

        Noise: an exported graph carries no ``torch.Generator``, so the
        program takes ``(context [B, n_cond, H, W, C] float32 in [0, 1],
        *draws)``. The request's draw list (kind, shape, dtype, and the
        range of a uniform or integer draw) is recorded here on one eager
        request at this shape (``utils.numerics.RecordingNoise``) and
        stored in the artifact; ``load_exported``'s ``serve(context,
        seed)`` draws that list in order from
        ``torch.Generator(device).manual_seed(seed)`` through
        ``NoiseSource``'s own methods, so it draws what
        ``Predictor(seed=seed).predict`` draws on its first request, and
        runs the program with TF32 off (``float32_precision``), which an
        ATen graph does not record.

        ``platforms``: accepted for the JAX package's signature; any name
        other than this Predictor's device (``cuda``/``gpu`` on a card,
        ``cpu`` on the CPU) raises ``ValueError``.
        """
        kind = self.device.type
        for name in platforms or ():
            if name not in _PLATFORMS.get(kind, (kind,)):
                raise ValueError(f"export: platform {name!r}; this Predictor runs on "
                                 f"{kind} and exports for it only")
        img = image_size or self.model.cfg.image_size
        c = channels or self.model.cfg.x_channels
        context = torch.zeros((batch_size, self.n_conditions, img, img, c),
                              dtype=torch.float32, device=self.device)
        # the request's draws, recorded on one eager request at this shape
        recorder = RecordingNoise(torch.Generator(device=self.device).manual_seed(0))
        x = self._to_model_space(context)
        self.model.predict(x, self.n_predictions, self.n_conditions, recorder, **self._temp)
        with torch.no_grad():  # one flat graph: the request computes no gradient
            program = torch.export.export(_ServeProgram(self), (context, *recorder.tensors),
                                          strict=False)
        meta = dict(format=1, device=str(self.device), context_shape=list(context.shape),
                    n_conditions=self.n_conditions, n_predictions=self.n_predictions,
                    draws=recorder.draws)
        buf = io.BytesIO()
        torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
        blob = buf.getvalue()
        if path:
            with open(path, "wb") as f:
                f.write(blob)
        return blob


def load_exported(path_or_bytes):
    """A :meth:`Predictor.export` artifact (a path or its bytes) as
    ``serve(context, seed) -> frames``: context [B, n_cond, H, W, C] in [0,
    1] (numpy or a tensor) of the exported shape, frames [B, n_pred, H, W,
    C] in [0, 1], a float32 tensor on the artifact's device. Needs no model
    code, config or checkpoint, only the port's registered ``rft::``
    operators (this module imports ``ops``); the draws come from ``seed``
    as ``Predictor.export`` describes."""
    extra = {_META: ""}
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray)) \
        else path_or_bytes
    program = torch.export.load(src, extra_files=extra)
    if not extra[_META]:
        raise ValueError("not a Predictor.export artifact: it has no serving record")
    meta = json.loads(extra[_META])
    module, device = program.module(), torch.device(meta["device"])
    shape = tuple(meta["context_shape"])

    def serve(context, seed: int) -> torch.Tensor:
        if not isinstance(context, torch.Tensor):
            context = np.asarray(context, np.float32)
        ctx = torch.as_tensor(context, dtype=torch.float32, device=device)
        if tuple(ctx.shape) != shape:
            raise ValueError(f"load_exported: context of shape {tuple(ctx.shape)}; the "
                             f"artifact was exported for {shape}")
        draws = draw_list(meta["draws"], torch.Generator(device=device).manual_seed(int(seed)))
        with torch.no_grad(), float32_precision():
            return module(ctx, *draws)

    serve.meta, serve.program = meta, program
    return serve

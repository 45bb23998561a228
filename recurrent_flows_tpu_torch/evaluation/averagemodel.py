"""Linear autoregressive pixel baseline (the reference's "averagemodel"),
the counterpart of ``recurrent_flows_tpu.evaluation.averagemodel``: a
linear map of the conditioning frames and all their pairwise differences
predicts the next frame; a few Adam steps fit it; its rollout reports
SSIM/PSNR/MSE per step.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .metrics import eval_seq


def _features(cond):
    """[B, n_cond, H, W, C] -> the frames and their pairwise differences
    [B, F, H, W, C]."""
    n = cond.shape[1]
    diffs = [cond[:, i] - cond[:, j] for i, j in itertools.combinations(range(n), 2)]
    return torch.stack([cond[:, i] for i in range(n)] + diffs, 1)


class SimpleLinearModel:
    """Next frame = weighted sum of the features + bias, rolled out
    autoregressively; its weights on ``device`` (the card unless asked)."""

    def __init__(self, n_conditions: int = 5, device="cuda"):
        self.n_conditions = n_conditions
        self.device = torch.device(device)
        n_feat = n_conditions + n_conditions * (n_conditions - 1) // 2
        self.w = torch.zeros(n_feat, device=self.device)
        self.w[n_conditions - 1] = 1.0  # start as "copy the last frame"
        self.b = torch.zeros((), device=self.device)

    def predict_next(self, params, cond):
        w, b = params
        return torch.einsum("f,bfhwc->bhwc", w, _features(cond)) + b

    def rollout(self, params, cond, n_predictions: int):
        preds, window = [], cond
        for _ in range(n_predictions):
            nxt = torch.clamp(self.predict_next(params, window), 0.0, 1.0)
            preds.append(nxt)
            window = torch.cat([window[:, 1:], nxt[:, None]], 1)
        return torch.stack(preds, 1)

    def _batch(self, data, generator, batch_size):
        x = data.sample(generator, batch_size)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def fit(self, data, generator, steps: int = 200, batch_size: int = 16,
            lr: float = 1e-2) -> float:
        """``steps`` Adam steps on the next-frame MSE; returns the last
        step's loss (before its update)."""
        w = self.w.clone().requires_grad_(True)
        b = self.b.clone().requires_grad_(True)
        opt = torch.optim.Adam([w, b], lr=lr)
        nc = self.n_conditions
        for _ in range(steps):
            x = self._batch(data, generator, batch_size)
            loss = torch.mean(torch.square(self.predict_next((w, b), x[:, :nc]) - x[:, nc]))
            opt.zero_grad()
            loss.backward()
            opt.step()
        self.w, self.b = w.detach(), b.detach()
        return loss.item()

    def evaluate(self, data, generator, n_predictions: int = 10, batch_size: int = 16):
        """Per-step SSIM/PSNR/MSE of the linear rollout, means over the batch."""
        x = self._batch(data, generator, batch_size)
        nc = self.n_conditions
        with torch.no_grad():
            preds = self.rollout((self.w, self.b), x[:, :nc], n_predictions)
        res = eval_seq(x[:, nc: nc + n_predictions], preds)
        return {k: v.cpu().numpy().mean(0) for k, v in res.items()}

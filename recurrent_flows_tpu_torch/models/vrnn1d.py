"""VRNN-1D, the dense variational RNN on scalar sequences (noisy sinusoids),
the counterpart of ``recurrent_flows_tpu.models.vrnn1d``: a classic VRNN
with Dense feature nets, a ``DenseLSTMCell`` (gates i, f, g, o) and a
gaussian observation model on [B, T, 1].

Parameters keep the flax names (``lstm.gates``, ``phi_x.fc{0,1}``,
``phi_z.fc0``, ``prior``/``enc``/``dec`` with ``fc0``/``mean``/``std``,
``h_0``/``c_0``/``z_0x``), so ``convert.from_flax`` loads a JAX tree as it
is. Draws come from a ``NoiseSource``, in the JAX package's order:

* ``loss``: per step t = 1..T-1 the encoder's eps [B, z];
* ``predict``: per warm-up step the encoder's eps, then per predicted step
  the prior's eps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.dense_lstm import DenseLSTMCell
from ..nn.layers import Dense
from ..utils.numerics import (NoiseSource, batch_reduce, normal_kl, normal_log_prob,
                              normal_sample)


class _GaussianHead(nn.Module):
    """relu(fc0) -> (mean, softplus(std))."""

    def __init__(self, in_features: int, hidden: int, out: int, **kw):
        super().__init__()
        self.fc0 = Dense(in_features, hidden, **kw)
        self.mean = Dense(hidden, out, **kw)
        self.std = Dense(hidden, out, **kw)

    def forward(self, x):
        h = F.relu(self.fc0(x))
        return self.mean(h), F.softplus(self.std(h))


class _MLP(nn.Module):
    """relu(fc_i(x)) for each size in turn."""

    def __init__(self, in_features: int, sizes, **kw):
        super().__init__()
        self.n = len(sizes)
        for i, s in enumerate(sizes):
            self.add_module(f"fc{i}", Dense(in_features, s, **kw))
            in_features = s

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return x


class VRNN1D(nn.Module):
    """VRNN on [B, T, 1] sequences, on ``device`` (the card unless the
    caller asks for the CPU), its parameters drawn from ``generator`` (a
    CPU generator seeded 0 when None)."""

    def __init__(self, h_dim: int = 64, z_dim: int = 8, feat_dim: int = 32, *,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.h_dim, self.z_dim, self.feat_dim = h_dim, z_dim, feat_dim
        self.lstm = DenseLSTMCell(2 * feat_dim, h_dim, **kw)
        self.phi_x = _MLP(1, (feat_dim, feat_dim), **kw)
        self.phi_z = _MLP(z_dim, (feat_dim,), **kw)
        self.prior = _GaussianHead(h_dim, h_dim, z_dim, **kw)
        self.enc = _GaussianHead(h_dim + feat_dim, h_dim, z_dim, **kw)
        self.dec = _GaussianHead(h_dim + feat_dim, h_dim, 1, **kw)
        for name, dim in (("h_0", h_dim), ("c_0", h_dim), ("z_0x", z_dim)):
            self.register_parameter(name, nn.Parameter(torch.zeros((1, dim), device=device)))

    def _inits(self, b: int):
        return (self.h_0.expand(b, -1), self.c_0.expand(b, -1), self.z_0x.expand(b, -1))

    def _advance(self, h, c, x_prev, zx_prev):
        inp = torch.cat([self.phi_x(x_prev), self.phi_z(zx_prev)], -1)
        _, (h, c) = self.lstm(inp, (h, c))
        return h, c

    def loss(self, x, noise: NoiseSource) -> dict:
        """x [B, T, 1] -> {kl_free_bits, kl, nll}: the per-sequence sums over
        the steps, averaged over the batch; the decoder's std gets 1e-4."""
        b, t = x.shape[:2]
        h, c, zx = self._inits(b)
        kls, nll = [], 0.0
        for i in range(1, t):
            x_prev, x_t = x[:, i - 1], x[:, i]
            h, c = self._advance(h, c, x_prev, zx)
            pm, ps = self.prior(h)
            em, es = self.enc(torch.cat([h, self.phi_x(x_t)], -1))
            zx = normal_sample(em, es, noise.normal(em))
            dm, ds = self.dec(torch.cat([h, self.phi_z(zx)], -1))
            nll = nll - batch_reduce(normal_log_prob(x_t, dm, ds + 1e-4))
            kls.append(normal_kl(em, es, pm, ps))
        kl = batch_reduce(torch.stack(kls).sum(0)).mean()
        return dict(kl_free_bits=kl, kl=kl, nll=nll.mean())

    def predict(self, x, n_predictions: int, n_conditions: int, noise: NoiseSource):
        """Warm up on the first ``n_conditions`` steps with the posterior,
        then free-run the prior: (x's context [n_conditions, B, 1], the
        decoder means [n_predictions, B, 1])."""
        b = x.shape[0]
        h, c, zx = self._inits(b)
        for i in range(1, n_conditions):
            h, c = self._advance(h, c, x[:, i - 1], zx)
            em, es = self.enc(torch.cat([h, self.phi_x(x[:, i])], -1))
            zx = normal_sample(em, es, noise.normal(em))
        pred, preds = x[:, n_conditions - 1], []
        for _ in range(n_predictions):
            h, c = self._advance(h, c, pred, zx)
            pm, ps = self.prior(h)
            zx = normal_sample(pm, ps, noise.normal(pm))
            pred, _ = self.dec(torch.cat([h, self.phi_z(zx)], -1))
            preds.append(pred)
        return x[:, :n_conditions].transpose(0, 1), torch.stack(preds)

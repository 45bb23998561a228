"""Dense (vector) LSTM stacks of SVG, the counterparts of
``recurrent_flows_tpu.nn.dense_lstm``: embed -> n stacked LSTM cells ->
head, the state carried explicitly as a tuple of (h, c) per layer.

Every ``Dense`` keeps flax's kernel layout [in, out] and computes
``x @ kernel`` (``nn.layers.Dense``), so ``convert.from_flax`` copies the
kernels as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense


class DenseLSTMCell(nn.Module):
    """Plain LSTM cell: gates in the order (i, f, g, o) — not the
    ConvLSTM's (i, f, o, g) — from one fused ``gates`` Dense over [x | h]."""

    def __init__(self, in_features: int, hidden: int, *, device=None, generator=None):
        super().__init__()
        self.gates = Dense(in_features + hidden, 4 * hidden, device=device,
                           generator=generator)

    def forward(self, x, state):
        h, c = state
        i, f, g, o = torch.chunk(self.gates(torch.cat([x, h], -1)), 4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class _Stack(nn.Module):
    """``embed`` -> ``cell0`` ... ``cell{n-1}``."""

    def __init__(self, in_features: int, hidden: int, n_layers: int, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.hidden, self.n_layers = hidden, n_layers
        self.embed = Dense(in_features, hidden, **kw)
        for i in range(n_layers):
            self.add_module(f"cell{i}", DenseLSTMCell(hidden, hidden, **kw))

    def init_state(self, batch: int, device=None):
        z = torch.zeros((batch, self.hidden), device=device)
        return tuple((z, z) for _ in range(self.n_layers))

    def _run(self, x, state):
        h_in = self.embed(x)
        new_state = []
        for i, s in enumerate(state):
            h_in, s2 = getattr(self, f"cell{i}")(h_in, s)
            new_state.append(s2)
        return h_in, tuple(new_state)


class SVGLSTM(_Stack):
    """embed -> n_layers LSTM -> ``out`` Dense + tanh (the frame predictor)."""

    def __init__(self, in_features: int, output_size: int, hidden: int, n_layers: int,
                 *, device=None, generator=None):
        super().__init__(in_features, hidden, n_layers, device=device,
                         generator=generator)
        self.out = Dense(hidden, output_size, device=device, generator=generator)

    def forward(self, x, state):
        h, state = self._run(x, state)
        return torch.tanh(self.out(h)), state


class SVGGaussianLSTM(_Stack):
    """embed -> n_layers LSTM -> (``mu``, softplus ``std``) and the
    reparameterized z = mu + std·eps.

    ``std`` is used as a standard deviation, the JAX package's documented
    deviation from the reference (which reparameterizes it as a
    log-variance). ``forward(x, state, eps)`` returns (z, mu, std, state);
    without ``eps`` it draws nothing and z is None, where the JAX package
    draws a z that its caller drops.
    """

    def __init__(self, in_features: int, output_size: int, hidden: int, n_layers: int,
                 *, device=None, generator=None):
        super().__init__(in_features, hidden, n_layers, device=device,
                         generator=generator)
        self.mu = Dense(hidden, output_size, device=device, generator=generator)
        self.std = Dense(hidden, output_size, device=device, generator=generator)

    def forward(self, x, state, eps=None):
        h, state = self._run(x, state)
        mu, std = self.mu(h), F.softplus(self.std(h))
        z = mu + std * eps if eps is not None else None
        return z, mu, std, state

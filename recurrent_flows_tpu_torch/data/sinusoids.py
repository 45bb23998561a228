"""Noisy sinusoid sequences made on the device (the VRNN-1D workload), the
counterpart of ``recurrent_flows_tpu.data.sinusoids``: phase-randomised
sinusoids with gaussian observation noise, [B, T, 1].

The draws go through a ``NoiseSource`` in the order the JAX package splits
its key (k1, k2, k3): the phase, the frequency's uniform, the noise. Given
the JAX package's draws replayed, the sequences equal its own within the
float32 rounding of ``sin`` (the tests hold 1e-5·(1+|ref|)).
"""

from __future__ import annotations

import math

import torch

from ..utils.numerics import NoiseSource


def sample_sinusoids(draws: NoiseSource, *, seq_len: int = 100, batch_size: int = 32,
                     freq: float = 0.06, noise: float = 0.1, device="cuda"):
    """[B, T, 1] on ``device``: sin(2π·f·t + φ) + noise·ε with, in this
    order of draws, φ ~ U[0, 2π) [B, 1], f = freq·(1 + 0.5·u), u ~ U[0, 1)
    [B, 1], and ε ~ N(0, 1) [B, T]."""
    dev = torch.device(device)
    col = torch.empty((batch_size, 1), device=dev)
    phase = draws.uniform(col, 0.0, 2 * math.pi)
    f = freq * (1.0 + 0.5 * draws.uniform(col, 0.0, 1.0))
    t = torch.arange(seq_len, dtype=torch.float32, device=dev)[None, :]
    x = torch.sin(2 * math.pi * f * t + phase)
    x = x + noise * draws.normal(torch.empty((batch_size, seq_len), device=dev))
    return x[..., None]


class SinusWithNoise:
    """Sampler facade: ``sample(generator, batch_size)`` draws with
    ``generator``, a ``torch.Generator`` of ``device``."""

    def __init__(self, seq_len: int = 100, freq: float = 0.06, noise: float = 0.1,
                 device="cuda"):
        self.seq_len, self.freq, self.noise = seq_len, freq, noise
        self.device = torch.device(device)

    def sample(self, generator: torch.Generator, batch_size: int):
        return sample_sinusoids(NoiseSource(generator=generator), seq_len=self.seq_len,
                                batch_size=batch_size, freq=self.freq, noise=self.noise,
                                device=self.device)

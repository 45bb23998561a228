"""Two-moons samples and the rotating two-moons conditional sampler, made
on the device, the counterparts of ``recurrent_flows_tpu.data.halfmoon``:
two-moons rotated by an angle θ ~ U[0, 2π), the covariate of the
conditional RealNVP.

The draws go through a ``NoiseSource`` in the order the JAX package splits
its keys (each function's docstring lists it). Given the JAX package's
draws replayed, the points equal its own within the float32 rounding of
``cos``/``sin`` (the tests hold 1e-5·(1+|ref|)).
"""

from __future__ import annotations

import math

import torch

from ..utils.numerics import NoiseSource

CENTRE = (0.5, 0.25)  # subtracted, as the reference notebooks centre sklearn's moons


def _moons(t_out, t_in, eps, noise: float):
    """[..., n_out + n_in, 2]: the outer arc at angles t_out, the shifted
    inner arc at t_in, plus noise·eps, centred."""
    outer = torch.stack([torch.cos(t_out), torch.sin(t_out)], -1)
    inner = torch.stack([1.0 - torch.cos(t_in), 0.5 - torch.sin(t_in)], -1)
    x = torch.cat([outer, inner], -2) + noise * eps
    return x - torch.tensor(CENTRE, device=x.device)


def two_moons(draws: NoiseSource, n: int, noise: float = 0.05, device="cuda"):
    """[n, 2] on ``device``: n // 2 points of the outer arc, the rest of the
    inner one. Draws, in order (JAX's k1, k2, k3): the outer angles
    U[0, π) [n//2], the inner angles U[0, π) [n - n//2], ε ~ N(0, 1) [n, 2]."""
    dev = torch.device(device)
    n_out = n // 2
    t_out = draws.uniform(torch.empty(n_out, device=dev), 0.0, math.pi)
    t_in = draws.uniform(torch.empty(n - n_out, device=dev), 0.0, math.pi)
    eps = draws.normal(torch.empty((n, 2), device=dev))
    return _moons(t_out, t_in, eps, noise)


def _rotate(x, theta):
    """x [..., n, 2] rotated by theta (a scalar, or one angle [...] per
    leading index): x @ R(θ)ᵀ."""
    theta = torch.as_tensor(theta, dtype=x.dtype, device=x.device)
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    return x @ rot.transpose(-1, -2)


class RotatingTwoMoonsConditionalSampler:
    """``conditioned_sample(draws, n, theta)``, ``joint_sample(draws, n)`` and
    ``loader(draws, batch_size, n_batches)`` on ``device``; ``draws`` is a
    ``NoiseSource``."""

    def __init__(self, noise: float = 0.05, device="cuda"):
        self.noise = noise
        self.device = torch.device(device)

    def conditioned_sample(self, draws: NoiseSource, n: int, theta):
        """``two_moons`` (its draws) rotated by ``theta``: [n, 2]."""
        return _rotate(two_moons(draws, n, self.noise, self.device), theta)

    def joint_sample(self, draws: NoiseSource, n: int):
        """(x [n, 2], θ): θ ~ U[0, 2π) drawn first (JAX's k1), then
        ``conditioned_sample``'s draws (k2)."""
        theta = draws.uniform(torch.empty((), device=self.device), 0.0, 2 * math.pi)
        return self.conditioned_sample(draws, n, theta), theta

    def loader(self, draws: NoiseSource, batch_size: int, n_batches: int):
        """``n_batches`` pairs (x [B, 2], θ [B, 1]), each row one point of
        moons rotated by its own angle. Draws per batch, in order: the
        angles U[0, 2π) [B]; the rows' inner-arc angles U[0, π) [B] (a
        one-point sample has no outer point); their ε [B, 2] (JAX draws
        row b's angle and ε from its b-th split key, k2 and k3)."""
        dev = self.device
        for _ in range(n_batches):
            thetas = draws.uniform(torch.empty(batch_size, device=dev), 0.0, 2 * math.pi)
            t_in = draws.uniform(torch.empty((batch_size, 1), device=dev), 0.0, math.pi)
            eps = draws.normal(torch.empty((batch_size, 1, 2), device=dev))
            x = _moons(t_in[:, :0], t_in, eps, self.noise)
            yield _rotate(x, thetas)[:, 0], thetas[:, None]

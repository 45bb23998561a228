"""Numeric helpers (NHWC, channels last), the counterparts of
``recurrent_flows_tpu.utils.numerics``."""

from __future__ import annotations

import contextlib
import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@contextlib.contextmanager
def float32_precision():
    """Run CUDA matmuls and cuDNN convolutions in full float32 (TF32 off,
    which cuDNN turns on by default), as the JAX package computes; the
    caller's settings are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def split_feature(x: torch.Tensor, kind: str = "split"):
    """Split the channel (last) axis: ``'split'`` = contiguous halves,
    ``'cross'`` = evens then odds."""
    c = x.shape[-1]
    if kind == "split":
        return x[..., : c // 2], x[..., c // 2:]
    if kind == "cross":
        return x[..., 0::2], x[..., 1::2]
    raise ValueError(f"unknown split kind: {kind}")


def batch_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum over everything but the leading (batch) axis -> [B]."""
    return x.reshape(x.shape[0], -1).sum(-1)


def normal_log_prob(x, mean, std):
    """log N(x; mean, std), elementwise."""
    return -0.5 * torch.square((x - mean) / std) - torch.log(std) - _LOG_SQRT_2PI


def normal_kl(mean_q, std_q, mean_p, std_p):
    """KL(N(mean_q, std_q) || N(mean_p, std_p)), elementwise."""
    var_ratio = torch.square(std_q / std_p)
    t1 = torch.square((mean_q - mean_p) / std_p)
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def free_bits_kl(kl, free_bits: float = 0.0, eps: float = 1e-6):
    """Elementwise floor of the KL at ``free_bits`` (off below ``eps``)."""
    if free_bits < eps:
        return kl
    return torch.clamp(kl, min=free_bits)


def normal_sample(mean: torch.Tensor, std: torch.Tensor,
                  eps: torch.Tensor) -> torch.Tensor:
    """Reparameterized draw from N(mean, std) with an explicit eps."""
    return mean + std * eps


def squeeze2d(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth [B,H,W,C] -> [B,H/2,W/2,4C], channel order
    (c, dy, dx) with c slowest."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, c * 4)


def unsqueeze2d(x: torch.Tensor) -> torch.Tensor:
    """Depth-to-space inverse of :func:`squeeze2d`."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, c // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * 2, w * 2, c // 4)


class NoiseSource:
    """Standard-normal (and uniform) draws, taken in call order.

    Either fresh from a ``torch.Generator`` on the model's device, or
    replayed from a sequence of arrays (so a test can inject the exact
    draws the JAX package makes from its keys; the two frameworks cannot
    share a PRNG). A replayed draw must have the requested shape.
    """

    def __init__(self, generator: torch.Generator | None = None,
                 replay=None):
        if (generator is None) == (replay is None):
            raise ValueError("give exactly one of generator / replay")
        self.generator = generator
        self._replay = iter(replay) if replay is not None else None

    def normal(self, like: torch.Tensor) -> torch.Tensor:
        if self._replay is None:
            return torch.randn(like.shape, generator=self.generator,
                               device=like.device, dtype=like.dtype)
        return self._next(like)

    def uniform(self, like: torch.Tensor, low: float, high: float) -> torch.Tensor:
        """U[low, high) of ``like``'s shape (a replayed draw is taken as it is)."""
        if self._replay is None:
            u = torch.rand(like.shape, generator=self.generator,
                           device=like.device, dtype=like.dtype)
            return low + (high - low) * u
        return self._next(like)

    def _next(self, like: torch.Tensor) -> torch.Tensor:
        try:
            eps = next(self._replay)
        except StopIteration:
            raise ValueError("replayed noise ran out") from None
        if isinstance(eps, torch.Tensor):
            eps = eps.to(dtype=like.dtype, device=like.device)
        else:
            eps = torch.tensor(eps, dtype=like.dtype, device=like.device)
        if tuple(eps.shape) != tuple(like.shape):
            raise ValueError(f"replayed noise has shape {tuple(eps.shape)}, "
                             f"the draw needs {tuple(like.shape)}")
        return eps

    def exhausted(self) -> bool:
        """True when a replay has no draw left (always True for a generator)."""
        if self._replay is None:
            return True
        return next(self._replay, None) is None

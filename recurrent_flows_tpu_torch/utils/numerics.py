"""Numeric helpers (NHWC, channels last), the counterparts of
``recurrent_flows_tpu.utils.numerics``."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..parallel.mesh import grid, own_rows

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


def pad_same(x: torch.Tensor, kernel, stride, value: float = 0.0) -> torch.Tensor:
    """Pad the last ``len(kernel)`` axes of a channels-first x as
    TensorFlow's (and ``lax``'s) SAME padding does: per axis of size n a
    total of max((ceil(n/s)-1)·s + k - n, 0), the odd element at the end
    (PyTorch's own ``padding='same'`` is symmetric and takes no stride).
    Convolve or pool the result with no padding; a max-pool pads with
    -inf."""
    pads = []
    for n, k, s in zip(reversed(x.shape[-len(kernel):]), reversed(kernel), reversed(stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


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
    """Sum over everything but the leading (batch) axis -> [B]; on a grid,
    this rank's share of the sum over the whole map
    (``parallel.mesh.Mesh.share``)."""
    s = x.reshape(x.shape[0], -1).sum(-1)
    g = grid()
    return s if g is None else g.share(s, x)


def expand_to_batch(p: torch.Tensor, batch: int) -> torch.Tensor:
    """A learned [1, ...] state broadcast to ``batch``; on a grid, of a
    map, this rank's rows (``parallel.mesh.own_rows``)."""
    p = own_rows(p)
    return p.expand((batch,) + p.shape[1:])


def pixel_share(x: torch.Tensor):
    """H·W of a map [B, H, W, C]; on a grid this rank's share of the whole
    map's H·W (a float where the map is replicated)."""
    n = x.shape[1] * x.shape[2]
    g = grid()
    return n if g is None else g.share(n, x)


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
    (c, dy, dx) with c slowest. On a grid, of its own rows where their
    count is even, else of the gathered frame."""
    g = grid()
    if g is not None:
        x = g.reshard(x)
        if g.sharded(x) and x.shape[1] % 2:
            x = g.gather(x)
        return g.reshard(_squeeze(x))
    return _squeeze(x)


def _squeeze(x):
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, c * 4)


def unsqueeze2d(x: torch.Tensor) -> torch.Tensor:
    """Depth-to-space inverse of :func:`squeeze2d` (own rows on a grid)."""
    g = grid()
    if g is not None:
        x = g.reshard(x)
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, c // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    x = x.reshape(b, h * 2, w * 2, c // 4)
    return x if g is None else g.reshard(x)


class NoiseSource:
    """Standard-normal, uniform and integer draws, taken in call order.

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

    def randint(self, low: int, high: int, shape, device) -> torch.Tensor:
        """Integers uniform in [low, high), int64, of ``shape`` on ``device``."""
        if self._replay is None:
            return torch.randint(low, high, tuple(shape), generator=self.generator,
                                 device=device)
        return self._next(torch.empty(tuple(shape), dtype=torch.int64, device=device))

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


class RecordingNoise(NoiseSource):
    """A generator's draws, as :class:`NoiseSource` takes them, each also
    logged in ``draws`` by kind, shape and dtype (``uniform`` with its
    ``low`` and ``high``, ``randint`` with its range), with the drawn
    tensors in ``tensors``. :func:`draw_list` takes the same list again
    from a generator."""

    def __init__(self, generator: torch.Generator):
        super().__init__(generator=generator)
        self.draws, self.tensors = [], []

    def _log(self, out: torch.Tensor, kind: str, **rng) -> torch.Tensor:
        self.draws.append(dict(kind=kind, shape=list(out.shape),
                               dtype=str(out.dtype).removeprefix("torch."), **rng))
        self.tensors.append(out)
        return out

    def normal(self, like: torch.Tensor) -> torch.Tensor:
        return self._log(super().normal(like), "normal")

    def uniform(self, like: torch.Tensor, low: float, high: float) -> torch.Tensor:
        return self._log(super().uniform(like, low, high), "uniform",
                         low=float(low), high=float(high))

    def randint(self, low: int, high: int, shape, device) -> torch.Tensor:
        return self._log(super().randint(low, high, shape, device), "randint",
                         low=int(low), high=int(high))


def draw_list(draws, generator: torch.Generator) -> list:
    """The draws a :class:`RecordingNoise` logged (``draws``), taken anew in
    order from ``generator`` through :class:`NoiseSource`'s own methods, on
    its device: the values a ``NoiseSource(generator=generator)`` gives a
    caller that asks for the same draws."""
    src, device, out = NoiseSource(generator=generator), generator.device, []
    for d in draws:
        shape, dtype = tuple(d["shape"]), getattr(torch, d["dtype"])
        if d["kind"] == "randint":
            out.append(src.randint(d["low"], d["high"], shape, device))
            continue
        like = torch.empty(shape, dtype=dtype, device=device)
        if d["kind"] == "normal":
            out.append(src.normal(like))
        elif d["kind"] == "uniform":
            out.append(src.uniform(like, d["low"], d["high"]))
        else:
            raise ValueError(f"unknown kind of draw: {d['kind']!r}")
    return out

"""Stochastic Moving MNIST made on the device, the counterpart of
``recurrent_flows_tpu.data.moving_mnist``.

The batch is drawn and rendered where the digit bank lives (the card,
unless the caller asks for the CPU), with ``torch.randint`` on a
``torch.Generator`` of that device: no host loop over samples and no copy
to the device. Motion follows the JAX package (which follows the
reference's ``stochasticMovingMnist.py:48-127``): per digit a random start
in [0, image_size - digit_size) and a velocity in U{-step..step}; at a
wall the position is clamped and, in stochastic mode, a fresh velocity
pointing away from the wall is drawn, the y axis before the x axis, each
axis redrawing both components; overlapping digits are summed and clipped
at 1.

The integer draws go through a ``NoiseSource``, so a test can replay the
JAX package's and get its frames and ``hit_boundary`` exactly. The port's
own draws differ from JAX's: ``seed=`` and ``synchronized=`` keep their
meaning (a fixed stream on every call; synchronized is seed 12) with
another stream than JAX's keys.

Digit bank: real MNIST (IDX files or ``mnist.npz``, parsed with numpy)
where present, sklearn's 8x8 digits on request, otherwise a procedural
bank of digit-like stroke sprites (deterministic per seed).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.numerics import NoiseSource


# --------------------------------------------------------------------------
# Digit banks
# --------------------------------------------------------------------------


def load_mnist_digits(data_root: str, train: bool = True) -> Optional[np.ndarray]:
    """Parse real MNIST ([N,28,28] float32 in [0,1]) if present on disk.

    Looks for ``{train,t10k}-images-idx3-ubyte[.gz]`` under ``data_root``
    (including the torchvision-style ``MNIST/raw`` subdir) or a Keras-style
    ``mnist.npz``. Returns None when absent.
    """
    stem = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    candidates = [
        os.path.join(data_root, stem),
        os.path.join(data_root, stem + ".gz"),
        os.path.join(data_root, "MNIST", "raw", stem),
        os.path.join(data_root, "MNIST", "raw", stem + ".gz"),
    ]
    for path in candidates:
        if not os.path.exists(path):
            continue
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad IDX magic in {path}")
            data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        return data.reshape(n, rows, cols).astype(np.float32) / 255.0
    npz = os.path.join(data_root, "mnist.npz")
    if os.path.exists(npz):
        with np.load(npz) as data:
            arr = data["x_train" if train else "x_test"]
        return np.asarray(arr, np.float32) / 255.0
    return None


def sklearn_digit_bank(train: bool = True) -> Optional[np.ndarray]:
    """Real handwritten digits from sklearn's bundled UCI set (8x8, 1797):
    not MNIST, but real pen strokes, available offline. None without
    scikit-learn."""
    try:
        from sklearn.datasets import load_digits
    except ImportError:
        return None
    images = load_digits().images.astype(np.float32) / 16.0
    split = int(len(images) * 0.9)
    return images[:split] if train else images[split:]


def synthetic_digit_bank(seed: int = 0, n: int = 512, size: int = 28) -> np.ndarray:
    """Procedural digit-like sprites: a few blurred strokes per glyph.

    Deterministic fallback when no MNIST files are on disk; statistically
    digit-shaped (sparse bright strokes on black) which is what the models
    care about.
    """
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    bank = np.zeros((n, size, size), np.float32)
    for i in range(n):
        img = np.zeros((size, size), np.float32)
        n_strokes = rng.randint(2, 5)
        pts = rng.uniform(size * 0.15, size * 0.85, size=(n_strokes + 1, 2))
        for a, b in zip(pts[:-1], pts[1:]):
            for t in np.linspace(0.0, 1.0, 24):
                cy, cx = a * (1 - t) + b * t
                img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.3 ** 2))
        img = np.clip(img / max(img.max(), 1e-6) * 1.4, 0.0, 1.0)
        bank[i] = img
    return bank


def _resize_bank(bank: np.ndarray, digit_size: int) -> np.ndarray:
    """Bilinear resize of [N, s, s] to [N, digit_size, digit_size] as
    ``jax.image.resize(..., 'bilinear')`` computes it: half-pixel centres,
    the triangle kernel renormalised at the edges and widened (antialiased)
    when shrinking."""
    if bank.shape[-1] == digit_size:
        return bank
    out = F.interpolate(torch.as_tensor(bank)[:, None], (digit_size, digit_size),
                        mode="bilinear", align_corners=False, antialias=True)
    return out[:, 0].numpy()


# --------------------------------------------------------------------------
# The sampler
# --------------------------------------------------------------------------


def _axis_bounce(pos, vel_this, vel_other, limit, fresh):
    """One axis' wall handling (reference :79-107): clamp the position; the
    velocity along the axis reverses (``fresh`` None: deterministic) or is
    redrawn away from the wall together with the other component
    (``fresh`` = (toward +, toward -, other) draws)."""
    below = pos < 0
    above = pos >= limit
    hit = below | above
    if fresh is None:
        new_this = torch.where(hit, -vel_this, vel_this)
        new_other = vel_other
    else:
        fresh_pos, fresh_neg, fresh_other = fresh
        new_this = torch.where(below, fresh_pos, torch.where(above, fresh_neg, vel_this))
        new_other = torch.where(hit, fresh_other, vel_other)
    new_pos = pos.clamp(0, limit - 1)
    return new_pos, new_this, new_other, hit


def sample_moving_mnist(draws: NoiseSource, digits: torch.Tensor, *, seq_len: int,
                        image_size: int, num_digits: int, step_length: int,
                        deterministic: bool, batch_size: int, fixed_start=None):
    """A batch from the bank ``digits`` [N, ds, ds] on its device: (frames
    [B,T,H,W,1] in [0,1], hit_boundary [B,T] bool: some digit met a wall).

    ``draws`` gives the integers, in this order: the digit of each slot
    [B, n] in [0, N); the start x, then y, [B, n] in [0, H - ds) (none with
    ``fixed_start`` (x, y)); the velocity x, then y, [B, n] in
    [-step, step]; in stochastic mode, for the y axis and then the x axis,
    [T, B, n] draws of the velocity toward + ([1, step]), toward -
    ([-step, -1]) and of the other component ([-step, step]).
    """
    n_bank, ds, _ = digits.shape
    limit = image_size - ds
    if limit < 1:
        raise ValueError(f"digit_size {ds} leaves no room in image_size {image_size}")
    dev, s = digits.device, step_length
    shape = (batch_size, num_digits)
    idx = draws.randint(0, n_bank, shape, dev)
    if fixed_start is not None:
        sx = torch.full(shape, fixed_start[0], dtype=torch.int64, device=dev)
        sy = torch.full(shape, fixed_start[1], dtype=torch.int64, device=dev)
    else:
        sx = draws.randint(0, limit, shape, dev)
        sy = draws.randint(0, limit, shape, dev)
    dx = draws.randint(-s, s + 1, shape, dev)
    dy = draws.randint(-s, s + 1, shape, dev)
    fresh_y = fresh_x = [None] * seq_len
    if not deterministic:
        tshape = (seq_len,) + shape
        fresh_y, fresh_x = (list(zip(*(draws.randint(lo, hi, tshape, dev)
                                       for lo, hi in ((1, s + 1), (-s, 0), (-s, s + 1)))))
                            for _ in range(2))
    pos_y, pos_x, hits = [], [], []
    for t in range(seq_len):
        sy, dy, dx, hit_y = _axis_bounce(sy, dy, dx, limit, fresh_y[t])
        sx, dx, dy, hit_x = _axis_bounce(sx, dx, dy, limit, fresh_x[t])
        pos_y.append(sy)
        pos_x.append(sx)
        hits.append((hit_y | hit_x).any(-1))
        sx, sy = sx + dx, sy + dy
    # one index-put of all [T, B, n] sprites, each into its own canvas
    py, px = torch.stack(pos_y), torch.stack(pos_x)  # [T, B, n]
    ar = torch.arange(ds, device=dev)
    rows = py[..., None, None] + ar[:, None]
    cols = px[..., None, None] + ar[None, :]
    t_i, b_i, d_i = (torch.arange(k, device=dev).reshape(
        [-1 if j == i else 1 for j in range(5)]) for i, k in enumerate(
        (seq_len, batch_size, num_digits)))
    canvases = torch.zeros((seq_len, batch_size, num_digits, image_size, image_size),
                           dtype=digits.dtype, device=dev)
    sprites = digits[idx]
    # XLA computes with subnormals as 0, so the JAX package's sums see the
    # bank's subnormal values (the synthetic strokes' tails) as 0
    sprites = torch.where(sprites >= torch.finfo(sprites.dtype).tiny, sprites, 0.0)
    canvases[t_i, b_i, d_i, rows, cols] = sprites.expand((seq_len,) + shape + (ds, ds))
    frames = canvases.sum(2).clamp(0.0, 1.0)
    return frames.transpose(0, 1)[..., None], torch.stack(hits).transpose(0, 1)


class MovingMNIST:
    """Batch sampler facade (reference MovingMNIST / MovingMNIST_synchronized),
    its bank on ``device``.

    ``sample(generator, batch_size)`` draws with ``generator``, a
    ``torch.Generator`` of that device (``Trainer`` passes its own).
    ``seed`` fixes the stream of every call; ``synchronized=True`` fixes it
    too (seed 12) and returns the ``hit_boundary`` side channel used by the
    parameter-analysis plots.
    """

    def __init__(
        self,
        train: bool = True,
        data_root: str = "./mnist_data",
        seq_len: int = 20,
        num_digits: int = 2,
        image_size: int = 64,
        digit_size: int = 28,
        deterministic: bool = False,
        three_channels: bool = False,
        step_length: int = 4,
        normalize: bool = False,
        make_target: bool = False,
        synchronized: bool = False,
        set_starting_position: bool = False,
        seed: Optional[int] = None,
        digit_bank: str = "auto",
        device="cuda",
    ):
        bank, kind = self._load_bank(digit_bank, data_root, train)
        self.bank_kind = kind  # what the batches are made of, for any reported result
        self.device = torch.device(device)
        self.digits = torch.as_tensor(_resize_bank(bank, digit_size), device=self.device)
        self.seq_len = seq_len
        self.num_digits = num_digits
        self.image_size = image_size
        self.step_length = step_length
        self.deterministic = deterministic
        self.three_channels = three_channels
        self.normalize = normalize
        self.make_target = make_target
        self.synchronized = synchronized
        # the fixed start of the interpolation experiments (reference
        # stochasticMovingMnist.py:27-29,63-74: x=16, y=4 at 64 px)
        self.set_starting_position = set_starting_position
        self.seed = seed

    @staticmethod
    def _load_bank(digit_bank: str, data_root: str, train: bool):
        """(bank [N,s,s] in [0,1], kind): "mnist-idx" (real MNIST from
        disk), "sklearn-digits" (UCI 8x8) or "synthetic". "auto" prefers
        real MNIST, else synthetic."""
        if digit_bank in ("auto", "mnist"):
            bank = load_mnist_digits(data_root, train=train)
            if bank is not None:
                return bank, "mnist-idx"
            if digit_bank == "mnist":
                raise FileNotFoundError(
                    f"digit_bank='mnist' but no IDX/npz files under {data_root!r}")
        if digit_bank == "sklearn":
            bank = sklearn_digit_bank(train=train)
            if bank is None:
                raise ImportError("digit_bank='sklearn' requires scikit-learn")
            return bank, "sklearn-digits"
        if digit_bank not in ("auto", "synthetic"):
            raise ValueError(f"unknown digit_bank {digit_bank!r}")
        return synthetic_digit_bank(seed=0 if train else 1), "synthetic"

    def sample(self, generator: torch.Generator | None, batch_size: int,
               draws: NoiseSource | None = None):
        """[B,T,H,W,C] in [0,1] (a (first half, second half) pair with
        ``make_target``), plus hit_boundary [B,T] when synchronized.
        ``draws`` replaces the generator (tests inject JAX's integers)."""
        if draws is None:
            if self.synchronized or self.seed is not None:
                seed = 12 if self.synchronized else self.seed
                generator = torch.Generator(device=self.device).manual_seed(seed)
            draws = NoiseSource(generator=generator)
        x, hits = sample_moving_mnist(
            draws, self.digits, seq_len=self.seq_len, image_size=self.image_size,
            num_digits=self.num_digits, step_length=self.step_length,
            deterministic=self.deterministic, batch_size=batch_size,
            fixed_start=((self.image_size // 4, self.image_size // 16)
                         if self.set_starting_position else None))
        if self.normalize:
            x = (x - 0.1307) / 0.3081
        if self.three_channels:
            x = x.repeat_interleave(3, dim=-1)
        out = (x[:, :self.seq_len // 2], x[:, self.seq_len // 2:]) if self.make_target else x
        if self.synchronized:
            return out, hits
        return out

"""The one generator of inputs: a pool of sequences of moving squares made
on the device from the seed, and read by every traffic file.

Each sequence is a bright square a quarter of the frame wide (16 pixels
at 64; of a random gray
level in [0.5, 1]) moving in a straight line, reflected at the borders,
over a dim noisy background (uniform in [0, 0.1)), frames [T, H, W, C] in
[0, 1]. Every seed gives the same sizes; only the positions, speeds,
levels and noise differ.
"""

from __future__ import annotations

import torch

from .seeds import derive


MAX_SPEED = 4  # pixels a frame along each axis


def squares(seed: int, batch: int, frames: int, size: int, channels: int,
            device) -> torch.Tensor:
    """[batch, frames, size, size, channels] in [0, 1]."""
    g = torch.Generator(device=device).manual_seed(seed)
    square = size // 4
    span = size - square

    def draw(*shape, low, high):
        return torch.randint(low, high, shape, generator=g, device=device)

    start = draw(batch, 2, low=0, high=span + 1)
    speed = draw(batch, 2, low=-MAX_SPEED, high=MAX_SPEED + 1)
    level = 0.5 + 0.5 * torch.rand(batch, generator=g, device=device)
    x = 0.1 * torch.rand((batch, frames, size, size, channels), generator=g, device=device)
    t = torch.arange(frames, device=device)
    pos = start[:, None, :] + speed[:, None, :] * t[None, :, None]  # [B, T, 2]
    pos = pos % (2 * span)
    pos = torch.where(pos > span, 2 * span - pos, pos)  # reflect at the borders
    grid = torch.arange(size, device=device)
    rows = (grid[None, None, :] >= pos[..., 0:1]) & (grid[None, None, :] < pos[..., 0:1] + square)
    cols = (grid[None, None, :] >= pos[..., 1:2]) & (grid[None, None, :] < pos[..., 1:2] + square)
    mask = rows[..., :, None] & cols[..., None, :]  # [B, T, H, W]
    return torch.where(mask[..., None], level[:, None, None, None, None], x)


def pool(traffic: dict, cfg: dict, seed: int, device) -> list:
    """The traffic's pool: ``traffic['pool']`` batches of ``batch``
    sequences of ``frames`` frames at the configuration's size."""
    return [squares(derive(seed, f"pool{i}"), traffic["batch"], traffic["frames"],
                    cfg["image_size"], cfg["x_channels"], device)
            for i in range(traffic["pool"])]

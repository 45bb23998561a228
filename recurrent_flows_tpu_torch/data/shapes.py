"""Moving shapes made on the device, the counterpart of
``recurrent_flows_tpu.data.shapes``: one random shape per sequence (circle,
square or upward triangle, rasterised from its distance to the centre)
moving with constant velocity and bouncing off the walls.

The draws go through a ``NoiseSource`` (a test replays the JAX package's
and gets its frames), then the render is deterministic: the motion is a
loop over the frames in place of ``lax.scan``, the raster one comparison
per pixel of every frame at once.
"""

from __future__ import annotations

import math

import torch

from ..utils.numerics import NoiseSource


def _raster(shape_id, cy, cx, size, image_size: int):
    """Frames [T, B, H, W] of shape ``shape_id`` [B] (0 circle, 1 square,
    2 triangle) of half-size ``size`` [B] centred at (cy, cx) [T, B]."""
    dev = cy.device
    yy = torch.arange(image_size, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(image_size, dtype=torch.float32, device=dev)[None, :]
    dy, dx = yy - cy[..., None, None], xx - cx[..., None, None]
    size = size[:, None, None]
    circle = torch.sqrt(dy * dy + dx * dx) <= size
    square = (dy.abs() <= size) & (dx.abs() <= size)
    # upward triangle: y in [cy-size, cy+size], |dx| <= (dy+size)/2
    tri = (dy >= -size) & (dy <= size) & (dx.abs() <= (dy + size) * 0.5)
    sid = shape_id[:, None, None]
    return torch.where(sid == 0, circle, torch.where(sid == 1, square, tri)).float()


def sample_moving_shapes(draws: NoiseSource, *, seq_len: int = 10, image_size: int = 32,
                         batch_size: int = 8, device="cuda"):
    """Frames [B, T, H, W, 1] in {0, 1} on ``device``. ``draws`` gives, in
    this order: the shape [B] in {0, 1, 2}; the half-size [B] in U[3, 6);
    the start (y, x) [B, 2] in U[6, image_size - 6); the direction [B] in
    U[0, 2π); the speed [B] in U[1, 3)."""
    dev = torch.device(device)
    like = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    shape_id = draws.randint(0, 3, (batch_size,), dev)
    size = draws.uniform(like(batch_size), 3.0, 6.0)
    pos = draws.uniform(like(batch_size, 2), 6.0, image_size - 6.0)
    ang = draws.uniform(like(batch_size), 0.0, 2 * math.pi)
    speed = draws.uniform(like(batch_size), 1.0, 3.0)
    vel = torch.stack([torch.sin(ang), torch.cos(ang)], -1) * speed[:, None]
    traj = []
    for _ in range(seq_len):
        new_pos = pos + vel
        bounce = (new_pos < 0.0) | (new_pos > image_size - 1.0)
        vel = torch.where(bounce, -vel, vel)
        pos = new_pos.clamp(0.0, image_size - 1.0)
        traj.append(pos)
    traj = torch.stack(traj)  # [T, B, 2]
    frames = _raster(shape_id, traj[..., 0], traj[..., 1], size, image_size)
    return frames.transpose(0, 1)[..., None]


class MovingShapes:
    """Sampler facade matching ``MovingMNIST``: ``sample(generator,
    batch_size)`` draws with ``generator``, a ``torch.Generator`` of
    ``device``."""

    def __init__(self, seq_len: int = 10, image_size: int = 32, device="cuda"):
        self.seq_len = seq_len
        self.image_size = image_size
        self.device = torch.device(device)

    def sample(self, generator: torch.Generator, batch_size: int):
        return sample_moving_shapes(
            NoiseSource(generator=generator), seq_len=self.seq_len,
            image_size=self.image_size, batch_size=batch_size, device=self.device)

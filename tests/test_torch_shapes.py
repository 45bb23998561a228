"""The port's moving shapes against ``recurrent_flows_tpu.data.shapes``
(CPU): given the JAX package's draws for a key, replayed through a
``NoiseSource``, the frames equal ``sample_moving_shapes``'s exactly (the
same float32 motion; the raster compares distances, no tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_flows_tpu.data.shapes import sample_moving_shapes as jax_shapes
from recurrent_flows_tpu_torch.data import MovingShapes, sample_moving_shapes
from recurrent_flows_tpu_torch.utils import NoiseSource


def jax_draws(key, image_size: int, batch: int) -> list:
    """The draws of ``recurrent_flows_tpu.data.shapes.sample_moving_shapes``
    for ``key``, in the port's order."""
    ks, kp, kv, ksz = jax.random.split(key, 4)
    return [np.asarray(d) for d in (
        jax.random.randint(ks, (batch,), 0, 3),
        jax.random.uniform(ksz, (batch,), minval=3.0, maxval=6.0),
        jax.random.uniform(kp, (batch, 2), minval=6.0, maxval=image_size - 6.0),
        jax.random.uniform(kv, (batch,), maxval=2 * jnp.pi),
        jax.random.uniform(jax.random.fold_in(kv, 1), (batch,), minval=1.0, maxval=3.0))]


@pytest.mark.parametrize("seed,image_size,frames,batch", [
    (s, img, t, b) for s in range(4) for img, t, b in ((32, 10, 8), (64, 12, 16))])
def test_frames_equal_jax_on_its_draws(seed, image_size, frames, batch):
    key = jax.random.key(seed)
    ref = np.asarray(jax_shapes(key, seq_len=frames, image_size=image_size, batch_size=batch))
    noise = NoiseSource(replay=jax_draws(key, image_size, batch))
    got = sample_moving_shapes(noise, seq_len=frames, image_size=image_size,
                               batch_size=batch, device="cpu")
    assert noise.exhausted()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sampler_draws_with_the_generator():
    data = MovingShapes(seq_len=5, image_size=32, device="cpu")
    a = data.sample(torch.Generator().manual_seed(3), 4)
    b = data.sample(torch.Generator().manual_seed(3), 4)
    c = data.sample(torch.Generator().manual_seed(4), 4)
    assert a.shape == (4, 5, 32, 32, 1) and torch.equal(a, b) and not torch.equal(a, c)
    # each sequence holds one shape that moves
    assert (a.sum((2, 3, 4)) > 0).all() and not torch.equal(a[:, 0], a[:, 1])

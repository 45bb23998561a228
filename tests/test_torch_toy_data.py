"""The port's sinusoids and two-moons against
``recurrent_flows_tpu.data.sinusoids`` and ``.halfmoon`` on the CPU: given
the JAX package's draws for a key, replayed through a ``NoiseSource`` in
the order each docstring states, the port's arrays equal JAX's within
1e-5·(1+|ref|) (the float32 rounding of sin and cos); every draw is used.
The facades draw with a ``torch.Generator``, the same arrays for the same
seed."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.data import halfmoon as jh
from recurrent_flows_tpu.data import sinusoids as js
from recurrent_flows_tpu_torch.data import (RotatingTwoMoonsConditionalSampler, SinusWithNoise,
                                            sample_sinusoids, two_moons)
from recurrent_flows_tpu_torch.data.halfmoon import _rotate
from recurrent_flows_tpu_torch.utils import NoiseSource

TOL = 1e-5


def _u(key, shape, hi):
    return np.asarray(jax.random.uniform(key, shape, maxval=hi))


def _moons_draws(key, n):
    k1, k2, k3 = jax.random.split(key, 3)
    return [_u(k1, (n // 2,), jnp.pi), _u(k2, (n - n // 2,), jnp.pi),
            np.asarray(jax.random.normal(k3, (n, 2)))]


@pytest.mark.parametrize("seed,seq_len,batch", [(0, 100, 32), (1, 12, 3)])
def test_sinusoids_equal_jax_on_its_draws(seed, seq_len, batch):
    key = jax.random.key(seed)
    ref = js.sample_sinusoids(key, seq_len=seq_len, batch_size=batch, freq=0.05, noise=0.2)
    k1, k2, k3 = jax.random.split(key, 3)
    noise = NoiseSource(replay=[_u(k1, (batch, 1), 2 * jnp.pi), _u(k2, (batch, 1), 1.0),
                                np.asarray(jax.random.normal(k3, (batch, seq_len)))])
    got = sample_sinusoids(noise, seq_len=seq_len, batch_size=batch, freq=0.05, noise=0.2,
                           device="cpu")
    assert noise.exhausted()
    U.assert_close_rel(got, ref, TOL, "sinusoids")
    data = SinusWithNoise(seq_len=seq_len, device="cpu")
    a, b = (data.sample(torch.Generator().manual_seed(5), batch) for _ in range(2))
    assert a.shape == (batch, seq_len, 1) and torch.equal(a, b)


@pytest.mark.parametrize("n", [9, 256])
def test_two_moons_and_rotation_equal_jax(n):
    key = jax.random.key(n)
    noise = NoiseSource(replay=_moons_draws(key, n))
    got = two_moons(noise, n, device="cpu")
    assert noise.exhausted()
    U.assert_close_rel(got, jh.two_moons(key, n), TOL, "two_moons")
    U.assert_close_rel(_rotate(got, 1.3), jh._rotate(jnp.asarray(got.numpy()), 1.3), TOL,
                       "rotate")


def test_conditional_sampler_equals_jax():
    s = RotatingTwoMoonsConditionalSampler(device="cpu")
    js_ = jh.RotatingTwoMoonsConditionalSampler()
    key = jax.random.key(3)
    got = s.conditioned_sample(NoiseSource(replay=_moons_draws(key, 6)), 6, 0.4)
    U.assert_close_rel(got, js_.conditioned_sample(key, 6, 0.4), TOL, "conditioned")

    key = jax.random.key(4)
    ref, ref_theta = js_.joint_sample(key, 7)
    k1, k2 = jax.random.split(key)
    noise = NoiseSource(replay=[_u(k1, (), 2 * jnp.pi)] + _moons_draws(k2, 7))
    got, theta = s.joint_sample(noise, 7)
    assert noise.exhausted()
    U.assert_close_rel(theta, ref_theta, TOL, "theta")
    U.assert_close_rel(got, ref, TOL, "joint")

    key, bs, nb = jax.random.key(5), 4, 2
    draws = []
    for i in range(nb):
        k = jax.random.fold_in(key, i)
        draws.append(_u(k, (bs,), 2 * jnp.pi))
        per_row = [_moons_draws(kk, 1) for kk in jax.random.split(k, bs)]
        draws += [np.stack([d[1] for d in per_row]), np.stack([d[2] for d in per_row])]
    noise = NoiseSource(replay=draws)
    got = list(s.loader(noise, bs, nb))
    assert noise.exhausted() and len(got) == nb
    for (gx, gt), (rx, rt) in zip(got, js_.loader(key, bs, nb)):
        assert gx.shape == (bs, 2) and gt.shape == (bs, 1)
        U.assert_close_rel(gt, rt, TOL, "loader theta")
        U.assert_close_rel(gx, rx, TOL, "loader x")
    assert 0 <= float(gt.min()) and float(gt.max()) < 2 * math.pi

"""The port's Moving MNIST generator against the JAX package's, on the CPU:
the digit banks bit for bit, the bilinear resize against
``jax.image.resize``, the frames and ``hit_boundary`` exactly equal to JAX's
given JAX's integer draws (replayed through ``NoiseSource``), every option
of the ``MovingMNIST`` facade, and an IDX file read by both loaders.

Tolerance: the resize within 1e-6 (float32 sums of up to 4 products at
28->32, of a widened kernel at 28->16); everything else exact.
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_flows_tpu.data import moving_mnist as jmm
from recurrent_flows_tpu_torch.data import moving_mnist as tmm
from recurrent_flows_tpu_torch.utils import NoiseSource

IMG, DS, B, T, N, STEP = 64, 28, 3, 12, 2, 4


@pytest.fixture(scope="module")
def bank():
    return tmm.synthetic_digit_bank(seed=3, n=24)


def test_synthetic_digit_bank_equals_jax():
    for kw in (dict(seed=0, n=40), dict(seed=1, n=8, size=16)):
        assert np.array_equal(tmm.synthetic_digit_bank(**kw), jmm.synthetic_digit_bank(**kw))


@pytest.mark.parametrize("size", [32, 16])
def test_resize_bank_matches_jax_image_resize(bank, size):
    got = tmm._resize_bank(bank, size)
    ref = np.asarray(jax.image.resize(jnp.asarray(bank), (len(bank), size, size),
                                      method="bilinear"))
    assert got.shape == ref.shape == (len(bank), size, size) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert tmm._resize_bank(bank, bank.shape[-1]) is bank


def jax_draws(key, n_bank, *, deterministic, fixed, batch=B, t=T):
    """JAX's integer draws of ``sample_moving_mnist(key, ...)``
    (moving_mnist.py:160-187, :115-121) in the order the port takes them."""
    limit = IMG - DS
    kd, kx, ky, kvx, kvy, kt = jax.random.split(key, 6)
    shape = (batch, N)
    draws = [jax.random.randint(kd, shape, 0, n_bank)]
    if not fixed:
        draws += [jax.random.randint(kx, shape, 0, limit),
                  jax.random.randint(ky, shape, 0, limit)]
    draws += [jax.random.randint(kvx, shape, -STEP, STEP + 1),
              jax.random.randint(kvy, shape, -STEP, STEP + 1)]
    if not deterministic:
        per_axis = {0: ([], [], []), 1: ([], [], [])}
        for key_t in jax.random.split(kt, t):
            for axis, k in enumerate(jax.random.split(key_t)):  # y, then x
                k1, k2 = jax.random.split(k)
                pos, neg, other = per_axis[axis]
                pos.append(jax.random.randint(k1, shape, 1, STEP + 1))
                neg.append(jax.random.randint(k1, shape, -STEP, 0))
                other.append(jax.random.randint(k2, shape, -STEP, STEP + 1))
        for axis in (0, 1):
            draws += [jnp.stack(d) for d in per_axis[axis]]
    return [np.asarray(d) for d in draws]


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("deterministic", [False, True])
def test_frames_and_hits_equal_jax_given_its_draws(bank, deterministic, fixed):
    start = (IMG // 4, IMG // 16) if fixed else None
    kw = dict(seq_len=T, image_size=IMG, num_digits=N, step_length=STEP,
              deterministic=deterministic, batch_size=B, fixed_start=start)
    key = jax.random.key(21)
    ref_x, ref_hits = jmm.sample_moving_mnist(key, jnp.asarray(bank), **kw)
    noise = NoiseSource(replay=jax_draws(key, len(bank), deterministic=deterministic,
                                         fixed=fixed))
    x, hits = tmm.sample_moving_mnist(noise, torch.as_tensor(bank), **kw)
    assert noise.exhausted()
    assert x.shape == (B, T, IMG, IMG, 1) and x.dtype == torch.float32
    assert np.array_equal(x.numpy(), np.asarray(ref_x))
    assert hits.dtype == torch.bool and np.array_equal(hits.numpy(), np.asarray(ref_hits))
    assert hits.any()  # the run met walls: the bounce rules were exercised


def _facade(**kw):
    return tmm.MovingMNIST(digit_bank="synthetic", seq_len=T, num_digits=N, digit_size=32,
                           device="cpu", **kw)


def test_facade_options_give_the_shapes_and_ranges():
    gen = lambda s: torch.Generator().manual_seed(s)
    plain = _facade()
    assert plain.bank_kind == "synthetic" and plain.digits.shape == (512, 32, 32)
    x = plain.sample(gen(0), B)
    assert x.shape == (B, T, IMG, IMG, 1) and 0.0 <= x.min() and x.max() <= 1.0
    assert x.max() > 0.5 and not torch.equal(x, plain.sample(gen(1), B))
    assert torch.equal(x, plain.sample(gen(0), B))  # the generator fixes the batch
    rgb = _facade(three_channels=True).sample(gen(0), B)
    assert rgb.shape == (B, T, IMG, IMG, 3) and torch.equal(rgb[..., 2:], x)
    norm = _facade(normalize=True).sample(gen(0), B)
    torch.testing.assert_close(norm, (x - 0.1307) / 0.3081)
    first, second = _facade(make_target=True).sample(gen(0), B)
    assert torch.equal(torch.cat([first, second], 1), x) and first.shape[1] == T // 2
    det = _facade(deterministic=True).sample(gen(0), B)
    assert det.shape == x.shape and not torch.equal(det, x)
    seeded = _facade(seed=5)
    assert torch.equal(seeded.sample(gen(0), B), seeded.sample(gen(1), B))
    sync = _facade(synchronized=True)
    (a, hits), (b, hits2) = sync.sample(gen(0), B), sync.sample(None, B)
    assert torch.equal(a, b) and torch.equal(hits, hits2)
    assert hits.shape == (B, T) and hits.dtype == torch.bool
    fixed = _facade(set_starting_position=True, deterministic=True)
    x0 = fixed.sample(gen(0), B)[:, 0, ..., 0]
    rows, cols = x0.amax(2) > 0, x0.amax(1) > 0  # the sprites start at y=4, x=16
    assert not rows[:, :4].any() and not cols[:, :16].any()
    assert rows[:, 4:36].any(1).all() and cols[:, 16:48].any(1).all()


def _write_idx(path, images, gz):
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape))
        f.write(images.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_file_read_by_both_loaders(tmp_path, gz):
    images = np.random.default_rng(0).integers(0, 256, (5, 28, 28), dtype=np.uint8)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    _write_idx(raw / ("train-images-idx3-ubyte" + (".gz" if gz else "")), images, gz)
    got = tmm.load_mnist_digits(str(tmp_path))
    assert np.array_equal(got, jmm.load_mnist_digits(str(tmp_path)))
    assert np.array_equal(got, images.astype(np.float32) / 255.0)
    assert tmm.load_mnist_digits(str(tmp_path), train=False) is None
    data = tmm.MovingMNIST(data_root=str(tmp_path), digit_bank="mnist", digit_size=28,
                           device="cpu")
    assert data.bank_kind == "mnist-idx" and torch.equal(data.digits, torch.tensor(got))
    with pytest.raises(FileNotFoundError):
        tmm.MovingMNIST(data_root=str(tmp_path / "absent"), digit_bank="mnist", device="cpu")


def test_sklearn_and_npz_banks_equal_jax(tmp_path):
    pytest.importorskip("sklearn")
    assert np.array_equal(tmm.sklearn_digit_bank(False), jmm.sklearn_digit_bank(False))
    x = np.random.default_rng(1).integers(0, 256, (4, 28, 28), dtype=np.uint8)
    np.savez(tmp_path / "mnist.npz", x_train=x, x_test=x[:2])
    for train in (True, False):
        assert np.array_equal(tmm.load_mnist_digits(str(tmp_path), train),
                              jmm.load_mnist_digits(str(tmp_path), train))

"""The port's CelebA path against ``recurrent_flows_tpu.data.celeba`` on
the CPU: ``prepare_celeba`` on the same PNG files (non-square, gray, RGB
and RGBA, random and patterned) equals the JAX package's Pillow path
within 1/255 per pixel (plus 1e-6 of float32 rounding; the port resizes
with ``F.interpolate(bilinear, antialias=True)``, Pillow with its own
fixed-point filter); ``get_celeba`` reads both pickles as JAX's does; the
boxed pairs are JAX's exactly; PNG sources need no Pillow, and a JPEG
source without Pillow raises ``ImportError`` naming it."""

import sys

import numpy as np
import pytest

from recurrent_flows_tpu.data import celeba as jc
from recurrent_flows_tpu_torch.data import celeba as pc
from recurrent_flows_tpu_torch.data.png import write_png

SHAPES = [(54, 44, 3), (218, 178, 3), (37, 53, 3), (100, 90), (45, 61, 4)]


def _png_dir(tmp_path):
    d = tmp_path / "raw"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i, shape in enumerate(SHAPES):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        if i == 1:  # smooth ramps, where a resize's rounding shows
            yy, xx = np.mgrid[:shape[0], :shape[1]]
            img = np.stack([yy * 3 % 256, xx * 5 % 256, (yy + xx) * 2 % 256], -1).astype(np.uint8)
        write_png(str(d / f"{i:06d}.png"), img)
    return d


@pytest.mark.parametrize("size", [16, 32])
def test_prepare_celeba_matches_jax_within_one_level(tmp_path, size):
    d = _png_dir(tmp_path)
    n = pc.prepare_celeba(str(d), str(tmp_path / "port" / "celeba_32.pkl"), size=size,
                          device="cpu")
    assert n == jc.prepare_celeba(str(d), str(tmp_path / "jax" / "celeba_32.pkl"), size=size)
    got, ref = pc.get_celeba(str(tmp_path / "port")), jc.get_celeba(str(tmp_path / "jax"))
    assert got.shape == ref.shape == (len(SHAPES), size, size, 3) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1 / 255 + 1e-6
    np.testing.assert_array_equal(pc.get_celeba(str(tmp_path / "jax")), ref)
    assert pc.get_celeba(str(tmp_path / "none")) is None
    assert pc.prepare_celeba(str(d), str(tmp_path / "lim.pkl"), size=8, limit=2,
                             device="cpu") == 2


def test_get_celeba_reads_uint8_nchw_and_the_boxed_pairs_equal_jax(tmp_path):
    import pickle

    arr = np.random.default_rng(1).integers(0, 256, (3, 3, 8, 8), dtype=np.uint8)
    (tmp_path / "celeba.pkl").write_bytes(pickle.dumps(arr))
    got, ref = pc.get_celeba(str(tmp_path)), jc.get_celeba(str(tmp_path))
    np.testing.assert_array_equal(got, ref)
    for box in (2, 4):
        for a, b in zip(pc.get_joint_conditioned_data(got, box),
                        jc.get_joint_conditioned_data(ref, box)):
            np.testing.assert_array_equal(a, b)


def test_png_needs_no_pillow_and_a_jpeg_without_it_names_it(tmp_path, monkeypatch):
    d = _png_dir(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises
    assert pc.prepare_celeba(str(d), str(tmp_path / "a.pkl"), size=8, device="cpu") == 5
    (d / "zz.jpg").write_bytes(b"not read")
    with pytest.raises(ImportError, match="Pillow"):
        pc.prepare_celeba(str(d), str(tmp_path / "b.pkl"), size=8, device="cpu")

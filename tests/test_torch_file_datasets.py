"""The port's KTH / BAIR loaders and PNG codec against the JAX package's
loaders and ``matplotlib.image.imread`` (CPU).

- on the synthetic trees of ``test_file_datasets.py`` (PNGs written by
  matplotlib), ``KTH`` and ``PushDataset`` give the JAX loaders' batches for
  the same seed, exactly, train and test splits;
- ``data.png.read_png`` equals ``imread`` on gray, RGB and RGBA files made
  with every row filter, on gray+alpha, and on Pillow's and matplotlib's
  own files; other PNGs raise;
- a missing tree raises ``FileNotFoundError``; ``--choose_data kth|bair``
  without a frame blob go through ``build_dataset`` and train.
"""

import os
import struct
import types
import zlib

import matplotlib
import numpy as np
import pytest
from matplotlib import image as mpimg
from PIL import Image

from torch_parity_utils import _two_torch_threads  # noqa: F401  (two torch threads)
from recurrent_flows_tpu.data import KTH as JaxKTH
from recurrent_flows_tpu.data import PushDataset as JaxPush
from recurrent_flows_tpu_torch.cli import common, main_rfn
from recurrent_flows_tpu_torch.data import KTH, PushDataset
from recurrent_flows_tpu_torch.data.png import read_png, write_png

matplotlib.use("Agg")


def _write_png(path, arr):
    mpimg.imsave(path, arr.squeeze(), cmap="gray", vmin=0, vmax=1)


@pytest.fixture(scope="module")
def kth_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kth")
    rng = np.random.RandomState(0)
    for cls in ("boxing", "walking"):
        for person in (1, 21):
            d = root / "processed" / cls / f"person{person:02d}_{cls}_d1"
            os.makedirs(d)
            for i in range(12):
                _write_png(str(d / f"image-{i:03d}.png"), rng.rand(16, 16))
    return str(root)


@pytest.fixture(scope="module")
def bair_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("bair")
    rng = np.random.RandomState(0)
    for split in ("train", "test"):
        for t in range(2):
            d = root / split / f"traj_{t}_to_{t+1}" / "0"
            os.makedirs(d)
            for i in range(10):
                _write_png(str(d / f"{i}.png"), rng.rand(16, 16, 3))
    return str(root)


@pytest.mark.parametrize("train", [True, False])
def test_kth_batches_equal_jax(kth_tree, train):
    kw = dict(train=train, data_root=kth_tree, seq_len=6, batch_size=3, seed=5,
              batches_per_epoch=2)
    port, ref = KTH(**kw), JaxKTH(**kw)
    assert port.videos == ref.videos and len(port) == 2
    for got, want in zip(list(port) + [port.sample_numpy(2)], list(ref) + [ref.sample_numpy(2)]):
        assert got.dtype == np.float32 and got.shape[-1] == 1
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("split", ["train", "test"])
def test_bair_batches_equal_jax(bair_tree, split):
    kw = dict(split=split, dataset_dir=bair_tree, seq_len=5, batch_size=2, seed=3,
              batches_per_epoch=2)
    port, ref = PushDataset(**kw), JaxPush(**kw)
    assert port.trajs == ref.trajs
    for got, want in zip(list(port) + [port.sample_numpy(3)], list(ref) + [ref.sample_numpy(3)]):
        assert got.dtype == np.float32 and got.shape[-1] == 3
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 3), (13, 17, 4)])
def test_every_filter_decodes_as_imread(tmp_path, shape):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
        path = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        write_png(path, img, filters=filters)
        got, want = read_png(path), mpimg.imread(path)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8), img)


def test_other_encoders_decode_as_imread(tmp_path):
    rng = np.random.RandomState(2)
    ramp = (np.add.outer(np.arange(32), np.arange(32)) * 3 % 256).astype(np.uint8)
    images = {"L": ramp, "RGB": np.stack([ramp, 255 - ramp, ramp // 2], -1),
              "RGBA": np.stack([ramp, 255 - ramp, ramp // 2, ramp], -1),
              "LA": rng.randint(0, 256, (9, 11, 2)).astype(np.uint8)}
    for mode, arr in images.items():
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(arr, mode).save(path, optimize=True)  # Pillow's adaptive filters
        np.testing.assert_array_equal(read_png(path), mpimg.imread(path), err_msg=mode)
    assert read_png(str(tmp_path / "LA.png")).shape == (9, 11, 4)  # as RGBA, as imread
    path = str(tmp_path / "imsave.png")
    _write_png(path, rng.rand(8, 8))
    np.testing.assert_array_equal(read_png(path), mpimg.imread(path))


def test_other_pngs_raise(tmp_path):
    arr = np.random.RandomState(3).randint(0, 256, (8, 8)).astype(np.uint8)
    cases = {"palette": Image.fromarray(arr, "L").convert("P"),
             "16-bit": Image.fromarray(arr.astype(np.uint16) * 257),
             "1-bit": Image.fromarray(arr > 127)}
    for name, im in cases.items():
        im.save(str(tmp_path / f"{name}.png"))
        with pytest.raises(ValueError):
            read_png(str(tmp_path / f"{name}.png"))
    # an Adam7-interlaced header (Pillow writes none): our own file, the
    # interlace byte of IHDR set and its CRC made anew
    path = tmp_path / "interlaced.png"
    write_png(str(path), arr)
    raw = bytearray(path.read_bytes())
    raw[28] = 1  # signature 8 + length 4 + 'IHDR' 4 + 12 header bytes
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])))
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="interlace 1"):
        read_png(str(path))
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError):
        read_png(str(tmp_path / "not.png"))


def test_missing_trees_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        KTH(train=True, data_root=str(tmp_path / "none"), seq_len=6)
    with pytest.raises(FileNotFoundError):
        PushDataset(split="train", dataset_dir=str(tmp_path / "none"))


@pytest.mark.parametrize("choice", ["kth", "bair"])
def test_choose_data_without_a_blob(kth_tree, bair_tree, tmp_path, choice):
    root = kth_tree if choice == "kth" else bair_tree
    args = types.SimpleNamespace(choose_data=choice, data_root=root, n_frames=3,
                                 image_size=16, batch_size=2)
    data = common.build_dataset(args, train=True, device="cpu")
    assert isinstance(data, KTH if choice == "kth" else PushDataset)
    assert next(iter(data)).shape == (2, 3, 16, 16, 1 if choice == "kth" else 3)
    tr = main_rfn.main([
        "--choose_data", choice, "--data_root", root, "--image_size", "16",
        "--batch_size", "2", "--n_frames", "3", "--n_epochs", "1", "--steps_per_epoch", "1",
        "--n_conditions", "2", "--n_predictions", "1", "--device", "cpu",
        "--h_dim", "8", "--z_dim", "2", "--a_dim", "4", "--L", "2", "--K", "2",
        "--extractor_structure", "4-pool-8", "8-pool-8", "--upscaler_structure", "8",
        "upsample-4", "--prior_structure", "4", "--encoder_structure", "4",
        "--n_units_affine", "8", "--n_units_prior", "8", "--path", str(tmp_path / choice)])
    assert tr.counter == 1 and np.isfinite(tr.losses).all()
    assert tr.model.cfg.x_channels == (1 if choice == "kth" else 3)

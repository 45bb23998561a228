"""The port's copy of the native frame cache against the JAX package's:
the same blob bytes from the same videos, and the same batches from the
same blob, drawn with a seed and from the prefetch ring. Skips only where
there is no g++ to build the library. The library is built into a
temporary directory here, so that the tests leave the package's
``_build/`` as they found it (``test_torch_import_purity.py`` watches it)."""

import shutil

import numpy as np
import pytest

from recurrent_flows_tpu.data import framecache as jfc
from recurrent_flows_tpu_torch.data import framecache as tfc


@pytest.fixture(scope="module", autouse=True)
def build_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfc, "BUILD_DIR", tmp_path_factory.mktemp("build"))
        yield tfc.BUILD_DIR


@pytest.fixture(scope="module")
def videos():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the frame cache")
    rng = np.random.RandomState(0)
    out = [(rng.rand(n, 8, 8, 3) * 255).astype(np.uint8) for n in (12, 20, 16)]
    out.append(rng.rand(9, 8, 8, 3).astype(np.float32))  # floats in [0, 1] convert
    return out


def test_build_blob_writes_the_jax_bytes(videos, tmp_path):
    a, b = tmp_path / "port.blob", tmp_path / "jax.blob"
    assert tfc.build_blob(videos, str(a)) == str(a)
    jfc.build_blob(videos, str(b))
    assert a.read_bytes() == b.read_bytes()
    with pytest.raises(ValueError):
        tfc.build_blob([], str(a))


def test_batches_equal_jax_on_the_same_blob(videos, tmp_path, build_dir):
    path = str(tmp_path / "frames.blob")
    tfc.build_blob(videos, path)
    assert tfc.is_available() and jfc.is_available()
    lib = tfc.ensure_built()
    assert lib.startswith(str(build_dir)) and tfc.ensure_built() == lib
    port = tfc.FrameCache(path, seq_len=6, batch_size=4, seed=3, batches_per_epoch=3)
    ref = jfc.FrameCache(path, seq_len=6, batch_size=4, seed=3, batches_per_epoch=3)
    assert (port.n_videos, port.h, port.w, port.c) == (4, 8, 8, 3) and len(port) == 3
    for seed in (0, 7, 123):
        x = port.sample_numpy(seed)
        assert x.shape == (4, 6, 8, 8, 3) and x.dtype == np.float32
        assert np.array_equal(x, ref.sample_numpy(seed))
    got, want = list(port), list(ref)  # the prefetch ring, seeded
    assert len(got) == 3 and all(np.array_equal(g, w) for g, w in zip(got, want))
    port.close()
    ref.close()
    with pytest.raises(IOError):
        tfc.FrameCache(str(tmp_path / "absent.blob"), seq_len=6, batch_size=4)

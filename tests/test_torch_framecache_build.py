"""The port's ``cli.build_framecache``, which decodes
with ``data.png.read_png``: on the synthetic KTH and BAIR trees of
``tests/test_file_datasets.py`` (written by ``matplotlib.image.imsave``)
it writes both splits' blobs equal byte for byte to the ones the JAX
package's ``blob_from_loader`` writes with matplotlib; the training CLIs'
``build_dataset`` then serves both datasets from the ``FrameCache``; and
importing ``cli.build_framecache`` imports no matplotlib (the card's machine has
none)."""

import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

from recurrent_flows_tpu.data import KTH as JaxKTH
from recurrent_flows_tpu.data import PushDataset as JaxPush
from recurrent_flows_tpu.data.framecache import blob_from_loader as jax_blob_from_loader
from recurrent_flows_tpu_torch.cli import build_framecache
from recurrent_flows_tpu_torch.cli.common import build_dataset
from recurrent_flows_tpu_torch.data.framecache import FrameCache
from test_file_datasets import bair_tree, kth_tree  # noqa: F401 (fixtures)

REPO = Path(__file__).resolve().parents[1]


def _jax_loader(dataset, root, split):
    if dataset == "kth":
        return JaxKTH(train=split == "train", data_root=root, seq_len=1)
    return JaxPush(split=split, dataset_dir=root, seq_len=1)


@pytest.mark.parametrize("dataset", ["kth", "bair"])
def test_port_blobs_equal_the_jax_blobs(dataset, kth_tree, bair_tree, tmp_path):  # noqa: F811
    root = kth_tree if dataset == "kth" else bair_tree
    written = build_framecache.main(["--dataset", dataset, "--data_root", root])
    assert written == [os.path.join(root, f"{dataset}_{s}.blob") for s in ("train", "test")]
    for split, blob in zip(("train", "test"), written):
        ref = jax_blob_from_loader(_jax_loader(dataset, root, split),
                                   str(tmp_path / f"jax_{dataset}_{split}.blob"))
        assert Path(blob).read_bytes() == Path(ref).read_bytes(), (dataset, split)
    # --max_videos as the JAX script takes it
    build_framecache.main(["--dataset", dataset, "--data_root", root, "--max_videos", "1"])
    ref = jax_blob_from_loader(_jax_loader(dataset, root, "train"),
                               str(tmp_path / "jax_one.blob"), max_videos=1)
    assert Path(written[0]).read_bytes() == Path(ref).read_bytes()
    build_framecache.main(["--dataset", dataset, "--data_root", root])  # both whole again

    args = types.SimpleNamespace(choose_data=dataset, data_root=root, n_frames=4,
                                 batch_size=2, image_size=16)
    data = build_dataset(args, train=True, device="cpu")
    try:
        assert isinstance(data, FrameCache)
        batch = data.sample_numpy(seed=3)
        assert batch.shape == (2, 4, 16, 16, 1 if dataset == "kth" else 3)
        assert 0.0 <= batch.min() and batch.max() <= 1.0 and batch.max() > 0.0
    finally:
        data.close()


def test_importing_build_framecache_imports_no_matplotlib():
    code = ("import sys; import recurrent_flows_tpu_torch.cli.build_framecache as b; "
            "b.build_parser().parse_args(['--dataset', 'kth', '--data_root', 'x']); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'PIL', 'jax')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

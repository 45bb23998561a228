"""``examples/torch_two_moons.py`` on the CPU with matplotlib blocked from
import: 60 steps of each of the three flows (RealNVP, the conditional
RealNVP, the autoregressive CDF flow), each flow's loss falls (the mean of
its last 10 steps below that of its first 10), and every figure it writes
decodes with ``data.png.read_png`` at the grid's size; and
``training.plots.heatmap`` on its own: the ramp's ends, the vertical flip,
the points."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from recurrent_flows_tpu_torch.data.png import read_png
from recurrent_flows_tpu_torch.training.plots import HEAT, POINTS, heatmap

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "torch_two_moons.py"


@pytest.fixture()
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises


def test_example_trains_and_draws_without_matplotlib(no_matplotlib, tmp_path):
    import torch

    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401
    spec = importlib.util.spec_from_file_location("torch_two_moons", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = example.main(["--steps", "60", "--out", str(tmp_path), "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert set(out["losses"]) == {"realnvp", "conditional_realnvp", "autoregressive"}
    for name, losses in out["losses"].items():
        assert len(losses) == 60 and np.all(np.isfinite(losses)), name
        assert np.mean(losses[-10:]) < np.mean(losses[:10]), (name, losses[:3], losses[-3:])
    names = sorted(Path(f).name for f in out["files"])
    assert names == ["autoregressive.png", "conditional_realnvp.png", "realnvp.png",
                     "two_moons.png"]
    for f in out["files"]:
        img = read_png(f)
        assert img.shape[0] == example.GRID and img.shape[-1] == 3, (f, img.shape)
        assert img.std() > 0.01, f  # a density, not a blank panel
    assert read_png(out["files"][-1]).shape[1] == 3 * example.GRID + 8


def test_heatmap_ramp_flip_and_points():
    v = np.zeros((5, 5))
    v[0, 0], v[4, 4] = 1.0, 0.5  # row 0 at the bottom
    img = heatmap(v, points=np.array([[0.0, 0.0], [9.0, 9.0]]), extent=1.0)
    assert img.shape == (5, 5, 3) and img.dtype == np.uint8
    assert tuple(img[4, 0]) == HEAT[-1]  # the largest value, bottom left
    assert tuple(img[0, 1]) == HEAT[0]  # zero
    assert tuple(img[2, 2]) == POINTS  # (0, 0) at the centre; (9, 9) left out
    assert (img == POINTS).all(-1).sum() == 1

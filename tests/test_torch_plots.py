"""``Trainer.plotter`` without matplotlib (the card's machine has none): with
``matplotlib`` blocked from import, ``fit`` writes ``png_folder/losses.png``
and ``samples0.png`` and prints no plot failure; the grid's tiles are
``plot_rows``' frames (already uint8) and the files decode with
``data.png.read_png``; and the two drawing functions of ``training.plots``
on their own: the grid's layout, gray, RGB and float frames, and the loss panels.

Size: ``test_torch_fit.py``'s (32x32, L=2, K=2, B=2, T=3)."""

import sys

import numpy as np
import pytest

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu_torch.data import MovingMNIST
from recurrent_flows_tpu_torch.data.png import read_png
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.training.plots import LINE, SEPARATOR, frame_grid, loss_panel
from test_torch_fit import B, IMG, T, _config, _tcfg


@pytest.fixture()
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises


def test_fit_writes_its_plots_without_matplotlib(no_matplotlib, tmp_path, capsys, monkeypatch):
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401
    data = MovingMNIST(seq_len=T, image_size=IMG, digit_size=16, num_digits=1,
                       digit_bank="synthetic", device="cpu")
    trainer = Trainer(RFN(U.to_port(_config())), U.to_port(_tcfg()), data,
                      str(tmp_path), device="cpu").build()
    rows = trainer.plot_rows()
    monkeypatch.setattr(trainer, "plot_rows", lambda: rows)  # the same frames each time
    trainer.fit(n_epochs=1)
    assert "plotter failed" not in capsys.readouterr().out
    png = tmp_path / "png_folder"
    assert sorted(p.name for p in png.iterdir()) == ["losses.png", "samples0.png"]
    assert trainer.plot_counter == 1

    grid = np.round(read_png(str(png / "samples0.png")) * 255).astype(np.uint8)
    t_show = min(rows[0][1].shape[0], 10)
    assert grid.shape == (len(rows) * (IMG + 1) - 1, t_show * (IMG + 1) - 1)
    for r, (name, frames) in enumerate(rows):
        assert frames.dtype == np.uint8
        for t in range(t_show):
            tile = grid[r * (IMG + 1):r * (IMG + 1) + IMG, t * (IMG + 1):t * (IMG + 1) + IMG]
            np.testing.assert_array_equal(tile, frames[min(t, len(frames) - 1), 0, ..., 0],
                                          err_msg=f"{name} frame {t}")
    np.testing.assert_array_equal(grid[IMG], SEPARATOR)  # the row separator
    losses = read_png(str(png / "losses.png"))
    assert losses.shape == (120, 4 * 200, 3)
    assert (np.round(losses * 255).astype(np.uint8) == LINE).all(-1).any()


def test_frame_grid_layout_gray_and_rgb():
    rng = np.random.default_rng(0)
    gray = [("a", rng.integers(0, 256, (12, 2, 5, 6, 1), dtype=np.uint8)),
            ("b", rng.integers(0, 256, (3, 2, 5, 6, 1), dtype=np.uint8))]
    g = frame_grid(gray)
    assert g.shape == (2 * 6 - 1, 10 * 7 - 1) and g.dtype == np.uint8
    np.testing.assert_array_equal(g[6:, 7 * 9:7 * 9 + 6], gray[1][1][2, 0, ..., 0])  # last frame held
    np.testing.assert_array_equal(g[:5, 7 * 4:7 * 4 + 6], gray[0][1][4, 0, ..., 0])
    assert (g[5] == SEPARATOR).all() and (g[:, 6] == SEPARATOR).all()
    rgb = [("a", rng.integers(0, 256, (2, 1, 4, 4, 3), dtype=np.uint8))]
    c = frame_grid(rgb)
    assert c.shape == (4, 9, 3)
    np.testing.assert_array_equal(c[:, 5:], rgb[0][1][1, 0])
    # float frames in [0, 1] (plot_rows under the 'none' preprocessing, SVG's)
    floats = rng.uniform(-0.1, 1.1, (3, 1, 4, 4, 1)).astype(np.float32)
    np.testing.assert_array_equal(frame_grid([("a", floats)])[:, 5:9],
                                  np.rint(np.clip(floats[1, 0, ..., 0], 0, 1) * 255))
    with pytest.raises(ValueError):
        frame_grid([("a", np.zeros((2, 1, 4, 4, 1), np.uint8)),
                    ("b", np.zeros((2, 1, 4, 5, 1), np.uint8))])


def test_loss_panel_draws_each_history():
    hist = [[3.0, 2.0, 1.5], [], [float("nan"), 1.0], [5.0] * 4]
    img = loss_panel(hist, height=40, width=50)
    assert img.shape == (40, 200, 3) and img.dtype == np.uint8
    drawn = [(img[:, i * 50:(i + 1) * 50] == LINE).all(-1).sum() for i in range(4)]
    assert drawn[0] > 20 and drawn[1] == 0 and drawn[2] == 1 and drawn[3] > 20
    # a falling history starts high on the left and ends low on the right
    ys, xs = np.nonzero((img[:, :50] == LINE).all(-1))
    assert ys[xs.argmin()] < ys[xs.argmax()]

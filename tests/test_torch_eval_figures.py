"""The ``Evaluator``'s figures without matplotlib (the card's machine has
none): with ``matplotlib`` blocked from import, each figure method of a
tiny ``Evaluator`` and ``plot_eval_curves`` write a PNG that
``data.png.read_png`` decodes, at the size its docstring states, with the
frames or lines it should hold; then the eval CLI with ``--debug_plot``
runs end to end on a port checkpoint and writes its five figures.

Size: the RFN of ``test_rfn.tiny_cfg`` (16x16 gray, L=2, K=2), B=2, 2
context and 3 predicted frames, on the CPU."""

import sys

import numpy as np
import pytest
import torch

from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu_torch import config as port_config
from recurrent_flows_tpu_torch.cli import eval_settings as port_cli
from recurrent_flows_tpu_torch.data import MovingMNIST
from recurrent_flows_tpu_torch.data.png import read_png
from recurrent_flows_tpu_torch.evaluation import evaluator as t_ev
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.training.plots import CONTEXT, PALETTE, PREDICTION

IMG, B, NC, NP = 16, 2, 2, 3


@pytest.fixture()
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises


def _cfg():
    return port_config.RFNConfig(
        x_channels=1, image_size=IMG, h_dim=8, z_dim=2, a_dim=4, L=2, K=2,
        extractor_structure=((4, "pool", 8), (8, "pool", 8)),
        upscaler_structure=((8,), ("upsample", 4)), prior_structure=(4,),
        encoder_structure=(4,), norm_type="none", norm_type_features="none",
        glow=port_config.GlowConfig(L=2, K=2, n_units_affine=8, n_units_prior=8))


def _data(**kw):
    return MovingMNIST(seq_len=NC + NP + 1, image_size=IMG, digit_size=8, num_digits=1,
                       digit_bank="synthetic", device="cpu", **kw)


class Shifted:
    """Moving MNIST in model space ([-0.5, 0.5])."""

    def __init__(self, inner):
        self.inner = inner

    def sample(self, generator, bs):
        out = self.inner.sample(generator, bs)
        return (out[0] - 0.5, out[1]) if isinstance(out, tuple) else out - 0.5


def _png(path) -> np.ndarray:
    return np.round(read_png(str(path)) * 255).astype(np.uint8)


def test_every_figure_is_written_without_matplotlib(no_matplotlib, tmp_path):
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401
    model = RFN(_cfg(), device="cpu", generator=torch.Generator().manual_seed(1))
    s = t_ev.EvalSettings(n_conditions=NC, n_predictions=NP, resamples=2, n_batches=1,
                          batch_size=B)
    ev = t_ev.Evaluator(model, Shifted(_data()), s, device="cpu",
                        postprocess=lambda a: torch.clamp(a + 0.5, 0, 1))
    p = {n: tmp_path / "figs" / f"{n}.png" for n in
         ("long", "temps", "interp", "params", "rollouts", "diversity", "curves")}

    long = ev.plot_long_rollout(25, str(p["long"]))
    strip = _png(p["long"])
    assert strip.shape == (IMG, 20 * (IMG + 1) - 1)  # a strip holds 20 frames
    for t in (0, 19):
        np.testing.assert_array_equal(strip[:, t * (IMG + 1):t * (IMG + 1) + IMG],
                                      np.rint(long[t, ..., 0] * 255))
    temps = ev.plot_temperatures(temperatures=(0.5, 1.0), path=str(p["temps"]))
    assert len(temps) == 2 and _png(p["temps"]).shape == (2 * IMG, NP * (IMG + 1) - 1)
    assert ev.get_interpolations(n_alphas=3, n_conditions=3, path=str(p["interp"])).shape == (
        3, B, IMG, IMG, 1)
    assert _png(p["interp"]).shape == (IMG, 3 * (IMG + 1) - 1)

    traj = ev.param_plots(Shifted(_data(synchronized=True)), path=str(p["params"]))
    params = _png(p["params"])
    assert params.shape == (240, 300, 3)
    for panel in (params[:120], params[120:]):  # three lines in each panel
        for colour in PALETTE[:3]:
            assert (panel == colour).all(-1).any()
    assert traj["mu_p"].shape == (NC + NP,)

    seq = ev.plot_random_samples(n_sequences=2, n_show=4, path=str(p["rollouts"]))
    grid = _png(p["rollouts"])
    assert grid.shape == (2 * (IMG + 5) - 1, 4 * (IMG + 5) - 1, 3)
    tile = IMG + 5
    np.testing.assert_array_equal(grid[tile + 2:tile + 2 + IMG, 3 * tile + 2:3 * tile + 2 + IMG, 0],
                                  np.rint(seq[1, 3, ..., 0] * 255))
    assert (grid[0, 0] == CONTEXT).all() and (grid[0, (NC - 1) * tile] == CONTEXT).all()
    assert (grid[0, NC * tile] == PREDICTION).all()

    assert ev.plot_diversity(2, str(p["diversity"])).shape == (2, NP, IMG, IMG, 1)
    assert _png(p["diversity"]).shape == (2 * IMG, NP * (IMG + 1) - 1)

    res = ev.get_eval_values(with_lpips=False, save_grids_dir=str(tmp_path / "grids"))
    for name in ("best", "worst"):
        assert _png(tmp_path / "grids" / f"{name}.png").shape == (IMG, NP * (IMG + 1) - 1)
    t_ev.plot_eval_curves({"a": res, "b": dict(res, ssim_best=res["ssim_best"] * 0.5)},
                          str(p["curves"]))
    curves = _png(p["curves"])
    assert curves.shape == (120, 3 * 200, 3)  # ssim, psnr, mse
    assert (curves[:, :200] == PALETTE[1]).all(-1).any()  # the second experiment's line


def test_eval_cli_debug_plot_without_matplotlib(no_matplotlib, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no ./data: synthetic digits
    tcfg = port_config.TrainConfig(batch_size=B, n_frames=NC + NP, digit_size=8, num_digits=1)
    model = RFN(_cfg(), device="cpu", generator=torch.Generator().manual_seed(2))
    Trainer(model, tcfg, [], str(tmp_path), device="cpu").build(run_ddi=False).checkpoint("last")
    payload = port_cli.main([
        "--path", str(tmp_path), "--n_batches", "1", "--batch_size", str(B),
        "--n_conditions", str(NC), "--n_predictions", str(NP), "--resamples", "2",
        "--fvd_embedder", "random3d", "--debug_plot", "--device", "cpu"])
    assert np.isfinite(payload["dataset_bpd"])
    out = tmp_path / "eval"
    shapes = {"best": (IMG, NP * (IMG + 1) - 1), "worst": (IMG, NP * (IMG + 1) - 1),
              "long_rollout": (IMG, 20 * (IMG + 1) - 1),
              "diversity": (4 * IMG, NP * (IMG + 1) - 1),
              "plot_rollouts": (5 * (IMG + 5) - 1, (NC + NP) * (IMG + 5) - 1, 3)}
    for name, shape in shapes.items():
        assert _png(out / f"{name}.png").shape == shape, name

"""``Trainer.fit`` of the port on the CPU, on the port's Moving MNIST
generator (``.sample(generator, batch_size)``, the batch made where the
trainer runs): epochs and counters, ``status.txt`` and ``metrics.jsonl``
written as the JAX ``Trainer.status`` writes them (the JAX method runs on a
JAX trainer holding the same histories, which needs no build), ``last`` on
an early stop off the checkpoint cadence, ``best`` only after epoch 50, a
failing plotter that does not stop training, a failing refresh of the
running statistics that stops the checkpoint, the plotter's PNGs and the
device part of the plots, and a batch given as a tensor staying a tensor.

Size: 32x32 frames, L=2, K=2, U=16 (``test_torch_trainer.py``'s), B=2,
T=3, 16x16 digits.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.training.trainer import Trainer as JTrainer
from recurrent_flows_tpu_torch.data import MovingMNIST
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.training import trainer as trainer_module

IMG, B, T = 32, 2, 3


def _config():
    return U.tiny_rfn_config(
        image_size=IMG, L=2, K=2, glow={"chain_impl": "sample"},
        extractor_structure=((4, "pool", 8), (8, "pool", 16)),
        upscaler_structure=((16,), ("upsample", 8)))


def _tcfg(**kw):
    return dataclasses.replace(U.tiny_train_config(), batch_size=B, n_frames=T,
                               steps_per_epoch=2, n_conditions=2, n_predictions=1,
                               **kw)


@pytest.fixture(scope="module")
def data():
    return MovingMNIST(seq_len=T, image_size=IMG, digit_size=16, num_digits=1,
                       digit_bank="synthetic", device="cpu")


def _trainer(data, workdir, **kw):
    return Trainer(RFN(U.to_port(_config())), U.to_port(_tcfg(**kw)), data, str(workdir),
                   device="cpu").build()


def _lines(path):
    return path.read_text().splitlines()


def test_fit_runs_epochs_and_writes_status_as_jax(data, tmp_path):
    trainer = _trainer(data, tmp_path)
    assert (tmp_path / "png_folder").is_dir() and (tmp_path / "model_folder").is_dir()
    trainer.fit(n_epochs=2, plot=False)
    assert trainer.epoch_i == 2 and trainer.counter == 4 and len(trainer.losses) == 4
    assert all(np.isfinite(trainer.losses))
    folder = tmp_path / "model_folder"
    assert sorted(p.name for p in (folder / "last").iterdir()) == ["meta.json", "state.pt"]
    assert not (folder / "best").exists()
    status, records = _lines(folder / "status.txt"), _lines(folder / "metrics.jsonl")
    assert len(status) == len(records) == 2
    records = [json.loads(r) for r in records]
    assert records[1]["step"] == 4 and records[1]["epoch"] == 2
    assert records[1]["step_stats"]["window_steps"] == 2  # the second epoch's window

    # the JAX status on a JAX trainer holding the same histories and counters
    jt = JTrainer(None, _tcfg(), None, str(tmp_path / "jax"))
    (tmp_path / "jax" / "model_folder").mkdir(parents=True)
    for name in ("kl_hist", "recon_hist", "bits_hist", "counter", "epoch_i"):
        setattr(jt, name, getattr(trainer, name))
    jt.step_timer = trainer.step_timer
    jt.status(records[1]["loss"])
    assert _lines(tmp_path / "jax" / "model_folder" / "status.txt") == status[1:]
    ref = json.loads(_lines(tmp_path / "jax" / "model_folder" / "metrics.jsonl")[0])
    assert ref == records[1]


def test_early_stop_off_the_cadence_saves_last(data, tmp_path):
    trainer = _trainer(data, tmp_path, checkpoint_every=5)
    trainer.early.step = lambda loss: trainer.epoch_i == 2
    trainer.fit(n_epochs=4, plot=False)
    assert trainer.epoch_i == 2
    with open(tmp_path / "model_folder" / "last" / "meta.json") as f:
        assert json.load(f)["epoch"] == 2
    # the stopping epoch writes no status line, as in the JAX package
    assert len(_lines(tmp_path / "model_folder" / "status.txt")) == 1


def test_best_is_saved_only_after_epoch_50(data, tmp_path):
    trainer = _trainer(data, tmp_path)
    trainer.epoch_i = 49
    trainer.fit(n_epochs=1, plot=False)
    assert trainer.epoch_i == 50 and not (tmp_path / "model_folder" / "best").exists()
    trainer.fit(n_epochs=1, plot=False)
    assert (tmp_path / "model_folder" / "best" / "state.pt").is_file()
    assert trainer.best_loss == trainer.early.best_loss < float("inf")


def test_a_failing_plotter_does_not_stop_fit(data, tmp_path, capsys):
    trainer = _trainer(data, tmp_path)

    def broken():
        raise RuntimeError("no display")

    trainer.plotter = broken
    trainer.fit(n_epochs=2)
    assert trainer.epoch_i == 2 and trainer.counter == 4
    assert capsys.readouterr().out.count("plotter failed") == 2


def test_a_failing_refresh_stops_the_checkpoint(data, tmp_path):
    trainer = _trainer(data, tmp_path)

    def broken():
        raise RuntimeError("kernel refused the shape")

    trainer.refresh_stats = broken
    with pytest.raises(RuntimeError, match="kernel refused"):
        trainer.checkpoint("last")
    assert not (tmp_path / "model_folder" / "last").exists()


def test_plotter_writes_its_pngs_and_rows(data, tmp_path):
    pytest.importorskip("matplotlib")
    trainer = _trainer(data, tmp_path)
    trainer.fit(n_epochs=1)
    png = tmp_path / "png_folder"
    assert (png / "losses.png").stat().st_size > 0
    assert (png / "samples0.png").stat().st_size > 0 and trainer.plot_counter == 1
    rows = dict(trainer.plot_rows())
    assert list(rows) == ["true", "sample|frame0", "prediction", "recon", "recon-bijection"]
    shapes = {"true": T, "sample|frame0": T, "prediction": 3, "recon": T - 1,
              "recon-bijection": T - 1}
    for name, arr in rows.items():
        assert arr.dtype == np.uint8 and arr.shape == (shapes[name], B, IMG, IMG, 1), name


def test_a_tensor_batch_makes_no_trip_through_numpy(data, tmp_path, monkeypatch):
    trainer = _trainer(data, tmp_path)
    batch = data.sample(torch.Generator().manual_seed(0), B)
    assert isinstance(batch, torch.Tensor)

    def no_numpy(*args, **kwargs):
        raise AssertionError("the batch went through numpy")

    monkeypatch.setattr(trainer_module.np, "asarray", no_numpy)
    m = trainer.train_step(batch, beta=0.5, lr=1e-4)
    assert np.isfinite(float(m["loss"]))

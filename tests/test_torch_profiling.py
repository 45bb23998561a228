"""``utils.profiling.trace`` and ``Trainer.train_epoch(profile_dir=...)`` on
the CPU: ``None`` records nothing, a folder gets a Chrome trace that
parses as JSON and holds the step's operators and its ``train.*`` spans."""

import json

import torch

from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.utils.profiling import trace


def test_trace_none_is_a_no_op(tmp_path):
    with trace(None):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


def test_train_epoch_writes_a_trace(tmp_path):
    model = torch.nn.Linear(2, 1)
    model.cfg = None
    model.loss = lambda x, noise: dict(nll=model(x).square().mean(), kl=torch.zeros(()),
                                       kl_free_bits=torch.zeros(()))
    batch = torch.rand(2, 3, 2, 2, 2)  # [B, T, H, W, C] in [0, 1]
    trainer = Trainer(model, _tcfg(), [batch], device="cpu").build()
    trainer.train_epoch(1, profile_dir=str(tmp_path / "prof"))
    assert trainer.counter == 1
    files = list((tmp_path / "prof").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::addmm" for e in events)
    # the step's spans (no clip: grad_clip is 0)
    spans = sorted((e["ts"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("name", "").startswith("train."))
    assert [n for _, n in spans] == [
        "train.forward", "train.backward", "train.adam"]


def _tcfg():
    from recurrent_flows_tpu_torch.config import TrainConfig

    return TrainConfig(batch_size=2, n_frames=3, steps_per_epoch=1)

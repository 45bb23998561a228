"""Every cell run whole on the CPU at a tiny size (``tiny.py``): the plain
reference agrees with ``recurrent_flows_tpu_torch`` and the run comes out
correct; with the timed path broken underneath, the same run comes out
not correct, once for each fault the cell can have. The look for a card
is the only part of a run these leave out."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 31 + 4321
TRAIN = ["rfn_mnist.train_b720", "srnn_mnist.train_b128"]
PREDICT = ["rfn_mnist.rollout_b64", "rfn_mnist.serve_b64"]


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def run(workload, trace=False):
    return harness.run_cell(tiny_cell(workload), SEED, 0.2, trace, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("workload", TRAIN + PREDICT)
def test_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {m["name"] for m in tiny_cell(workload).end_to_end}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", ["srnn_mnist.train_b128", "rfn_mnist.serve_b64"])
def test_traced_run_reads_the_trace(workload):
    out = run(workload, trace=True)
    assert out["correct"]
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here: only the FLOP share has something to read
    assert set(out["metrics"]) <= {m["name"] for m in tiny_cell(workload).per_layer}


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from recurrent_flows_tpu_torch import models

    for cls in (models.RFN, models.SRNN):
        loss = cls.loss
        monkeypatch.setattr(cls, "loss",
                            lambda self, x, noise, _l=loss: _l(self, x[: x.shape[0] // 2], noise))


def _answer_altered(monkeypatch):
    from recurrent_flows_tpu_torch.serving import Predictor

    predict = Predictor.predict

    def altered(self, *a, **k):
        out = predict(self, *a, **k)
        out[0, -1, 0, 0, 0] += 0.25
        return out

    monkeypatch.setattr(Predictor, "predict", altered)


@pytest.mark.parametrize("workload,fault", [(w, f) for w in TRAIN
                                            for f in (_state_unchanged, _half_batch)]
                         + [(w, _answer_altered) for w in PREDICT])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run(workload)
    assert not out["correct"], out["checks"]

"""The program's spans (``utils.profiling.span``) on the CPU, on the
smallest RFN of the port's tests (16x16 frames, L=2, K=1, B=2):

* a ``Trainer.train_step`` under ``torch.profiler`` holds ``train.forward``,
  ``train.backward``, ``train.clip`` and ``train.adam`` once each, in that
  order; RFN's per-frame ``rfn.step`` opens T-1 times in the forward and,
  with ``remat``, T-1 times more inside ``train.backward``;
* ``Predictor.predict`` holds ``serve.*`` once each, ``rfn.posterior_scan``
  and ``rfn.prepare_chain`` once, ``rfn.rollout.frame`` and ``glow.sample``
  once a predicted frame;
* with no profiler recording, ``span`` enters no recorder; an exported
  serving graph holds no profiler operator, even exported under a profiler;
* ``SpanReading`` on made-up events: launches belong to every span open on
  any thread when they start, device operations to their launch by
  correlation id, ranges copied onto the device's timeline are no device
  operations, and the idle gaps are named by the innermost span.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.serving import Predictor
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.utils import profiling
from recurrent_flows_tpu_torch.utils.profiling import SpanReading, span

B, T, N_COND, N_PRED = 2, 4, 2, 3
TRAIN = ("train.forward", "train.backward", "train.clip", "train.adam")


def _model(remat: bool = True):
    cfg = U.to_port(U.tiny_rfn_config(
        image_size=16, L=2, K=1, extractor_structure=((4, "pool", 8), (8, "pool", 8)),
        upscaler_structure=((8,), ("upsample", 4))))
    return RFN(cfg, remat=remat, generator=torch.Generator().manual_seed(0))


def _trainer(remat: bool = True):
    tcfg = dataclasses.replace(U.to_port(U.tiny_train_config()), batch_size=B, n_frames=T,
                               grad_clip=100.0)
    return Trainer(_model(remat), tcfg, None, device="cpu").build(run_ddi=False)


def _frames(t: int, seed: int = 0):
    return np.random.default_rng(seed).uniform(0, 1, (B, t, 16, 16, 1)).astype(np.float32)


def _traced(fn) -> SpanReading:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return SpanReading.of(prof)


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_spans(remat):
    trainer = _trainer(remat)
    batch = _frames(T)
    r = _traced(lambda: trainer.train_step(batch, 1.0, 1e-4))
    train = [span for span in r.spans if span[2].startswith("train.")]
    assert [name for _, _, name in train] == list(TRAIN)
    assert all(e0 <= s1 for (_, e0, _), (s1, _, _) in zip(train, train[1:]))
    (fs, fe, _), (bs, be, _) = train[:2]
    steps = [(s, e) for s, e, name in r.spans if name == "rfn.step"]
    assert sum(fs <= s and e <= fe for s, e in steps) == T - 1
    assert sum(bs <= s and e <= be for s, e in steps) == (T - 1 if remat else 0)
    table = r.table()
    assert table["rfn.unroll"]["count"] == 1 and table["rfn.convlstm_scan"]["count"] == 1
    assert table["glow.log_prob"]["count"] == (T - 1) * (2 if remat else 1)
    assert table["glow.f.l0"]["count"] == table["glow.f.l1"]["count"] == \
        table["glow.log_prob"]["count"]
    assert "rfn.overshoot_kl" not in table and "train.dp_reduce" not in table
    assert r.launches() == 0 and r.busy_s() == 0.0  # no card


def test_predict_spans():
    pred = Predictor(_model(), U.to_port(U.tiny_train_config()), n_conditions=N_COND,
                     n_predictions=N_PRED, device="cpu")
    table = _traced(lambda: pred.predict(_frames(N_COND))).table()
    counts = {name: row["count"] for name, row in table.items()}
    assert counts["rfn.rollout.frame"] == counts["glow.sample"] == counts["rfn.lstm"] == N_PRED
    for name in ("serve.to_model_space", "serve.model", "serve.to_image_space",
                 "rfn.posterior_scan", "rfn.unroll", "rfn.prepare_chain"):
        assert counts[name] == 1, name
    # the context's extractor call, then one a predicted frame
    assert counts["rfn.extract"] == 1 + N_PRED
    assert counts["glow.g.l0"] == counts["glow.g.l1"] == N_PRED


def test_no_recorder_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} recorded with no profiler on")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert span("train.forward") is span("glow.f.l", 3)
    trainer = _trainer()
    trainer.train_step(_frames(T), 1.0, 1e-4)
    Predictor(trainer.model, trainer.tcfg, n_conditions=N_COND, n_predictions=N_PRED,
              device="cpu").predict(_frames(N_COND))


@pytest.mark.parametrize("profiled", [False, True])
def test_export_graph_holds_no_profiler_op(profiled):
    pred = Predictor(_model(), U.to_port(U.tiny_train_config()), n_conditions=N_COND,
                     n_predictions=N_PRED, device="cpu")
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            blob = pred.export(batch_size=B)
        assert "rfn.rollout.frame" in SpanReading.of(prof).table()
    else:
        blob = pred.export(batch_size=B)
    from recurrent_flows_tpu_torch.serving import load_exported

    graph = load_exported(blob).program.graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record" in t]


# -- SpanReading on made-up events -------------------------------------------


def _reading():
    """Thread 1 opens train.forward [0, 100) and train.backward [100, 300);
    thread 2 runs the backward's rfn.step [120, 200) inside it. Four
    launches and a copy, their device operations queued on one stream."""
    spans = [(0, 100, "train.forward"), (100, 300, "train.backward"),
             (120, 200, "rfn.step"), (300, 400, "train.adam")]
    calls = [(10, 1, "cudaLaunchKernel"), (130, 2, "cudaLaunchKernel"),
             (150, 3, "cudaMemcpyAsync"), (250, 4, "cuLaunchKernel"),
             (350, 5, "cudaLaunchKernel"), (450, 6, "cudaLaunchKernel")]
    ops = [(20, 60, "k1", 1), (200, 230, "k2", 2), (230, 240, "Memcpy DtoD", 3),
           (260, 300, "k4", 4), (600, 650, "k5", 5), (700, 710, "k6", 6)]
    return SpanReading(spans, calls, ops)


def test_reading_attributes_launches_by_time_on_any_thread():
    r = _reading()
    assert r.launches() == 5  # the copy is no launch
    assert r.launches_in("train.forward") == 1
    assert r.launches_in("train.backward") == 2  # thread 2's, inside thread 1's span
    assert r.launches_in("rfn.step") == 1
    assert r.launches_in("train.") == 4 and r.launches_in("") == 4  # 450 is in none
    assert r.count("train.") == 3 and r.count("glow.") == 0
    assert r.launches_in("glow.") == 0 and r.device_s_in("glow.") == 0.0


def test_reading_follows_correlation_to_the_device():
    r = _reading()
    assert r.device_s_in("train.forward") == pytest.approx(40e-9)
    # k2 and the copy, queued inside rfn.step, run after it closed
    assert r.device_s_in("rfn.step") == pytest.approx(40e-9)
    assert r.device_s_in("train.backward") == pytest.approx(80e-9)
    assert r.device_s_in("train.adam") == pytest.approx(50e-9)
    assert r.busy_s() == pytest.approx(180e-9)
    t = r.table()
    assert t["train.backward"] == dict(count=1, launches=2, device_s=pytest.approx(80e-9))


def test_reading_sums_named_kernels_by_span():
    """``table(kernels)`` and ``busy_s(kernels)`` keep to the operations
    whose names hold one of ``kernels`` (the script's ``transpose_ms``)."""
    r = _reading()
    t = r.table(("k2", "k4"))
    assert t["train.backward"]["kernels_s"] == pytest.approx(70e-9)  # not the copy
    assert t["rfn.step"]["kernels_s"] == pytest.approx(30e-9)
    assert t["train.forward"]["kernels_s"] == 0.0
    assert r.busy_s(("k2", "k5")) == pytest.approx(80e-9)
    assert "kernels_s" not in r.table()["train.backward"]


def test_reading_names_idle_gaps_by_the_innermost_span():
    gaps = dict(_reading().idle_gaps())
    # 60->200 ends at k2 (launched in rfn.step), 240->260 at k4 (in
    # train.backward), 300->600 at k5 (train.adam), 650->700 at k6 (none)
    assert gaps == pytest.approx({"rfn.step": 140e-9, "train.backward": 20e-9,
                                  "train.adam": 300e-9, "": 50e-9})


class _Event:
    def __init__(self, name, device, start, end, corr, annotation=False):
        self._v = (name, device, start, end, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_reading_of_a_profile_keeps_annotations_off_the_device():
    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
    events = [_Event("train.adam", cpu, 0, 100, 7),
              _Event("aten::mul", cpu, 5, 40, 8),
              _Event("Optimizer.step#Adam.step", cpu, 1, 99, 9, annotation=True),
              _Event("cudaLaunchKernel", cpu, 10, 12, 11),
              _Event("cudaStreamSynchronize", cpu, 50, 90, 12),
              _Event("Optimizer.step#Adam.step", cuda, 20, 80, 9, annotation=True),
              _Event("multi_tensor_apply_kernel", cuda, 20, 30, 11)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    r = SpanReading.of(prof)
    assert r.spans == [(0, 100, "train.adam")]
    assert [name for *_, name in r.calls] == ["cudaLaunchKernel", "cudaStreamSynchronize"]
    assert r.ops == [(20, 30, "multi_tensor_apply_kernel", 11)]
    assert r.busy_s() == pytest.approx(10e-9)
    assert r.table()["train.adam"] == dict(count=1, launches=1, device_s=pytest.approx(10e-9))

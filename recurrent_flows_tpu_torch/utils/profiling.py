"""Step timing, tracing and the program's spans, the counterparts of
``StepTimer`` and ``trace`` in ``recurrent_flows_tpu.utils.profiling``.

``trace(profile_dir)`` records a region with ``torch.profiler`` (host
operators, and the CUDA kernels where there is a card) and writes a Chrome
trace, ``<profile_dir>/<host>_<pid>.<ms>.pt.trace.json``, which
TensorBoard's profiler plugin and Perfetto read; ``None`` records nothing.
``Trainer.train_epoch(profile_dir=...)`` records its epoch so.

``span(name)`` marks a phase of the program in whatever ``torch.profiler``
trace is recording (``trace``'s, or any other caller's); where none is, it
is a shared do-nothing context (~0.2 us on a CPU core) and records nothing.
The spans, by the place that opens them:

- ``Trainer.train_step``: ``train.forward`` (``model.loss`` and the loss
  sum), ``train.backward`` (``loss.backward()``, where RFN's per-frame
  steps are recomputed), ``train.dp_reduce`` (data-parallel only),
  ``train.clip``, ``train.adam``;
- ``RFN``: ``rfn.unroll`` (features and the ConvLSTM scans, inside it
  ``rfn.convlstm_scan``), ``rfn.extract`` (each extractor call),
  ``rfn.step`` (one frame of ``loss``, again when recomputed),
  ``rfn.posterior_prior``, ``rfn.flow_conditions`` (the upscaler),
  ``rfn.overshoot_kl``, ``rfn.posterior_scan`` (the context of a
  rollout), ``rfn.prepare_chain`` (the chain kernel's stacked parameters,
  once a rollout), ``rfn.rollout.frame`` (one predicted frame, inside it
  ``rfn.lstm`` and ``rfn.prior``);
- ``ListGlow``: ``glow.log_prob``, ``glow.sample``, and each scale l of
  ``f`` and ``g``, ``glow.f.l<l>`` and ``glow.g.l<l>``;
- ``Predictor.predict``: ``serve.to_model_space``, ``serve.model``,
  ``serve.to_image_space`` (which holds the wait for the frames' copy to
  the host).

In the Chrome trace the spans are ranges on the host threads that opened
them; the backward's, and with it the recomputed steps', run on the
autograd engine's thread on a card. ``SpanReading.of(prof)`` reads a
finished profile by span: how often each opened, the kernel launches that
started inside it and the device time of the kernels they launched.

Two measurements, because a step's host time under asynchronous launches
says when the step was queued, not when it ran:

- ``note_window(n_steps, elapsed_s)``: an epoch's step count over its wall
  time, the caller having waited for the device at the window's end (it
  reads the metrics): the sustained steps/s.
- ``start()``/``stop(result)``: a sampled wait for the device (``.item()``
  on the step's metric, or ``torch.cuda.synchronize``), which drains every
  step queued before it: its latency, reported as ``drain_*`` and never
  inverted into a rate.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import heapq
import time

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast

# host calls that put a kernel on the device's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
# the first part of every name given to ``span``
SPAN_LAYERS = ("train.", "rfn.", "glow.", "serve.")
# parts of the names of cuDNN's own layout transposes, which it runs around
# an NCHW kernel it is handed channels-last memory for
TRANSPOSE_KERNELS = ("nhwcToNchw", "nchwToNhwc")

_OFF = contextlib.nullcontext()


class StepTimer:
    def __init__(self):
        self.times: list = []  # sampled drain latencies, s
        self.windows: list = []  # (n_steps, elapsed_s)
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """Stop the drain clock after the device has finished ``result`` (a
        tensor of the step), or everything queued on the card."""
        if isinstance(result, torch.Tensor):
            result.item()
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def note_window(self, n_steps: int, elapsed_s: float):
        if n_steps > 0 and elapsed_s > 0:
            self.windows.append((n_steps, elapsed_s))

    def stats(self) -> dict:
        """steps_per_s over the windows after the first (which pays the
        warm-up), and the drain latencies after the first sample."""
        out: dict = {}
        if self.windows:
            w = self.windows[1:] or self.windows
            n = sum(s for s, _ in w)
            t = sum(e for _, e in w)
            out.update(steps_per_s=float(n / t), window_steps=int(n),
                       window_s=float(t), n_windows=len(w))
        if self.times:
            a = np.asarray(self.times[1:] or self.times)
            out.update(drain_mean_s=float(a.mean()),
                       drain_p50_s=float(np.percentile(a, 50)),
                       drain_p95_s=float(np.percentile(a, 95)),
                       drain_n=len(a))
        return out


@contextlib.contextmanager
def trace(profile_dir: str | None):
    """Record the block under ``torch.profiler`` (CPU, and CUDA where a card
    is available) into a Chrome trace under ``profile_dir``; a no-op with
    ``None``."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield


def span(name: str, index: int | None = None):
    """``name`` (with ``index`` appended: a flow scale's) as a range of the
    recording ``torch.profiler`` trace, or a shared do-nothing context
    where none records, the name then never built. The range is a
    function-scope record, which Kineto does not copy onto the device's
    timeline as a ``gpu_user_annotation``, so a trace's device events stay
    kernels, copies and sets; and no operator, so ``torch.export`` puts
    nothing of it in a graph."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name if index is None else f"{name}{index}")


@dataclasses.dataclass
class SpanReading:
    """A finished ``torch.profiler`` profile read by the program's spans.

    A CUDA call belongs to every span open, on any thread, when it starts:
    the caller's thread sits inside ``train.backward`` while the autograd
    engine's thread launches the backward. A device operation belongs where
    the call that queued it does, found by their shared correlation id."""

    spans: list  # (start_ns, end_ns, name) of each span opened, on any thread
    calls: list  # (start_ns, correlation_id, name) of each CUDA API call (cuda*, cu*)
    ops: list  # (start_ns, end_ns, name, correlation_id) of each device operation

    @classmethod
    def of(cls, prof) -> "SpanReading":
        """The reading of ``prof`` (a ``torch.profiler.profile`` that has
        stopped). Ranges that Kineto copies onto the device's timeline
        (``gpu_user_annotation``, from ``record_function``) are no device
        operations and are left out."""
        spans, calls, ops = [], [], []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            if str(ev.device_type()).endswith("CUDA"):
                if not ev.is_user_annotation():
                    ops.append((ev.start_ns(), ev.end_ns(), name, ev.correlation_id()))
            elif name.startswith(SPAN_LAYERS):
                spans.append((ev.start_ns(), ev.end_ns(), name))
            elif name.startswith("cu"):
                calls.append((ev.start_ns(), ev.correlation_id(), name))
        return cls(sorted(spans), sorted(calls), sorted(ops))

    def _calls_in(self, match) -> list:
        """The calls that start inside a span whose name ``match`` accepts."""
        merged = []
        for s, e, name in self.spans:
            if not match(name):
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts = [s for s, _ in merged]
        out = []
        for call in self.calls:
            i = bisect.bisect_right(starts, call[0]) - 1
            if i >= 0 and call[0] < merged[i][1]:
                out.append(call)
        return out

    @staticmethod
    def _launches(calls) -> int:
        return sum(1 for _, _, name in calls if name in LAUNCH_CALLS)

    def _device_s(self, calls, kernels: tuple = ()) -> float:
        corr = {c for _, c, _ in calls}
        return _union_s((s, e) for s, e, name, c in self.ops
                        if c in corr and _named(name, kernels))

    def count(self, prefix: str) -> int:
        """Spans opened whose name starts with ``prefix``."""
        return sum(1 for _, _, name in self.spans if name.startswith(prefix))

    def launches(self) -> int:
        return self._launches(self.calls)

    def launches_in(self, prefix: str) -> int:
        """Kernel launches that started inside a span named ``prefix...``
        (``""``: inside any span)."""
        return self._launches(self._calls_in(lambda name: name.startswith(prefix)))

    def device_s_in(self, prefix: str) -> float:
        """Seconds of the union of the device operations queued inside a
        span named ``prefix...``."""
        return self._device_s(self._calls_in(lambda name: name.startswith(prefix)))

    def busy_s(self, kernels: tuple = ()) -> float:
        """Seconds of the union of every device operation; with
        ``kernels``, of those whose names hold one of them."""
        return _union_s((s, e) for s, e, name, _ in self.ops if _named(name, kernels))

    def table(self, kernels: tuple = ()) -> dict:
        """{span name: dict(count, launches, device_s)}, each name's own
        ranges (a nested span counts in its parent's row too); with
        ``kernels`` a row also has ``kernels_s``, the device seconds of the
        span's operations whose names hold one of them."""
        out = {}
        for name in sorted({name for _, _, name in self.spans}):
            calls = self._calls_in(lambda n, name=name: n == name)
            out[name] = dict(count=sum(1 for _, _, n in self.spans if n == name),
                             launches=self._launches(calls), device_s=self._device_s(calls))
            if kernels:
                out[name]["kernels_s"] = self._device_s(calls, kernels)
        return out

    def idle_gaps(self, limit: int = 10) -> list:
        """The longest gaps between device operations, summed by the
        innermost span open when the call that queued the operation ending
        the gap started ("" where none was): [[name, seconds], ...]."""
        start_of = {c: t for t, c, _ in self.calls}
        gaps, end = [], None
        for s, e, _, c in self.ops:
            if end is not None and s > end and c in start_of:
                gaps.append((start_of[c], s - end))
            end = e if end is None else max(end, e)
        gaps.sort()
        by_name = {}
        for name, (_, dt) in zip(self._innermost([t for t, _ in gaps]), gaps):
            by_name[name] = by_name.get(name, 0) + dt
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:limit]
        return [[name, dt / 1e9] for name, dt in top]

    def _innermost(self, times) -> list:
        """For each of ``times`` (ascending), the name of the latest-opened
        span still open then, on any thread, or ""."""
        out, open_, i = [], [], 0
        for t in times:
            while i < len(self.spans) and self.spans[i][0] <= t:
                s, e, name = self.spans[i]
                heapq.heappush(open_, (-s, e, name))
                i += 1
            while open_ and open_[0][1] <= t:
                heapq.heappop(open_)
            out.append(open_[0][2] if open_ else "")
        return out


def _named(name: str, kernels: tuple) -> bool:
    """``name`` holds one of ``kernels`` (any name where there are none)."""
    return not kernels or any(k in name for k in kernels)


def _union_s(intervals) -> float:
    """Seconds covered by the union of [start_ns, end_ns) intervals."""
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s >= end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return busy / 1e9

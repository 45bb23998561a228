"""Step timing and tracing, the counterparts of ``StepTimer`` and
``trace`` in ``recurrent_flows_tpu.utils.profiling``.

``trace(profile_dir)`` records a region with ``torch.profiler`` (host
operators, and the CUDA kernels where there is a card) and writes a Chrome
trace, ``<profile_dir>/<host>_<pid>.<ms>.pt.trace.json``, which
TensorBoard's profiler plugin and Perfetto read; ``None`` records nothing.

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

import contextlib
import time

import numpy as np
import torch


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

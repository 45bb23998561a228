"""Entry ``predict``: the program's serving call, ``Predictor.predict``
(context frames in [0, 1] -> predicted frames on the host), one client,
closed loop, back to back, on a pool of contexts made on the device from
the seed and cycled. Request i's noise comes from a generator seeded from
(seed, i).

The check: a sample of ``check_requests`` of the window's requests,
drawn from the seed (the smallest of a hash of (seed, i)), kept as they
were served; after the window the reference predicts each from the same
context, weights and draws.
"""

from __future__ import annotations

import heapq
import time

import numpy as np

from benchmark import compare, flops, harness, program, traffic, weights, yardstick
from benchmark.reference.common import Draws, precision
from benchmark.seeds import derive
from benchmark.window import Window


class Entry:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.ref = harness.reference(cell)
        t = cell.traffic
        self.n_cond, self.n_pred = t["n_conditions"], t["n_predictions"]
        self.keep = []  # heap of (-pick, i, frames) of the sampled requests
        self.phases = program.Phases(device)
        self.i = 0

    def setup(self):
        from recurrent_flows_tpu_torch.serving import Predictor

        t = self.cell.traffic
        model, tcfg = program.build(self.cell, self.seed, self.device, self.ref, self.phases)
        self.predictor = Predictor(model, tcfg, n_conditions=self.n_cond,
                                   n_predictions=self.n_pred, device=self.device)
        self.pool = traffic.pool(dict(t, frames=self.n_cond), self.cell.config["model"],
                                 derive(self.seed, "traffic"), self.device)
        self.phases.mark("predictor and inputs")
        for w in range(t["warmup"]):
            self.predictor.predict(self.pool[w % len(self.pool)],
                                   noise=program.noise(derive(self.seed, f"warmup{w}"),
                                                       self.device))
            self.phases.mark(f"warm-up request {w + 1}", sync=True)

    def request(self, sample: bool = True):
        i = self.i
        self.i += 1
        frames = self.predictor.predict(self.pool[i % len(self.pool)],
                                        noise=program.noise(derive(self.seed, f"req{i}"),
                                                            self.device))
        if sample:
            item = (-derive(self.seed, f"pick{i}"), i, frames)
            if len(self.keep) < self.cell.traffic["check_requests"]:
                heapq.heappush(self.keep, item)
            elif item > self.keep[0]:
                heapq.heapreplace(self.keep, item)
        return frames

    def window(self, seconds: float) -> Window:
        lat, failed = [], 0
        yardstick.sync(self.device)
        t0 = time.perf_counter()
        while not lat or time.perf_counter() - t0 < seconds:
            t_req = time.perf_counter()
            frames = self.request()
            lat.append(time.perf_counter() - t_req)
            failed += int(not np.isfinite(frames).all())
        dt = time.perf_counter() - t0
        b = self.cell.traffic["batch"]
        self.window_result = Window(attempted=len(lat), failed=failed, seconds=dt,
                                    frames=len(lat) * b * self.n_pred, latencies=lat)
        return self.window_result

    def traced(self, units: int):
        return yardstick.profile(lambda: self.request(sample=False), units, self.window_result, self.cell, self.device)

    def release(self):
        del self.predictor

    def reference_frames(self, i: int, tf32: bool = False):
        cfg, tcfg = self.cell.config["model"], self.cell.config["train"]
        p = self._weights
        with precision(tf32):
            out = self.ref.predict(p, cfg, tcfg, self.pool[i % len(self.pool)], self.n_cond,
                                   self.n_pred, Draws(derive(self.seed, f"req{i}"), self.device))
        return out.cpu().numpy()

    def check(self) -> dict:
        self._weights = weights.make(self.ref, self.cell.config["model"], self.seed,
                                     self.device)
        self.ref_frames = {i: self.reference_frames(i) for _, i, _ in self.keep}
        pairs = [(frames, self.ref_frames[i]) for _, i, frames in sorted(self.keep)]
        self.where = dict(requests=[i for _, i, _ in sorted(self.keep)],
                          per_frame=compare.frame_profile(pairs))
        return compare.frame_numbers(pairs)

    def flops_per_unit(self) -> float:
        t = self.cell.traffic
        return flops.request(self.ref, self.cell.config["model"], self.cell.config["train"],
                             t["batch"], self.n_cond, self.n_pred)

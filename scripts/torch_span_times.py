#!/usr/bin/env python3
"""The port's spans (``utils.profiling.span``) read on the card, in a
benchmark cell: device time and kernel launches per unit (training step or
request), by span.

    python3 scripts/torch_span_times.py --workload rfn_mnist.train_b720 --seed 7 \
        [--seconds 5] [--units N] [--out NAME]

Builds the cell as ``benchmark/run.py`` does (its entry, configuration,
weights and inputs from the seed), runs its set-up and a short window (the
warm-up), then ``--units`` more units (default: the traffic's
``trace_units``) under ``torch.profiler``, read by
``utils.profiling.SpanReading``. Prints one JSON line and writes it to
``chiprun_out/span_times_<NAME>.json``: per unit, the device's busy time,
launches and the share of them inside a span, each span's count, launches
and device ms, the phase sums (``forward_ms``, ``backward_ms``,
``optimizer_ms`` = clip + Adam, ``optimizer_launches``, ``flow_forward_ms``,
``prepare_chain_launches``, ``frame_launches`` a predicted frame), the
device ms of cuDNN's layout transposes (``transpose_ms``: in all, and per
span; ``utils.profiling.TRANSPOSE_KERNELS``), the idle gaps named by span, and the device events of ``record_function``
ranges that the trace holds (``gpu_user_annotation``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from recurrent_flows_tpu_torch.utils.profiling import (  # noqa: E402
    TRANSPOSE_KERNELS, SpanReading)


def read(prof, units: int, n_pred: int | None) -> dict:
    r = SpanReading.of(prof)
    ms = {name: 1e3 * r.device_s_in(name) / units for name in (
        "train.forward", "train.backward", "train.clip", "train.adam", "glow.log_prob")}
    out = dict(units=units, busy_ms=1e3 * r.busy_s() / units, launches=r.launches() / units,
               in_spans=r.launches_in("") / max(r.launches(), 1),
               transpose_ms=1e3 * r.busy_s(TRANSPOSE_KERNELS) / units,
               spans={name: dict(count=row["count"] / units, launches=row["launches"] / units,
                                 device_ms=1e3 * row["device_s"] / units,
                                 transpose_ms=1e3 * row["kernels_s"] / units)
                      for name, row in r.table(TRANSPOSE_KERNELS).items()},
               idle_gaps_by_span=r.idle_gaps())
    if r.count("train."):
        out.update(forward_ms=ms["train.forward"], backward_ms=ms["train.backward"],
                   optimizer_ms=ms["train.clip"] + ms["train.adam"],
                   optimizer_launches=(r.launches_in("train.clip")
                                       + r.launches_in("train.adam")) / units,
                   flow_forward_ms=ms["glow.log_prob"])
        out["phases_over_busy"] = (out["forward_ms"] + out["backward_ms"]
                                   + out["optimizer_ms"]) / out["busy_ms"]
    if r.count("rfn.prepare_chain"):
        out["prepare_chain_launches"] = r.launches_in("rfn.prepare_chain") / units
    if n_pred and r.count("rfn.rollout.frame"):
        out["frame_launches"] = r.launches_in("rfn.rollout.frame") / (units * n_pred)
    annotations = {}
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA") and ev.is_user_annotation():
            annotations[ev.name()] = annotations.get(ev.name(), 0) + 1
    out["device_annotations"] = annotations
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from torch.profiler import ProfilerActivity, profile

    cell = harness.resolve(args.workload, harness.load_manifest())
    harness.require_cuda(cell.chips)
    device = torch.device("cuda", 0)
    entry = harness.load_file("entries", cell.traffic["entry"]).Entry(cell, args.seed, device)
    entry.setup()
    window = entry.window(args.seconds)
    units = args.units or cell.traffic["trace_units"]
    unit = entry.step if hasattr(entry, "step") else (lambda: entry.request(sample=False))
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            unit()
        torch.cuda.synchronize(device)
        traced_s = time.perf_counter() - t0
    out = dict(workload=cell.name, seed=args.seed, card=torch.cuda.get_device_name(device),
               torch=torch.__version__, untraced_ms=1e3 * window.seconds / window.attempted,
               traced_ms=1e3 * traced_s / units,
               **read(prof, units, cell.traffic.get("n_predictions")))
    line = json.dumps(out)
    print(line, flush=True)
    dest = ROOT / "chiprun_out" / f"span_times_{args.out or cell.name}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")


if __name__ == "__main__":
    main()

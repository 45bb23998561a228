"""The readings the limits are set from, at a cell's own size, on the card:

* lower: the program against the reference, per seed;
* control: the reference computed with TF32 on (the precision one step
  below the configurations' float32 with TF32 off) in the program's
  place, against the reference;
* fault (training cells): the reference with half of each batch left out
  of the loss, in the program's place.

    python3 benchmark/calibrate.py --workload rfn_mnist.train_b720 \
        --seeds 1 2 3 ... --control 3 --fault 3

prints one JSON line per seed and reading. The benchmark's runs never run
this; ``tests/test_benchmark_control.py`` runs it at a small size.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import compare, harness  # noqa: E402


def half_batch(loss):
    """The loss over the first half of the batch alone (its mean over them)."""
    return lambda p, cfg, x, draws, **kw: loss(p, cfg, x[: x.shape[0] // 2], draws, **kw)


def readings(cell, seed: int, device, control: bool, fault: bool):
    """[(kind, numbers)] of one seed."""
    entry = harness.load_file("entries", cell.traffic["entry"]).Entry(cell, seed, device)
    entry.setup()
    train = cell.traffic["entry"] == "train"
    if not train:
        for _ in range(cell.traffic["check_requests"]):
            entry.request()
    entry.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = [("lower", entry.check())]
    if train:
        ref = entry.ref_steps
        if control:
            numbers, where = compare.train_numbers(entry.reference_steps(tf32=True), ref)
            out.append(("control", dict(numbers, loss_gaps=where["loss_gaps"])))
        if fault:
            out.append(("half_batch", compare.train_numbers(
                entry.reference_steps(fault=half_batch), ref)[0]))
    elif control:
        pairs = [(entry.reference_frames(i, tf32=True), entry.ref_frames[i])
                 for _, i, _ in sorted(entry.keep)]
        out.append(("control", dict(compare.frame_numbers(pairs),
                                    per_frame=compare.frame_profile(pairs))))
    out.append(("where", getattr(entry, "where", {})))
    return out


def main(argv=None, cell=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds (the first) with the control")
    ap.add_argument("--fault", type=int, default=3, help="seeds (the first) with the fault")
    args = ap.parse_args(argv)
    if cell is None:
        cell = harness.resolve(args.workload, harness.load_manifest())
        harness.require_cuda(cell.chips)
        device = torch.device("cuda", 0)
    rows = []
    for n, seed in enumerate(args.seeds):
        for kind, numbers in readings(cell, seed, device, n < args.control, n < args.fault):
            row = dict(workload=cell.name, seed=seed, kind=kind, numbers=numbers)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()

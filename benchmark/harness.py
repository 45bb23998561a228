"""The benchmark's runner: reads ``BENCHMARK.json``, finds a cell's
configuration, traffic, entry, limits and metric readers by name, runs the
cell once and prints its result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name the manifest gives it:

* ``configs/<config>.json`` (the manifest's ``file``): the model and train
  configuration as run, its source and cuts, its family and reference;
* ``traffic/<traffic>.json``: the entry it drives and its sizes;
* ``entries/<entry>.py``: the code that makes one kind of call (a train step, a
  request);
* ``limits/<workload>.json``: the limit of each number the check compares;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader each,
  ``read(window)`` or ``read(reading)``, returning a number or None.

A run: set-up (timed from the process start to the first timed call),
the window, with ``--trace 1`` one profiled part after it, then the
program is freed and the check against the plain reference runs.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import yardstick

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "recurrent_flows_tpu")


@dataclasses.dataclass
class Cell:
    """One workload, resolved: its entry in the manifest and its files."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # manifest entries of the cell's end-to-end metrics
    per_layer: list  # manifest entries of the cell's per-layer metrics
    chips: int = 1


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str, e2e_names: set | None = None) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def resolve(workload: str, manifest: dict, root: Path = ROOT) -> Cell:
    """The cell named ``workload``, with every file it names read."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _applies(m, workload, names)]
    bench = root / "benchmark"
    return Cell(name=workload, config=_read_json(root / configs[w["config"]]["file"]),
                traffic=_read_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=_read_json(bench / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer, chips=w["chips"])


def load_file(kind: str, name: str, root: Path = ROOT):
    """The module ``benchmark/<kind>/<name>.py`` (a name may hold dots)."""
    path = root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(cell: Cell):
    return importlib.import_module(f"benchmark.reference.{cell.config['reference']}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_cuda(chips: int) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card and never "
                         "falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} card(s), {torch.cuda.device_count()} found")


def check_numbers(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number
    is finite and at most its limit, and none is missing."""
    checks, ok = {}, True
    for key, limit in limits.items():
        value = numbers.get(key)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[key] = {"value": value, "limit": limit}
    return ok, checks


def device_info(device, chips: int, peak_bytes: int) -> dict:
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        return dict(platform="gpu", kind=kind, count=chips, memory_peak_bytes=int(peak_bytes))
    return dict(platform="cpu", kind="cpu", count=chips, memory_peak_bytes=int(peak_bytes))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=print) -> dict:
    """Run ``cell`` once and return its result (the line's object)."""
    entry = load_file("entries", cell.traffic["entry"]).Entry(cell, seed, device)
    before = time.perf_counter() - t_start
    entry.setup()
    setup_s = time.perf_counter() - t_start
    log("setup: interpreter and imports %.3f s; " % before
        + "; ".join(f"{n} {s:.3f} s" for n, s in entry.phases.seconds))
    window = entry.window(seconds)
    window.setup_s = setup_s
    peak = yardstick.peak_bytes(device)
    reading = entry.traced(cell.traffic["trace_units"]) if trace else None
    if trace:
        peak = max(peak, reading.peak_bytes)
    entry.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = entry.check()
    correct, checks = check_numbers(numbers, cell.limits)
    if trace:
        reading.flops_per_unit = entry.flops_per_unit()
        metrics = _read_all(cell.per_layer, "metrics", reading)
    else:
        metrics = _read_all(cell.end_to_end, "end_to_end", window)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    dev = device_info(device, cell.chips, peak)
    out = dict(correct=correct and window.failed == 0, attempted=window.attempted,
               failed=window.failed, metrics=metrics, device=dev)
    if trace:
        dev["busy_s"], dev["window_s"] = reading.busy_s(), reading.wall_s
        out["breakdown"] = reading.breakdown()
    out["checks"] = checks
    return out


def _read_all(entries: list, kind: str, source) -> dict:
    out = {}
    for m in entries:
        value = load_file(kind, m["name"]).read(source)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_manifest()
    cell = resolve(args.workload, manifest)
    require_cuda(cell.chips)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start,
                      log=lambda line: print(line, file=sys.stderr))
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

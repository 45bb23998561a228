"""BENCHMARK.json and the files it names: every cell resolves to its
configuration, traffic, limits, entry and metric readers by name, the
manifest keeps to its contract's shapes, and a file added beside the
others is found with no edit to any file that is there."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_manifest_shape(manifest):
    assert set(manifest) == KEYS
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"][1] == "benchmark/run.py"
    assert 1 <= manifest["run_seconds"] <= 51
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    names += [c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in manifest["end_to_end"] + manifest["per_layer"])) == \
        len(manifest["end_to_end"]) + len(manifest["per_layer"])
    for m in manifest["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    assert len(json.dumps(manifest)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_cell_resolves_by_name(manifest, workload):
    cell = harness.resolve(workload, manifest)
    assert harness.load_file("entries", cell.traffic["entry"]).Entry
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end:
        assert callable(harness.load_file("end_to_end", m["name"]).read)
    for m in cell.per_layer:
        assert callable(harness.load_file("metrics", m["name"]).read)
        assert workload in m["workloads"]
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert harness.reference(cell).spec(cell.config["model"])


def test_added_metric_and_cell_need_no_edit(manifest, tmp_path):
    """A copy of the benchmark with a new metric reader, a new traffic mix
    and a new cell, each a new file plus entries in the manifest."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (root / "benchmark" / "metrics" / "frames_per_unit.train.py").write_text(
        "def read(reading):\n    return 7.0\n")
    traffic = json.loads((root / "benchmark/traffic/train_b128.json").read_text())
    (root / "benchmark/traffic/train_b64.json").write_text(json.dumps(dict(traffic, batch=64)))
    shutil.copy(root / "benchmark/limits/srnn_mnist.train_b128.json",
                root / "benchmark/limits/srnn_mnist.train_b64.json")
    m = json.loads(json.dumps(manifest))
    m["workloads"].append(dict(name="srnn_mnist.train_b64", config="srnn_mnist",
                               traffic="train_b64", chips=1, why="a smaller batch"))
    for metric in m["end_to_end"]:
        if metric["name"] == "train_frames_per_s":
            metric["workloads"].append("srnn_mnist.train_b64")
    m["per_layer"].append(dict(name="frames_per_unit.train", unit="frames", better="higher",
                               source="host_clock", layer="training step",
                               moves="train_frames_per_s",
                               workloads=["srnn_mnist.train_b64"]))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.resolve("srnn_mnist.train_b64", harness.load_manifest(root), root)
    assert cell.traffic["batch"] == 64
    assert [x["name"] for x in cell.per_layer] == ["frames_per_unit.train"]
    assert harness.load_file("metrics", "frames_per_unit.train", root).read(None) == 7.0


def test_configs_hold_their_source(manifest):
    for c in manifest["configs"]:
        spec = json.loads(Path(harness.ROOT, c["file"]).read_text())
        assert spec["reduced"] == c["reduced"]
        assert spec["source"].startswith(c["source"])
        assert {"model", "train", "family", "config_class", "reference"} <= set(spec)

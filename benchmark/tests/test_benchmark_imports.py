"""What the runner and the reference load, each checked in a fresh
process: nothing of JAX or of the JAX package (top-level names compared
whole, so ``recurrent_flows_tpu_torch`` is not taken for
``recurrent_flows_tpu``), and the reference nothing of the program. And
the runner refuses to measure without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark import harness

ROOT = str(harness.ROOT)

RUN_TINY = """
import json, sys, time, torch
torch.set_num_threads(2)
from benchmark import harness
from benchmark.tests.tiny import tiny_cell
for w in ("rfn_mnist.train_b720", "srnn_mnist.train_b128", "rfn_mnist.serve_b64"):
    harness.run_cell(tiny_cell(w), 3, 0.1, True, torch.device("cpu"), time.perf_counter())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

RUN_REFERENCE = """
import json, sys, torch
from benchmark import flops, weights
from benchmark.reference import common, rfn, srnn
from benchmark.tests.tiny import tiny_cell
for w, ref in (("rfn_mnist.train_b720", rfn), ("srnn_mnist.train_b128", srnn)):
    cell = tiny_cell(w)
    cfg = cell.config["model"]
    p = weights.make(ref, cfg, 1, "cpu")
    x = torch.rand(2, 3, cfg["image_size"], cfg["image_size"], 1)
    ref.loss(p, cfg, x, common.Draws(1, "cpu"))
    flops.train_step(ref, cfg, 2, 3)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_runner_loads_no_jax():
    loaded = _modules(RUN_TINY)
    assert "recurrent_flows_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_reference_loads_neither_jax_nor_the_program():
    loaded = _modules(RUN_REFERENCE)
    assert not loaded & set(harness.FORBIDDEN)
    assert "recurrent_flows_tpu_torch" not in loaded


def test_runner_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "srnn_mnist.train_b128",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_forbidden_names_are_whole_top_level_names():
    added = ("recurrent_flows_tpu_torch_fake", "jaxtyping_fake.x", "jax.numpy_fake")
    try:
        for name in added[:2]:
            sys.modules[name] = sys
        assert harness.forbidden_modules() == []
        sys.modules[added[2]] = sys
        assert harness.forbidden_modules() == ["jax"]
    finally:
        for name in added:
            sys.modules.pop(name, None)

"""Importing the port pulls in neither JAX nor Triton, initialises no CUDA
context and builds nothing; nor does building the eval CLI's parser. The
data package, the training CLIs, the training and serving packages, the
export CLI, ``cli.build_framecache`` and the evaluation package (its
figures are numpy) import no matplotlib (nor Pillow) either: the card's
machine has none."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "recurrent_flows_tpu_torch"

_CHECK = """
import importlib, pkgutil, sys
import recurrent_flows_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import torch
bad = [m for m in sys.modules if m in ("jax", "recurrent_flows_tpu")
       or m.startswith(("jax.", "triton", "recurrent_flows_tpu."))]
assert not bad, bad
assert not torch.cuda.is_initialized()
from recurrent_flows_tpu_torch.cli import eval_settings
assert eval_settings.build_parser().parse_args(["--path", "x"]).device == "cuda"
assert not torch.cuda.is_initialized()
assert not any(m == "matplotlib" or m.startswith("matplotlib.") for m in sys.modules)
print(len(names), " ".join(names))
"""


def test_importing_every_module_keeps_jax_triton_and_cuda_out(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    build = PKG / "_build"
    before = sorted(build.iterdir()) if build.exists() else None
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.split(maxsplit=1)
    assert int(count) >= 20  # every module was walked, the families' among them
    for mod in ("ops.mol", "nn.dense_lstm", "models.dense_latent", "models.srnn",
                "models.vrnn", "models.svg", "evaluation.metrics", "evaluation.lpips",
                "evaluation.alexnet_lpips", "evaluation.i3d", "evaluation.fvd",
                "evaluation.evaluator", "evaluation.averagemodel", "cli.common",
                "cli.eval_settings", "cli.main_rfn", "cli.main_srnn", "cli.main_vrnn",
                "cli.main_svg", "data.shapes", "data.kth", "data.bair", "data.png",
                "parallel.distributed", "parallel.data_parallel", "ops.library",
                "data._native", "training.plots", "cli.export_serving",
                "cli.build_framecache", "models.glow_image", "models.vrnn1d",
                "flows.realnvp2d", "data.sinusoids", "data.halfmoon", "data.celeba",
                "data.prepare_kth"):
        assert f"recurrent_flows_tpu_torch.{mod}" in names.split(), mod
    assert (sorted(build.iterdir()) if build.exists() else None) == before


_TRAINING_PATH = """
import sys
import recurrent_flows_tpu_torch.data
import recurrent_flows_tpu_torch.data.prepare_kth
import recurrent_flows_tpu_torch.evaluation
import recurrent_flows_tpu_torch.models
import recurrent_flows_tpu_torch.serving
import recurrent_flows_tpu_torch.training
from recurrent_flows_tpu_torch.cli import (build_framecache, export_serving, main_rfn,
                                           main_srnn, main_svg, main_vrnn)
for mod in (main_rfn, main_srnn, main_svg, main_vrnn):
    mod.build_parser().parse_args([])
export_serving.build_parser().parse_args(["--checkpoint", "c", "--out", "o", "--batch_size", "1"])
build_framecache.build_parser().parse_args(["--dataset", "kth", "--data_root", "r"])
bad = [m for m in sys.modules if m.split(".")[0] in ("matplotlib", "PIL", "jax")]
assert not bad, bad
"""


def test_data_and_training_clis_import_no_matplotlib(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _TRAINING_PATH], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_never_import_jax_or_triton_at_module_level():
    for path in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
        # the port has no Triton kernel: not even a launching function imports it
        assert not re.search(r"^\s*(import|from)\s+triton\b", text, re.M), path
        # nothing of the JAX package either, not even a module of it that
        # does not import JAX: the port keeps its own copy of what it needs
        found = re.findall(r"^\s*(?:from|import)\s+(recurrent_flows_tpu(?:\.[\w.]+)?)\s",
                           text, re.M)
        assert not found, (path, found)

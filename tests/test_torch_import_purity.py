"""Importing the port pulls in neither JAX nor Triton, initialises no CUDA
context and builds nothing."""

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
print(len(names))
"""


def test_importing_every_module_keeps_jax_triton_and_cuda_out(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    build = PKG / "_build"
    before = sorted(build.iterdir()) if build.exists() else None
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module was walked
    assert (sorted(build.iterdir()) if build.exists() else None) == before


def test_sources_never_import_jax_or_triton_at_module_level():
    for path in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
        assert not re.search(r"^(import|from)\s+triton\b", text, re.M), path
        # nothing of the JAX package either, not even a module of it that
        # does not import JAX: the port keeps its own copy of what it needs
        found = re.findall(r"^\s*(?:from|import)\s+(recurrent_flows_tpu(?:\.[\w.]+)?)\s",
                           text, re.M)
        assert not found, (path, found)

"""Build and load the port's CUDA C++ kernels (route: nvcc -> shared
library with a plain C interface -> ctypes).

The library is built at first use from ``recurrent_flows_tpu_torch/csrc``
into ``recurrent_flows_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. Each source is one library; ``build_all`` compiles several at
once, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ((Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME or nvcc on PATH)")


SOURCES = ("actnorm_invconv", "convlstm_gates", "coupling", "glowstep", "glowchain")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, tuple[Path, float]]:
    """Compile each ``csrc/<name>.cu`` that has no up-to-date build, all
    ``nvcc`` processes started together. Returns {name: (library path,
    seconds until its compile ended; 0.0 if cached)}."""
    out, running = {}, []
    t0 = time.perf_counter()
    try:
        for name in names:
            lib = _lib_path(name)
            if lib.is_file():
                out[name] = (lib, 0.0)
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            running.append((name, lib, tmp, proc))
        for name, lib, tmp, proc in running:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{err}")
            os.replace(tmp, lib)
            out[name] = (lib, time.perf_counter() - t0)
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib, _ = build_all((name,))[name]
    return ctypes.CDLL(str(lib))

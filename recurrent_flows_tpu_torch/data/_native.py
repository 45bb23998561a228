"""Build a C++ source of ``recurrent_flows_tpu_torch/native/`` with g++ into
a shared library with a plain C interface, named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing builds on import."""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

NATIVE = Path(__file__).resolve().parents[1] / "native"


def lib_path(src: Path, flags, build_dir: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(flags).encode())
    return Path(build_dir) / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build(src: Path, flags, build_dir: Path) -> Path:
    """The library of ``src``, compiled into ``build_dir`` unless an
    up-to-date one is there. Raises RuntimeError where g++ is missing or
    the compile fails."""
    lib = lib_path(src, flags, build_dir)
    if lib.is_file():
        return lib
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, str(src), "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, lib)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {src.name} needs a C++ toolchain") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed on {src.name}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib

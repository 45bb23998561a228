"""Python binding for the native C++ frame cache (ctypes): the port's own
copy of ``recurrent_flows_tpu.data.framecache``, with the same blob format
and the same batches for a seed.

``native/framecache.cpp`` is compiled with ``g++ -O3`` on first use into
``recurrent_flows_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source and the flags. A frame-dir dataset is converted into
the mmap blob once (``build_blob``, ``blob_from_loader``, decoding with
``data.png.read_png``; the command line is ``python -m
recurrent_flows_tpu_torch.cli.build_framecache``); ``FrameCache`` then
serves batches from the C++ prefetch ring, with no Python in the
steady-state data path. ``is_available()`` is False where there is no
toolchain.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from . import _native
from .png import read_png

_SRC = _native.NATIVE / "framecache.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_MAGIC = 0x46434231


def ensure_built(force: bool = False) -> Optional[str]:
    """Compile the shared library if needed; returns its path, or None
    where it cannot be built (no g++)."""
    lib = _native.lib_path(_SRC, GXX_FLAGS, BUILD_DIR)
    if force and lib.is_file():
        lib.unlink()
    try:
        return str(_native.build(_SRC, GXX_FLAGS, BUILD_DIR))
    except RuntimeError:
        return None


def is_available() -> bool:
    return ensure_built() is not None


def build_blob(videos: Iterable[np.ndarray], out_path: str) -> str:
    """Write videos (each [T,H,W,C] uint8 or float in [0,1]) into a blob."""
    videos = [np.asarray(v) for v in videos]
    if not videos:
        raise ValueError("no videos")
    norm = []
    for v in videos:
        if v.dtype != np.uint8:
            v = np.clip(v * 255.0, 0, 255).astype(np.uint8)
        norm.append(np.ascontiguousarray(v))
    h, w, c = norm[0].shape[1:]
    with open(out_path, "wb") as f:
        f.write(struct.pack("<5Q", _MAGIC, len(norm), h, w, c))
        offset = 0
        for v in norm:
            f.write(struct.pack("<2Q", offset, v.shape[0]))
            offset += v.nbytes
        for v in norm:
            f.write(v.tobytes())
    return out_path


def blob_from_loader(loader, out_path: str, max_videos: Optional[int] = None,
                     channels: Optional[int] = None) -> str:
    """Convert a loader's videos (``.videos`` or ``.trajs``: lists of frame
    image paths) into a blob, decoding each frame once with
    ``data.png.read_png`` (what ``matplotlib.image.imread`` gives, which the
    JAX package decodes with). ``channels`` defaults to 1 for ``.videos``
    (KTH, channel 0) and 3 for ``.trajs`` (BAIR): a gray frame is repeated
    to 3 channels, an alpha channel dropped."""
    sources = getattr(loader, "videos", None) or getattr(loader, "trajs", None)
    if not sources:
        raise ValueError("loader exposes no frame lists")
    if channels is None:
        channels = 1 if hasattr(loader, "videos") else 3
    videos = []
    for frames in sources[: max_videos or len(sources)]:
        imgs = []
        for p in frames:
            img = read_png(p)
            if img.ndim == 2:
                img = img[..., None]
            if channels == 1:
                img = img[..., :1]
            else:
                img = img[..., :3]
                if img.shape[-1] < 3:
                    img = np.repeat(img[..., :1], 3, axis=-1)
            imgs.append(img)
        videos.append(np.stack(imgs))
    return build_blob(videos, out_path)


class FrameCache:
    """Prefetching batch sampler over a frame blob.

    Iterating yields [B, T, H, W, C] float32 in [0, 1] (numpy; ``Trainer``
    moves each batch to its device).
    """

    def __init__(self, blob_path: str, seq_len: int, batch_size: int,
                 n_buffers: int = 4, seed: int = 0,
                 batches_per_epoch: int = 100):
        lib_path = ensure_built()
        if lib_path is None:
            raise RuntimeError("native framecache unavailable (no g++?)")
        lib = ctypes.CDLL(lib_path)
        lib.fc_open.restype = ctypes.c_void_p
        lib.fc_open.argtypes = [ctypes.c_char_p]
        for fn in ("fc_num_videos", "fc_height", "fc_width", "fc_channels"):
            getattr(lib, fn).restype = ctypes.c_uint64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.fc_sample_batch.restype = None
        lib.fc_sample_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.fc_prefetch_start.restype = None
        lib.fc_prefetch_start.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        lib.fc_next_batch.restype = None
        lib.fc_next_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.fc_prefetch_stop.restype = None
        lib.fc_prefetch_stop.argtypes = [ctypes.c_void_p]
        lib.fc_close.restype = None
        lib.fc_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.fc_open(blob_path.encode())
        if not self._h:
            raise IOError(f"cannot open frame blob {blob_path}")
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.batches_per_epoch = batches_per_epoch
        self.h = lib.fc_height(self._h)
        self.w = lib.fc_width(self._h)
        self.c = lib.fc_channels(self._h)
        self.n_videos = lib.fc_num_videos(self._h)
        self._buf = np.empty((batch_size, seq_len, self.h, self.w, self.c), np.uint8)
        self._prefetching = False
        self._seed = seed
        self._n_buffers = n_buffers

    def start_prefetch(self):
        if not self._prefetching:
            self._lib.fc_prefetch_start(
                self._h, self.batch_size, self.seq_len, self._n_buffers, self._seed)
            self._prefetching = True

    def sample_numpy(self, seed: Optional[int] = None) -> np.ndarray:
        """A batch: from the prefetch ring once it runs, else drawn with
        ``seed`` (a random one when None)."""
        ptr = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if self._prefetching:
            self._lib.fc_next_batch(self._h, ptr)
        else:
            self._lib.fc_sample_batch(
                self._h, seed if seed is not None else np.random.randint(1 << 31),
                self.batch_size, self.seq_len, ptr)
        return self._buf.astype(np.float32) / 255.0

    def __iter__(self):
        self.start_prefetch()
        for _ in range(self.batches_per_epoch):
            yield self.sample_numpy()

    def __len__(self):
        return self.batches_per_epoch

    def close(self):
        if self._h:
            self._lib.fc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

"""A PNG codec in the standard library and numpy, for the frame loaders.

The JAX package decodes KTH and BAIR frames with ``matplotlib.image.imread``;
the port's machines need not have matplotlib (nor Pillow), so the loaders
read PNGs here. ``read_png`` takes the files those datasets hold, 8-bit and
not interlaced, in gray, gray+alpha, RGB or RGBA, with any of the five
row filters, and returns what ``imread`` returns for them: float32
``uint8 / 255``, [H, W] for gray and [H, W, C] otherwise (gray+alpha as
RGBA, as ``imread`` converts it). Any other PNG raises ``ValueError``.
The row filters are undone in C++ (``native/png_unfilter.cpp``, built with
g++ on the first read into ``recurrent_flows_tpu_torch/_build/``); where
it cannot be built, ``read_png`` raises ``RuntimeError``.

``write_png`` writes 8-bit gray, RGB or RGBA, each row with the filter
types given in turn (a test covers every filter; the default, 0, filters
nothing).
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from pathlib import Path

import numpy as np

from . import _native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> bytes per pixel (8-bit samples)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_SRC = _native.NATIVE / "png_unfilter.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


@functools.cache
def _unfilter_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_native.build(_SRC, GXX_FLAGS, BUILD_DIR)))
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 3
    lib.png_unfilter.restype = ctypes.c_int64
    return lib


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo each row's filter (PNG spec, section 9.2): [height, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)
    out = np.empty((height, stride), np.uint8)
    bad = _unfilter_lib().png_unfilter(rows.ctypes.data, out.ctypes.data, height, stride, bpp)
    if bad:
        raise ValueError(f"PNG row filter {rows[(bad - 1) * (stride + 1)]} is not one of 0-4")
    return out


def read_png(path: str) -> np.ndarray:
    """The image of an 8-bit, non-interlaced gray / gray+alpha / RGB / RGBA
    PNG as float32 in [0, 1] (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}; only 8-bit gray, "
                         "gray+alpha, RGB and RGBA are read")
    if compression or filtering or interlace:
        raise ValueError(f"{path}: compression {compression}, filter method {filtering}, "
                         f"interlace {interlace}; only 0, 0, 0 are read")
    bpp = _CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (1 + width * bpp):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, expected "
                         f"{height * (1 + width * bpp)}")
    img = _unfilter(raw, height, width * bpp, bpp).reshape(height, width, bpp)
    if bpp == 1:
        img = img[..., 0]
    elif bpp == 2:  # gray+alpha, as imread returns it: RGBA
        img = img[..., [0, 0, 0, 1]]
    return np.divide(img, 255, dtype=np.float32)


def _filter_row(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> bytes:
    """Row ``line`` (uint8) filtered with ``kind`` against the row above."""
    x = line.astype(np.int32)
    up = prior.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    elif kind == 4:
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    else:
        raise ValueError(f"PNG row filter {kind} is not one of 0-4")
    return bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes()


def write_png(path: str, img: np.ndarray, filters=(0,)) -> None:
    """Write ``img`` (uint8 [H, W] gray, or [H, W, 3|4] RGB/RGBA) as an
    8-bit PNG, row y filtered with ``filters[y % len(filters)]``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    colour = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if colour is None:
        raise ValueError(f"write_png takes [H, W] or [H, W, 3|4], not {img.shape}")
    height, width = img.shape[:2]
    bpp = _CHANNELS[colour]
    rows = img.reshape(height, width * bpp)
    prior = np.zeros(width * bpp, np.uint8)
    raw = []
    for y in range(height):
        raw.append(_filter_row(filters[y % len(filters)], rows[y], prior, bpp))
        prior = rows[y]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(raw)))
                + chunk(b"IEND", b""))

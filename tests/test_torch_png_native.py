"""The port's PNG decoder with its row filters undone in C++
(``native/png_unfilter.cpp``): every filter type and rows that mix them, in
gray, gray+alpha, RGB and RGBA at odd widths, decode exactly as
``matplotlib.image.imread`` decodes them (the JAX loaders' decoder); a
64x64 RGB frame of Paeth rows decodes in no more than 3x ``imread``'s time
(best of 20 each; the byte-by-byte Python loop it replaces took about 24x);
a bad filter byte raises as before; where g++ is missing ``read_png``
raises and never falls back to a Python loop."""

import struct
import time
import zlib

import numpy as np
import pytest
from matplotlib import image as mpimg

from recurrent_flows_tpu_torch.data import png
from recurrent_flows_tpu_torch.data.png import read_png, write_png

# colour type -> channels (8-bit samples)
COLOURS = {0: 1, 4: 2, 2: 3, 6: 4}


def _encode(path, img: np.ndarray, colour: int, filters, filter_bytes=None) -> None:
    """``img`` (uint8 [H, W, C]) as an 8-bit PNG of ``colour``, row y filtered
    with filters[y % len(filters)] (``png._filter_row``); ``filter_bytes``
    overrides the filter byte each row names."""
    h, w, c = img.shape
    rows, prior, raw = img.reshape(h, w * c), np.zeros(w * c, np.uint8), []
    for y in range(h):
        line = png._filter_row(filters[y % len(filters)], rows[y], prior, c)
        if filter_bytes is not None:
            line = bytes([filter_bytes[y % len(filter_bytes)]]) + line[1:]
        raw.append(line)
        prior = rows[y]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(raw)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour", sorted(COLOURS))
@pytest.mark.parametrize("width", [1, 13, 17])
def test_every_filter_decodes_as_imread(tmp_path, colour, width):
    img = np.random.RandomState(colour + width).randint(0, 256, (11, width, COLOURS[colour]))
    img = img.astype(np.uint8)
    for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3), (3, 1, 4, 2)):
        path = str(tmp_path / f"c{colour}w{width}f{''.join(map(str, filters))}.png")
        _encode(path, img, colour, filters)
        got, want = read_png(path), mpimg.imread(path)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, filters
        np.testing.assert_array_equal(got, want, err_msg=str(filters))


def test_a_paeth_frame_decodes_within_3x_imread(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    path = str(tmp_path / "paeth.png")
    write_png(path, img, filters=(4,))

    def best(fn, n=20):
        fn(path)  # warm-up (the first read builds the library)
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn(path)
            times.append(time.perf_counter() - t0)
        return min(times)

    np.testing.assert_array_equal(read_png(path), mpimg.imread(path))
    ours, theirs = best(read_png), best(mpimg.imread)
    assert ours <= 3 * theirs, (ours, theirs)


def test_a_bad_filter_byte_raises(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    path = str(tmp_path / "bad.png")
    _encode(path, img, 2, (0,), filter_bytes=(0, 0, 5))
    with pytest.raises(ValueError, match="PNG row filter 5 is not one of 0-4"):
        read_png(path)


def test_no_compiler_raises_and_never_falls_back(tmp_path, monkeypatch):
    path = str(tmp_path / "f3.png")
    write_png(path, np.arange(48, dtype=np.uint8).reshape(4, 4, 3), filters=(3,))
    monkeypatch.setattr(png, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    png._unfilter_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            read_png(path)
    finally:
        png._unfilter_lib.cache_clear()

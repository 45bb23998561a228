"""The training plots as plain numpy images, written by ``data.png.write_png``
(no matplotlib, which the card's machine lacks).

* :func:`frame_grid`: ``Trainer.plot_rows``' rows, one row of tiles per
  (name, frames), the first sequence's frames left to right, up to 10, a
  1-pixel white separator between tiles;
* :func:`loss_panel`: the four loss histories, each a polyline on its own
  panel, scaled to the panel's height between its least and largest
  finite value, with no text (the panels' order is the caller's).
"""

from __future__ import annotations

import numpy as np

SEPARATOR = 255  # the separator's and the background's value
LINE = (31, 119, 180)  # the polylines' colour
AXES = (160, 160, 160)  # the panels' frames


def frame_grid(rows, max_frames: int = 10) -> np.ndarray:
    """rows: [(name, frames [T, B, H, W, C])] -> one uint8 image, [H', W'] for
    gray frames, [H', W', 3] for RGB. Row r, column t holds frame min(t,
    T_r - 1) of sequence 0 of row r, for t < min(T_0, max_frames). Frames
    are uint8, or floats in [0, 1] (``plot_rows`` under the 'none'
    preprocessing), clipped and rounded to uint8."""
    t_show = min(rows[0][1].shape[0], max_frames)
    h, w, c = rows[0][1].shape[2:]
    grid = np.full((len(rows) * (h + 1) - 1, t_show * (w + 1) - 1, c), SEPARATOR, np.uint8)
    for r, (_, frames) in enumerate(rows):
        frames = np.asarray(frames)
        if frames.shape[2:] != (h, w, c):
            raise ValueError(f"frame_grid: row {r} has frames of shape {frames.shape}, "
                             f"expected [T, B, {h}, {w}, {c}]")
        if frames.dtype != np.uint8:
            frames = np.rint(np.clip(frames, 0.0, 1.0) * 255).astype(np.uint8)
        for t in range(t_show):
            y, x = r * (h + 1), t * (w + 1)
            grid[y:y + h, x:x + w] = frames[min(t, frames.shape[0] - 1), 0]
    return grid[..., 0] if c == 1 else grid


def _line(canvas, x0, y0, x1, y1, colour):
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    canvas[ys, xs] = colour


def loss_panel(histories, height: int = 120, width: int = 200, pad: int = 6) -> np.ndarray:
    """One uint8 RGB image [height, len(histories) · width]: panel i frames
    history i as a polyline, x the index, y from its least finite value at
    the bottom to its largest at the top. Non-finite values are left out;
    an empty history leaves an empty frame."""
    canvas = np.full((height, len(histories) * width, 3), SEPARATOR, np.uint8)
    for i, hist in enumerate(histories):
        x0, x1, y0, y1 = i * width + pad, (i + 1) * width - pad - 1, pad, height - pad - 1
        for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)), ((x1, y1), (x0, y1)),
                     ((x0, y1), (x0, y0))):
            _line(canvas, *a, *b, AXES)
        v = np.asarray(hist, np.float64)
        idx = np.flatnonzero(np.isfinite(v))
        if not idx.size:
            continue
        lo, hi = v[idx].min(), v[idx].max()
        span = hi - lo if hi > lo else 1.0
        xs = x0 + 1 + (idx / max(len(v) - 1, 1)) * (x1 - x0 - 2)
        ys = y1 - 1 - (v[idx] - lo) / span * (y1 - y0 - 2)
        if idx.size == 1:
            canvas[int(np.rint(ys[0])), int(np.rint(xs[0]))] = LINE
        for k in range(idx.size - 1):
            _line(canvas, xs[k], ys[k], xs[k + 1], ys[k + 1], LINE)
    return canvas

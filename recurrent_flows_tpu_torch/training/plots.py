"""The training and evaluation figures as plain numpy images, written by
``data.png.write_png`` (no matplotlib, which the card's machine lacks).

* :func:`frame_grid`: ``Trainer.plot_rows``' rows, one row of tiles per
  (name, frames), the first sequence's frames left to right, up to 10, a
  1-pixel white separator between tiles;
* :func:`boxed_grid`: sequences by rows, time by columns, each tile framed
  red (context) or green (prediction) (``Evaluator.plot_random_samples``);
* :func:`line_panel`: one panel of polylines in a palette, with optional
  shaded bands and vertical marks, all series on one vertical scale;
* :func:`loss_panel`: the four loss histories, each a polyline on its own
  panel, scaled to the panel's height between its least and largest
  finite value, with no text (the panels' order is the caller's);
* :func:`heatmap`: a density on a square grid in a dark-to-light ramp,
  with points drawn over it (``examples/torch_two_moons.py``).
"""

from __future__ import annotations

import numpy as np

SEPARATOR = 255  # the separator's and the background's value
LINE = (31, 119, 180)  # the polylines' colour (the palette's first)
PALETTE = (LINE, (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189))
AXES = (160, 160, 160)  # the panels' frames and the vertical marks
CONTEXT, PREDICTION = (255, 0, 0), (0, 160, 0)  # boxed_grid's frames
HEAT = ((0, 0, 4), (81, 18, 124), (183, 55, 121), (252, 137, 97), (252, 253, 191))
POINTS = (0, 255, 255)  # heatmap's points


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


def boxed_grid(seq, n_context: int, border: int = 2) -> np.ndarray:
    """seq [S, T, H, W, C] (uint8, or floats in [0, 1]) -> one uint8 RGB
    image [S·(H+2·border+1) - 1, T·(W+2·border+1) - 1, 3]: sequence s, frame
    t in row s, column t, framed ``border`` pixels wide in red for the
    first ``n_context`` frames and in green after."""
    seq = np.asarray(seq)
    s_n, t_n, h, w, c = seq.shape
    if seq.dtype != np.uint8:
        seq = np.rint(np.clip(seq, 0.0, 1.0) * 255).astype(np.uint8)
    th, tw = h + 2 * border, w + 2 * border
    grid = np.full((s_n * (th + 1) - 1, t_n * (tw + 1) - 1, 3), SEPARATOR, np.uint8)
    for s in range(s_n):
        for t in range(t_n):
            y, x = s * (th + 1), t * (tw + 1)
            grid[y:y + th, x:x + tw] = CONTEXT if t < n_context else PREDICTION
            grid[y + border:y + border + h, x + border:x + border + w] = (
                np.broadcast_to(seq[s, t], (h, w, 3)))
    return grid


def _line(canvas, x0, y0, x1, y1, colour):
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    canvas[ys, xs] = colour


def _tint(colour, share: float = 0.25):
    return tuple(int(round(255 - share * (255 - v))) for v in colour)


def line_panel(series, height: int = 120, width: int = 200, pad: int = 6, bands=(),
               marks=()) -> np.ndarray:
    """One uint8 RGB panel [height, width, 3]: a grey frame; series i (a
    sequence of numbers) as a polyline in ``PALETTE[i]``, x its index from
    the frame's left to its right, y on one scale for the panel, from the
    least finite value of every series and band at the bottom to the
    largest at the top; ``bands[i]`` (lo, hi), where given, shaded in a
    tint of series i's colour under the lines; a grey vertical line at each
    index in ``marks``. Non-finite values are left out; a panel with no
    finite value holds its frame alone."""
    canvas = np.full((height, width, 3), SEPARATOR, np.uint8)
    x0, x1, y0, y1 = pad, width - pad - 1, pad, height - pad - 1
    for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)), ((x1, y1), (x0, y1)),
                 ((x0, y1), (x0, y0))):
        _line(canvas, *a, *b, AXES)
    series = [np.asarray(v, np.float64) for v in series]
    bands = [(np.asarray(lo, np.float64), np.asarray(hi, np.float64)) for lo, hi in bands]
    finite = [a[np.isfinite(a)] for a in series + [b for pair in bands for b in pair]]
    finite = np.concatenate(finite) if finite else np.zeros(0)
    n = max((len(v) for v in series), default=0)
    if not finite.size:
        return canvas
    lo, hi = finite.min(), finite.max()
    span = hi - lo if hi > lo else 1.0
    x_of = lambda i: x0 + 1 + (np.asarray(i) / max(n - 1, 1)) * (x1 - x0 - 2)  # noqa: E731
    y_of = lambda v: y1 - 1 - (v - lo) / span * (y1 - y0 - 2)  # noqa: E731
    for m in marks:
        _line(canvas, x_of(m), y0 + 1, x_of(m), y1 - 1, AXES)
    for i, (b_lo, b_hi) in enumerate(bands):
        colour = _tint(PALETTE[i % len(PALETTE)])
        for k in np.flatnonzero(np.isfinite(b_lo) & np.isfinite(b_hi)):
            _line(canvas, x_of(k), y_of(b_lo[k]), x_of(k), y_of(b_hi[k]), colour)
    for i, v in enumerate(series):
        colour = PALETTE[i % len(PALETTE)]
        idx = np.flatnonzero(np.isfinite(v))
        if idx.size == 1:
            canvas[int(np.rint(y_of(v[idx[0]]))), int(np.rint(x_of(idx[0])))] = colour
        xs, ys = x_of(idx), y_of(v[idx])
        for k in range(idx.size - 1):
            _line(canvas, xs[k], ys[k], xs[k + 1], ys[k + 1], colour)
    return canvas


def loss_panel(histories, height: int = 120, width: int = 200, pad: int = 6) -> np.ndarray:
    """One uint8 RGB image [height, len(histories) · width]: panel i frames
    history i as a polyline (``line_panel``), x the index, y from its least
    finite value at the bottom to its largest at the top. Non-finite values
    are left out; an empty history leaves an empty frame."""
    return np.concatenate([line_panel([h], height, width, pad) for h in histories], 1)


def heatmap(values, points=None, extent: float = 1.0, colour=POINTS) -> np.ndarray:
    """values [n, n] on the square [-extent, extent]² (row 0 at the bottom,
    as matplotlib's ``origin='lower'``) -> uint8 RGB [n, n, 3], row 0 at the
    top: value / max through the ramp ``HEAT`` (dark = 0); ``points`` [k, 2]
    (x, y), where given, drawn over it in ``colour``, those outside left
    out. Non-finite values are drawn as 0."""
    v = np.nan_to_num(np.asarray(values, np.float64), nan=0.0, posinf=0.0, neginf=0.0)
    top = v.max()
    t = np.clip(v / top, 0.0, 1.0) if top > 0 else np.zeros_like(v)
    stops = np.linspace(0.0, 1.0, len(HEAT))
    img = np.stack([np.interp(t, stops, [c[k] for c in HEAT]) for k in range(3)], -1)
    img = np.rint(img[::-1]).astype(np.uint8)
    if points is not None:
        n_y, n_x = v.shape
        p = np.asarray(points, np.float64)
        col = np.rint((p[:, 0] + extent) / (2 * extent) * (n_x - 1)).astype(int)
        row = np.rint((1 - (p[:, 1] + extent) / (2 * extent)) * (n_y - 1)).astype(int)
        inside = (col >= 0) & (col < n_x) & (row >= 0) & (row < n_y)
        img[row[inside], col[inside]] = colour
    return img

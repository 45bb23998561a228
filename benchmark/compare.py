"""The numbers the check compares, program against reference.

Training: the loss of each of the first steps (``loss_gap``, the worst
step, relative; ``first_loss_gap``, the first step alone), the norm of the
first step's gradient as Adam got it, and the norm of each leaf's change
over the steps, the last two per leaf and taken at the worst leaf as
|norm_program - norm_reference| / max(norm_reference, the median leaf's
norm). Leaves whose reference gradient is under a thousandth of the median
leaf's (round-off alone moves them under Adam) are left out of the change.

Requests: the largest |program - reference| over every value of the
sampled requests' frames in [0, 1], of the first predicted frame and of
the first ``EARLY_FRAMES``. Later frames are not compared: a rollout fed
its own frames amplifies a difference about sevenfold a frame (from 1e-5
at the first frame to the whole [0, 1] range by the sixth, in float32 on
every seed measured), so two sound computations part there.
"""

from __future__ import annotations

import statistics

EXCLUDE_BELOW = 1e-3
EARLY_FRAMES = 4


def _worst(prog: dict, ref: dict, keys) -> tuple[float, str]:
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    gaps = {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median) for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """(numbers, the leaves they were read at). ``prog`` and ``ref`` hold
    ``losses`` [steps], ``grad`` {leaf: norm} of step 1 and ``change``
    {leaf: norm}."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    moved = [k for k, v in ref["grad"].items() if v > 0]
    grad_gap, grad_leaf = _worst(prog["grad"], ref["grad"], moved)
    g_median = statistics.median(ref["grad"][k] for k in moved)
    kept = [k for k in moved if ref["grad"][k] >= EXCLUDE_BELOW * g_median]
    change_gap, change_leaf = _worst(prog["change"], ref["change"], kept)
    return (dict(loss_gap=max(loss_gaps), first_loss_gap=loss_gaps[0], grad_gap=grad_gap,
                 change_gap=change_gap),
            dict(loss_gaps=loss_gaps, grad_gap=grad_leaf, change_gap=change_leaf,
                 left_out=sorted(set(ref["grad"]) - set(kept))))


def frame_numbers(pairs) -> dict:
    """``pairs``: (program frames, reference frames) numpy arrays [B, T,
    H, W, C] per sampled request."""
    first = max(float(abs(p[:, 0] - r[:, 0]).max()) for p, r in pairs)
    early = max(float(abs(p[:, :EARLY_FRAMES] - r[:, :EARLY_FRAMES]).max()) for p, r in pairs)
    return dict(first_frame_gap=first, early_frames_gap=early)


def frame_profile(pairs) -> list:
    """The largest |program - reference| of each predicted frame."""
    n = pairs[0][0].shape[1]
    return [max(float(abs(p[:, t] - r[:, t]).max()) for p, r in pairs) for t in range(n)]

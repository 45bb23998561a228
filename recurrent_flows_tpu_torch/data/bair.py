"""BAIR robot-push dataset loader (directory-of-PNG-frames format), the
counterpart of ``recurrent_flows_tpu.data.bair``: the same scan of
``<root>/<split>/traj_{a}_to_{b}/<delta>/<frame>.png``, the same
``np.random.RandomState(seed)`` draws (a random window for train, the
prefix for test), so both loaders give the same batches from the same
tree; the frames are decoded by ``data.png`` (no matplotlib). Yields
[B, T, 64, 64, 3] float32 in [0, 1].
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional

import numpy as np

from .png import read_png


def _read_png_rgb(path: str) -> np.ndarray:
    img = read_png(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3].astype(np.float32)


class PushDataset:
    def __init__(self, split: str, dataset_dir: str, seq_len: int = 12,
                 batch_size: int = 32, seed: int = 0, batches_per_epoch: int = 100):
        self.split = split
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.batches_per_epoch = batches_per_epoch
        self.rng = np.random.RandomState(seed)
        root = os.path.join(dataset_dir, split)
        self.trajs: List[List[str]] = []
        for traj_dir in sorted(glob.glob(os.path.join(root, "traj_*"))):
            for sub in sorted(glob.glob(os.path.join(traj_dir, "*"))):
                frames = glob.glob(os.path.join(sub, "*.png"))
                frames.sort(key=lambda p: int(re.sub(r"\D", "", os.path.basename(p)) or 0))
                if len(frames) >= seq_len:
                    self.trajs.append(frames)
        if not self.trajs:
            raise FileNotFoundError(f"no BAIR trajectories under {root}")

    def _sample_seq(self) -> np.ndarray:
        frames = self.trajs[self.rng.randint(len(self.trajs))]
        start = self.rng.randint(len(frames) - self.seq_len + 1) if self.split == "train" else 0
        return np.stack([_read_png_rgb(p) for p in frames[start:start + self.seq_len]])

    def sample_numpy(self, batch_size: Optional[int] = None) -> np.ndarray:
        bs = batch_size or self.batch_size
        return np.stack([self._sample_seq() for _ in range(bs)])

    def __iter__(self):
        for _ in range(self.batches_per_epoch):
            yield self.sample_numpy()

    def __len__(self):
        return self.batches_per_epoch

"""KTH action dataset loader (Denton-preprocessed 64x64 PNG frames), the
counterpart of ``recurrent_flows_tpu.data.kth``: the same scan of
``<root>/processed/<class>/<person_video>/*.png`` (persons 1-20 train,
21-25 test), the same ``np.random.RandomState(seed)`` draws of a video and
a window, so both loaders give the same batches from the same tree; the
frames are decoded by ``data.png`` (no matplotlib).
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional

import numpy as np

from .png import read_png

CLASSES = ("boxing", "handclapping", "handwaving", "jogging", "running", "walking")


def _read_png_gray(path: str) -> np.ndarray:
    img = read_png(path)  # float [0,1] HxW or HxWxC
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.float32)


class KTH:
    """Random-window sampler over KTH frame directories.

    Yields [B, T, H, W, 1] float32 in [0, 1] (numpy) when iterated.
    """

    def __init__(self, train: bool, data_root: str, seq_len: int = 20,
                 image_size: int = 64, batch_size: int = 32, seed: int = 0,
                 batches_per_epoch: int = 100):
        self.seq_len = seq_len
        self.image_size = image_size
        self.batch_size = batch_size
        self.batches_per_epoch = batches_per_epoch
        self.rng = np.random.RandomState(seed)
        persons = range(1, 21) if train else range(21, 26)
        person_tags = {f"person{p:02d}" for p in persons}
        self.videos: List[List[str]] = []
        for cls in CLASSES:
            for d in sorted(glob.glob(os.path.join(data_root, "processed", cls, "*"))):
                m = re.match(r"(person\d+)", os.path.basename(d))
                if m and m.group(1) in person_tags:
                    frames = sorted(glob.glob(os.path.join(d, "*.png")))
                    if len(frames) >= seq_len:
                        self.videos.append(frames)
        if not self.videos:
            raise FileNotFoundError(
                f"no KTH frame directories under {data_root}/processed (the layout "
                "recurrent_flows_tpu/data/prepare_kth.py makes)")

    def _sample_seq(self) -> np.ndarray:
        frames = self.videos[self.rng.randint(len(self.videos))]
        start = self.rng.randint(len(frames) - self.seq_len + 1)
        seq = np.stack([_read_png_gray(p) for p in frames[start:start + self.seq_len]])
        return seq[..., None]

    def sample_numpy(self, batch_size: Optional[int] = None) -> np.ndarray:
        bs = batch_size or self.batch_size
        return np.stack([self._sample_seq() for _ in range(bs)])

    def __iter__(self):
        for _ in range(self.batches_per_epoch):
            yield self.sample_numpy()

    def __len__(self):
        return self.batches_per_epoch

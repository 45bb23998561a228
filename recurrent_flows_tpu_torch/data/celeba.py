"""Boxed-CelebA conditional pairs for the conditional-Glow workload, the
counterpart of ``recurrent_flows_tpu.data.celeba``: the 32x32 pickle the
loader reads, its preparation from a raw image directory, and the
(outer-box context, inner-box target) pairs.

``prepare_celeba`` decodes PNGs with ``data.png.read_png`` and needs no
Pillow; only JPEG sources need it, imported on that branch alone. Each
image is centre-cropped to a square with the JAX package's integer
arithmetic, then resized on ``device`` by ``F.interpolate(mode="bilinear",
antialias=True)`` on its uint8 values, rounded to uint8 and divided by 255.
Against the JAX package's Pillow ``BILINEAR`` resize the values differ by at
most 1/255 per pixel (``tests/test_torch_celeba.py`` holds that bound; on
the CPU, at sizes 16, 32 and 64 from random and patterned PNGs of 37x53 to
218x178, 9-15% of the values differed by exactly 1/255 and none by more).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .png import read_png


def get_celeba(data_root: str) -> Optional[np.ndarray]:
    """A local 32x32 CelebA pickle ([N, 32, 32, 3] float or uint8, NHWC or
    NCHW) as float32 NHWC in [0, 1]; None where there is none."""
    for name in ("celeba_32.pkl", "celeba.pkl"):
        path = os.path.join(data_root, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                arr = np.asarray(pickle.load(f))
            if arr.dtype == np.uint8:
                arr = arr.astype(np.float32) / 255.0
            if arr.shape[1] == 3:  # NCHW -> NHWC
                arr = arr.transpose(0, 2, 3, 1)
            return arr.astype(np.float32)
    return None


def _decode_rgb(path: str) -> np.ndarray:
    """uint8 [H, W, 3] of a PNG (``read_png``; gray replicated, alpha
    dropped, as Pillow's ``convert("RGB")``) or a JPEG (Pillow)."""
    if path.lower().endswith(".png"):
        img = np.rint(read_png(path) * 255).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        return np.ascontiguousarray(img[..., :3])
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: decoding a JPEG needs Pillow, which is not "
                          "installed; PNG sources need nothing") from e
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def prepare_celeba(image_dir: str, out_path: str, size: int = 32,
                   limit: Optional[int] = None, device="cuda") -> int:
    """Convert a raw image directory (e.g. img_align_celeba: .jpg, .jpeg or
    .png, in sorted order, the first ``limit``) into the pickle
    ``get_celeba`` reads: each image centre-cropped to a square, resized to
    ``size`` on ``device`` (module docstring), stacked to [N, size, size, 3]
    float32 in [0, 1]. Returns N."""
    names = sorted(n for n in os.listdir(image_dir)
                   if n.lower().endswith((".jpg", ".jpeg", ".png")))
    if limit:
        names = names[:limit]
    if not names:
        raise FileNotFoundError(f"no images under {image_dir!r}")
    out = np.empty((len(names), size, size, 3), np.float32)
    for i, name in enumerate(names):
        img = _decode_rgb(os.path.join(image_dir, name))
        h, w = img.shape[:2]
        side = min(w, h)
        top, left = (h - side) // 2, (w - side) // 2
        img = img[top:(h + side) // 2, left:(w + side) // 2]
        x = torch.as_tensor(img, device=device).permute(2, 0, 1)[None].float()
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=True)
        x = torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
        out[i] = x[0].permute(1, 2, 0).cpu().numpy().astype(np.float32) / 255.0
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return len(names)


def get_joint_conditioned_data(images: np.ndarray, box: int = 8
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """(x = the images with their centre box zeroed, y = that box): the
    pairs from which a conditional flow learns p(inner | outer)."""
    n, h, w, c = images.shape
    y0, x0 = (h - box) // 2, (w - box) // 2
    y = images[:, y0:y0 + box, x0:x0 + box, :].copy()
    x = images.copy()
    x[:, y0:y0 + box, x0:x0 + box, :] = 0.0
    return x, y

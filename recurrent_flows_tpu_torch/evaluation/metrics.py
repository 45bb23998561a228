"""Image and video quality metrics, the counterparts of
``recurrent_flows_tpu.evaluation.metrics``: per batch element, on the
device of the tensors given, in float32.

SSIM follows scikit-image's ``structural_similarity`` defaults (a 7x7
uniform window over the VALID region, K1 = 0.01, K2 = 0.03, the sample
covariance normalisation NP/(NP-1)), as the reference's evaluation loop
calls it per frame and channel. The window is a convolution, run with
TF32 off (``float32_precision``): with cuDNN's default TF32 the card's
SSIM moves by ~1e-3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.numerics import float32_precision


def to_tensor(x) -> torch.Tensor:
    """A float32 tensor of x: a tensor stays on its device, an array goes to
    the card (a CPU caller passes a CPU tensor)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(x, dtype=torch.float32, device="cuda")


def mse(a, b):
    """Mean squared error over all but the leading batch axis."""
    diff = torch.square(a - b)
    return diff.reshape(diff.shape[0], -1).mean(-1)


def psnr(a, b, data_range: float = 1.0):
    """Peak signal-to-noise ratio per batch element."""
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse(a, b), min=1e-12))


def _uniform_filter(x, size: int = 7):
    """Mean over a size x size window, VALID region: [N, H, W] ->
    [N, H-size+1, W-size+1]."""
    k = torch.full((1, 1, size, size), 1.0 / (size * size), dtype=x.dtype, device=x.device)
    with float32_precision():
        return F.conv2d(x[:, None], k)[:, 0]


def ssim(a, b, data_range: float = 1.0, win_size: int = 7):
    """Mean SSIM per batch element; a, b: [B, H, W], one channel."""
    a, b = a.float(), b.float()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n = win_size ** 2
    cov_norm = n / (n - 1)
    ux, uy = _uniform_filter(a, win_size), _uniform_filter(b, win_size)
    uxx = _uniform_filter(a * a, win_size)
    uyy = _uniform_filter(b * b, win_size)
    uxy = _uniform_filter(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s.reshape(s.shape[0], -1).mean(-1)


def eval_seq(true, pred, data_range: float = 1.0):
    """Per-frame SSIM and PSNR averaged over channels, and MSE over the
    whole frame, of video batches true, pred [B, T, H, W, C]: dict of
    [B, T] tensors."""
    b, t, h, w, c = true.shape
    tr = true.permute(0, 1, 4, 2, 3).reshape(b * t * c, h, w)
    pr = pred.permute(0, 1, 4, 2, 3).reshape(b * t * c, h, w)
    s = ssim(tr, pr, data_range).reshape(b, t, c).mean(-1)
    p = psnr(tr, pr, data_range).reshape(b, t, c).mean(-1)
    m = mse(true.reshape(b * t, -1), pred.reshape(b * t, -1)).reshape(b, t)
    return dict(ssim=s, psnr=p, mse=m)

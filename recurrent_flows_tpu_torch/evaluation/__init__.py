"""The evaluation suite of the port, the counterpart of
``recurrent_flows_tpu.evaluation``: image and video metrics, LPIPS, FVD
and the ``Evaluator``."""

from .metrics import mse, psnr, ssim, eval_seq
from .fvd import frechet_distance, fvd
from .lpips import lpips_distance
from .evaluator import Evaluator

__all__ = [
    "mse",
    "psnr",
    "ssim",
    "eval_seq",
    "frechet_distance",
    "fvd",
    "lpips_distance",
    "Evaluator",
]

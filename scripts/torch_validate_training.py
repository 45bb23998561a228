#!/usr/bin/env python3
"""Learning check of the PyTorch port, the counterpart of
``scripts/validate_training.py``: train a model family on Moving MNIST made
on the device (the port's ``MovingMNIST``) with the port's ``Trainer``, and
write the same ``verdict.json`` (bits per dimension over the first and the
last 20 steps, ``improved`` when the last fell below 95% of the first, the
wall seconds and steps per second) and the plots.

Usage (on the card unless ``--device cpu``):
  python scripts/torch_validate_training.py --model rfn --steps 400
  python scripts/torch_validate_training.py --model glow --image_size 64 --steps 40
  python scripts/torch_validate_training.py --model all --steps 300

``--model glow`` is the unconditional ``GlowImage`` on the frames
(BASELINE config 3: L=3, K=8, 128 units, conditions of 8 channels). As in
the JAX script, ``all`` runs rfn, srnn, vrnn and svg, and ``main`` asserts
that every model it ran improved (``run_one`` trains one and asserts
nothing).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from recurrent_flows_tpu_torch.config import (GlowConfig, RFNConfig, SRNNConfig,  # noqa: E402
                                              SVGConfig, TrainConfig, VRNNConfig)
from recurrent_flows_tpu_torch.data import MovingMNIST  # noqa: E402
from recurrent_flows_tpu_torch.models import RFN, SRNN, SVG, VRNN, GlowImage  # noqa: E402
from recurrent_flows_tpu_torch.training import Trainer  # noqa: E402


def build(model_name: str, img: int, device):
    """(model on ``device``, preprocess range, learning rate), with
    ``validate_training.py``'s widths."""
    gen = torch.Generator().manual_seed(0)
    kw = dict(device=device, generator=gen)
    if model_name == "rfn":
        cfg = RFNConfig(
            x_channels=1, image_size=img, h_dim=64, z_dim=8, a_dim=16, L=3, K=6,
            extractor_structure=((16, "pool", 32), (32, "pool", 64), (64, "pool", 64)),
            upscaler_structure=((64, 32), ("upsample", 32, 32), ("upsample", 16, 16)),
            prior_structure=(32,), encoder_structure=(32,),
            norm_type="none", norm_type_features="none",
            glow=GlowConfig(L=3, K=6, n_units_affine=64, n_units_prior=64))
        return RFN(cfg, **kw), "0.5", 2e-4
    if model_name == "srnn":
        cfg = SRNNConfig(x_channels=1, image_size=img, h_dim=64, z_dim=16, a_dim=64,
                         norm_type="none", enable_smoothing=False, loss_type="bernoulli",
                         preprocess_range="1.0")
        return SRNN(cfg, **kw), "1.0", 3e-4
    if model_name == "vrnn":
        cfg = VRNNConfig(x_channels=1, image_size=img, h_dim=64, z_dim=16,
                         norm_type="none", loss_type="bernoulli", preprocess_range="1.0")
        return VRNN(cfg, **kw), "1.0", 3e-4
    if model_name == "svg":
        cfg = SVGConfig(x_channels=1, image_size=img, z_dim=8, c_features=64, h_dim=128,
                        norm_type="none", loss_type="mse")
        return SVG(cfg, **kw), "none", 1e-3
    if model_name == "glow":  # unconditional Glow on SM-MNIST frames (BASELINE config 3)
        cfg = GlowConfig(L=3, K=8, n_units_affine=128, n_units_prior=128)
        return GlowImage(1, img, cfg, cond_channels=8, base_channels=8, **kw), "0.5", 2e-4
    raise ValueError(model_name)


def run_one(model_name: str, args) -> dict:
    img = args.image_size
    model, pr, lr = build(model_name, img, args.device)
    beta = 1e-4 if model_name == "svg" else 1.0
    tcfg = TrainConfig(
        batch_size=args.batch_size, n_frames=args.n_frames, steps_per_epoch=args.steps,
        n_epochs=1, beta_steps=max(args.steps // 2, 1), learning_rate=lr,
        preprocess_range=pr, beta_max=beta, beta_min=beta if model_name == "svg" else 1e-7,
        n_conditions=3, n_predictions=3)
    ds = MovingMNIST(seq_len=args.n_frames, image_size=img, digit_size=img // 2,
                     num_digits=2 if args.two_digits else 1, device=args.device)
    out_dir = os.path.join(args.out, model_name)
    tr = Trainer(model, tcfg, ds, out_dir, device=args.device).build()
    t0 = time.time()
    tr.train_epoch(steps=args.steps)
    wall = time.time() - t0
    hist = np.asarray(tr.bits_hist)
    first, last = float(hist[:20].mean()), float(hist[-20:].mean())
    verdict = dict(model=model_name, steps=args.steps, metric="bits_per_dim",
                   first20=first, last20=last, improved=bool(last < first * 0.95),
                   wall_s=wall, wall_steps_per_s=args.steps / wall)
    with open(os.path.join(out_dir, "verdict.json"), "w") as f:
        json.dump(verdict, f, indent=2)
    try:
        tr.plotter()
    except Exception as e:  # as the JAX script: a plot never fails the check
        print("plotter failed:", e)
    print(json.dumps(verdict))
    return verdict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="rfn",
                   choices=["rfn", "srnn", "vrnn", "svg", "glow", "all"])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_frames", type=int, default=6)
    p.add_argument("--two_digits", action="store_true")
    p.add_argument("--out", default="runs/validate")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    models = ["rfn", "srnn", "vrnn", "svg"] if args.model == "all" else [args.model]
    verdicts = [run_one(m, args) for m in models]
    assert all(v["improved"] for v in verdicts), verdicts
    return verdicts


if __name__ == "__main__":
    main()

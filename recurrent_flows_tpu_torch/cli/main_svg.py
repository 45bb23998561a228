"""SVG training CLI of the port, the counterpart of
``recurrent_flows_tpu.cli.main_svg`` (the same flags, defaults and choices,
plus ``--device``; flag surface of the reference main_svg.py:48-132):

    python -m recurrent_flows_tpu_torch.cli.main_svg [--device cpu] [--multigpu] ...
"""

from __future__ import annotations

import argparse

import torch

from ..config import SVGConfig, check_supported
from ..models import SVG
from .common import add_data_args, add_trainer_args, run_training


def build_parser():
    p = argparse.ArgumentParser("main_svg")
    add_data_args(p)
    add_trainer_args(p)
    p.add_argument("--x_channels", type=int, default=1)
    p.add_argument("--z_dim", type=int, default=10)
    p.add_argument("--c_features", type=int, default=128)
    p.add_argument("--h_dim", type=int, default=256)
    p.add_argument("--posterior_rnn_layers", type=int, default=1)
    p.add_argument("--predictor_rnn_layers", type=int, default=2)
    p.add_argument("--prior_rnn_layers", type=int, default=1)
    p.add_argument("--loss_type", choices=["bernoulli", "mse", "gaussian"],
                   default="mse")
    p.add_argument("--variance", type=float, default=1.0)
    p.add_argument("--norm_type_model",
                   choices=["instancenorm", "batchnorm", "none"], default="batchnorm")
    p.set_defaults(preprocess_range="none", learning_rate=1e-3, beta_max=1e-4,
                   beta_min=1e-4)
    return p


def config_from_args(args) -> SVGConfig:
    return SVGConfig(
        x_channels=args.x_channels if args.choose_data != "bair" else 3,
        image_size=args.image_size,
        z_dim=args.z_dim,
        c_features=args.c_features,
        h_dim=args.h_dim,
        posterior_rnn_layers=args.posterior_rnn_layers,
        predictor_rnn_layers=args.predictor_rnn_layers,
        prior_rnn_layers=args.prior_rnn_layers,
        loss_type=args.loss_type,
        variance=args.variance,
        norm_type=args.norm_type_model,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    check_supported(cfg)
    init = torch.Generator().manual_seed(args.seed)
    return run_training(lambda device: SVG(cfg, device=device, generator=init), args)


if __name__ == "__main__":
    main()

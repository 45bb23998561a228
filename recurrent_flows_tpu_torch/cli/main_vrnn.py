"""VRNN training CLI of the port, the counterpart of
``recurrent_flows_tpu.cli.main_vrnn`` (the same flags, defaults and choices,
plus ``--device``; flag surface of the reference main_vrnn.py:49-129):

    python -m recurrent_flows_tpu_torch.cli.main_vrnn [--device cpu] [--multigpu] ...
"""

from __future__ import annotations

import argparse

import torch

from ..config import VRNNConfig, check_supported
from ..models import VRNN
from .common import add_bool_arg, add_data_args, add_trainer_args, run_training


def build_parser():
    p = argparse.ArgumentParser("main_vrnn")
    add_data_args(p)
    add_trainer_args(p)
    p.add_argument("--x_channels", type=int, default=1)
    p.add_argument("--h_dim", type=int, default=256)
    p.add_argument("--z_dim", type=int, default=32)
    p.add_argument("--loss_type", choices=["bernoulli", "mse", "gaussian", "mol"],
                   default="bernoulli")
    add_bool_arg(p, "dequantize", default=True)
    p.add_argument("--n_logistics", type=int, default=5)
    p.add_argument("--norm_type_model",
                   choices=["instancenorm", "batchnorm", "none"], default="batchnorm")
    return p


def config_from_args(args) -> VRNNConfig:
    return VRNNConfig(
        x_channels=args.x_channels if args.choose_data != "bair" else 3,
        image_size=args.image_size,
        h_dim=args.h_dim,
        z_dim=args.z_dim,
        loss_type=args.loss_type,
        dequantize=args.dequantize,
        n_logistics=args.n_logistics,
        n_bits=args.n_bits,
        preprocess_range=args.preprocess_range,
        norm_type=args.norm_type_model,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    check_supported(cfg)
    init = torch.Generator().manual_seed(args.seed)
    return run_training(lambda device: VRNN(cfg, device=device, generator=init), args)


if __name__ == "__main__":
    main()

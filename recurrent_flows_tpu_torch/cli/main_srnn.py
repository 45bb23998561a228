"""SRNN training CLI of the port, the counterpart of
``recurrent_flows_tpu.cli.main_srnn`` (the same flags, defaults and choices,
plus ``--device``; flag surface of the reference main_srnn.py:49-138):

    python -m recurrent_flows_tpu_torch.cli.main_srnn [--device cpu] [--multigpu] ...
"""

from __future__ import annotations

import argparse

import torch

from ..config import SRNNConfig, check_supported
from ..models import SRNN
from .common import add_bool_arg, add_data_args, add_trainer_args, run_training


def build_parser():
    p = argparse.ArgumentParser("main_srnn")
    add_data_args(p)
    add_trainer_args(p)
    p.add_argument("--x_channels", type=int, default=1)
    p.add_argument("--h_dim", type=int, default=256)
    p.add_argument("--z_dim", type=int, default=32)
    p.add_argument("--a_dim", type=int, default=256)
    p.add_argument("--loss_type", choices=["bernoulli", "mse", "gaussian", "mol"],
                   default="bernoulli")
    add_bool_arg(p, "dequantize", default=True)
    p.add_argument("--n_logistics", type=int, default=5)
    p.add_argument("--norm_type_model",
                   choices=["instancenorm", "batchnorm", "none"], default="batchnorm")
    add_bool_arg(p, "enable_smoothing", default=True)
    add_bool_arg(p, "res_q", default=False)
    p.add_argument("--num_shots", type=int, default=0, help="overshoot depth D")
    p.add_argument("--overshot_w", type=float, default=1.0)
    return p


def config_from_args(args) -> SRNNConfig:
    return SRNNConfig(
        x_channels=args.x_channels if args.choose_data != "bair" else 3,
        image_size=args.image_size,
        h_dim=args.h_dim,
        z_dim=args.z_dim,
        a_dim=args.a_dim,
        loss_type=args.loss_type,
        dequantize=args.dequantize,
        n_logistics=args.n_logistics,
        n_bits=args.n_bits,
        preprocess_range=args.preprocess_range,
        enable_smoothing=args.enable_smoothing,
        res_q=args.res_q,
        D=args.num_shots,
        overshot_w=args.overshot_w,
        norm_type=args.norm_type_model,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    check_supported(cfg)
    init = torch.Generator().manual_seed(args.seed)
    return run_training(lambda device: SRNN(cfg, device=device, generator=init), args)


if __name__ == "__main__":
    main()

"""RFN training CLI of the port, the counterpart of
``recurrent_flows_tpu.cli.main_rfn`` (the same flags, defaults and choices,
plus ``--device``; flag surface of the reference main_rfn.py:50-197):

    python -m recurrent_flows_tpu_torch.cli.main_rfn [--device cpu] [--multigpu] ...
"""

from __future__ import annotations

import argparse

import torch

from ..config import GlowConfig, RFNConfig, check_supported
from ..models import RFN
from .common import (
    add_bool_arg,
    add_data_args,
    add_trainer_args,
    convert_mixed_list,
    convert_to_upscaler,
    restricted_float,
    run_training,
)

_DEF_EXTRACTOR = ["8-8-pool-16", "16-16-pool-32", "32-32-pool-64", "64-pool-128",
                  "128-pool-256"]
_DEF_UPSCALER = ["256-128", "upsample-128-128", "upsample-64-64", "upsample-32-32",
                 "upsample-16-16"]


def build_parser():
    p = argparse.ArgumentParser("main_rfn")
    add_data_args(p)
    add_trainer_args(p)
    p.add_argument("--x_channels", type=int, default=1)
    p.add_argument("--h_dim", type=int, default=256)
    p.add_argument("--z_dim", type=int, default=5)
    p.add_argument("--L", type=int, default=5)
    p.add_argument("--K", type=int, default=15)
    p.add_argument("--extractor_structure", nargs="+", type=convert_to_upscaler,
                   default=[convert_to_upscaler(s) for s in _DEF_EXTRACTOR])
    p.add_argument("--upscaler_structure", nargs="+", type=convert_to_upscaler,
                   default=[convert_to_upscaler(s) for s in _DEF_UPSCALER])
    p.add_argument("--norm_type", choices=["instancenorm", "batchnorm", "none"],
                   default="none")
    p.add_argument("--norm_type_features",
                   choices=["instancenorm", "batchnorm", "none"], default="batchnorm")
    p.add_argument("--structure_scaler", type=int, default=2)
    p.add_argument("--temperature", type=restricted_float, default=0.7)
    p.add_argument("--prior_structure", nargs="+", type=convert_mixed_list,
                   default=[256, 64])
    p.add_argument("--encoder_structure", nargs="+", type=convert_mixed_list,
                   default=[256, 64])
    p.add_argument("--skip_connection_flow",
                   choices=["without_skip", "with_skip", "only_skip"],
                   default="with_skip")
    add_bool_arg(p, "downscaler_tanh", default=False)
    add_bool_arg(p, "upscaler_tanh", default=False)
    add_bool_arg(p, "skip_connection_features", default=True)
    p.add_argument("--free_bits", type=float, default=-1.0)
    # Glow
    add_bool_arg(p, "learn_prior", default=True)
    add_bool_arg(p, "LU_decomposed", default=True)
    p.add_argument("--n_units_affine", type=int, default=256)
    p.add_argument("--non_lin_glow", choices=["relu", "leakyrelu"], default="relu")
    p.add_argument("--n_units_prior", type=int, default=512)
    add_bool_arg(p, "make_conditional", default=True)
    p.add_argument("--flow_norm", choices=["batchnorm", "actnorm"], default="actnorm")
    p.add_argument("--base_norm", choices=["batchnorm", "actnorm"], default="actnorm")
    p.add_argument("--flow_batchnorm_momentum", type=float, default=0.0)
    p.add_argument("--clamp_type", choices=["glow", "realnvp", "softclamp", "none"],
                   default="realnvp")
    p.add_argument("--split2d_act", choices=["softplus", "exp"], default="softplus")
    # smoothing / overshooting / res_q
    p.add_argument("--a_dim", type=int, default=200)
    add_bool_arg(p, "enable_smoothing", default=False)
    add_bool_arg(p, "res_q", default=False)
    p.add_argument("--D", type=int, default=0)
    p.add_argument("--overshot_w", type=float, default=1.0)
    return p


def config_from_args(args) -> RFNConfig:
    glow = GlowConfig(
        L=args.L,
        K=args.K,
        n_bits=args.n_bits,
        learn_prior=args.learn_prior,
        lu_decomposed=args.LU_decomposed,
        n_units_affine=args.n_units_affine,
        n_units_prior=args.n_units_prior,
        non_lin=args.non_lin_glow,
        make_conditional=args.make_conditional,
        flow_norm=args.flow_norm,
        base_norm=args.base_norm,
        batchnorm_momentum=args.flow_batchnorm_momentum,
        clamp_type=args.clamp_type,
        split2d_act=args.split2d_act,
    )
    return RFNConfig(
        x_channels=args.x_channels if args.choose_data != "bair" else 3,
        image_size=args.image_size,
        h_dim=args.h_dim,
        z_dim=args.z_dim,
        a_dim=args.a_dim,
        L=args.L,
        K=args.K,
        extractor_structure=tuple(tuple(b) for b in args.extractor_structure),
        upscaler_structure=tuple(tuple(b) for b in args.upscaler_structure),
        prior_structure=tuple(args.prior_structure),
        encoder_structure=tuple(args.encoder_structure),
        structure_scaler=args.structure_scaler,
        norm_type=args.norm_type,
        norm_type_features=args.norm_type_features,
        skip_connection_flow=args.skip_connection_flow,
        skip_connection_features=args.skip_connection_features,
        downscaler_tanh=args.downscaler_tanh,
        upscaler_tanh=args.upscaler_tanh,
        free_bits=args.free_bits,
        enable_smoothing=args.enable_smoothing,
        res_q=args.res_q,
        D=args.D,
        overshot_w=args.overshot_w,
        temperature=args.temperature,
        glow=glow,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    check_supported(cfg)
    init = torch.Generator().manual_seed(args.seed)
    return run_training(lambda device: RFN(cfg, device=device, generator=init), args)


if __name__ == "__main__":
    main()

"""Offline evaluation CLI, the counterpart of
``recurrent_flows_tpu.cli.eval_settings``:

    python -m recurrent_flows_tpu_torch.cli.eval_settings --path <workdir>
        [--thesis_protocol] [--device cpu]

Loads the checkpoint ``<workdir>/model_folder/<last|best>`` (the port's
``state.pt``, or a JAX checkpoint exported to ``state.npz`` by
``scripts/jax_checkpoint_to_npz.py``), rebuilds the model of its
``model_class`` from the frozen config on ``--device`` (the card unless
asked), and runs the evaluation protocol: best-of-N metric tracks,
dataset bits/dim, FVD, the IW-ELBO (SRNN, VRNN, SVG), RFN's
``probability_future`` and ELBO-gap diagnostics, and, with
``--debug_plot``, the figures (numpy, no matplotlib). Writes
``<workdir>/eval/evaluations.json`` (the JAX CLI's keys and ``_meta``) and
appends to ``eval_avg_losses.txt``.

Without weight files the perceptual metrics are the JAX package's proxies:
LPIPS from a fixed random-feature pyramid and FVD from ``random3d``
(``--fvd_embedder i3d`` needs an I3D npz and raises without one).
"""

from __future__ import annotations

import argparse
import json
import os
import types

import numpy as np
import torch

from ..data.framecache import FrameCache
from ..evaluation.evaluator import EvalSettings, Evaluator
from ..training.checkpoint import load_model_from_checkpoint
from ..training.trainer import preprocess
from .common import add_bool_arg, build_dataset


def build_parser():
    p = argparse.ArgumentParser("eval_settings")
    p.add_argument("--path", required=True, help="trainer workdir")
    p.add_argument("--checkpoint", default="last", choices=["last", "best"])
    p.add_argument("--n_conditions", type=int, default=5)
    p.add_argument("--n_predictions", type=int, default=10)
    p.add_argument("--resamples", type=int, default=5)
    p.add_argument("--n_batches", type=int, default=4)
    p.add_argument("--n_sequences", type=int, default=None,
                   help="evaluate this many test sequences (overrides "
                        "--n_batches; thesis protocol defaults to 128)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--temperatures", nargs="*", type=float, default=None,
                   help="temperature sweep mode")
    p.add_argument("--fvd_embedder", default="auto", choices=["auto", "i3d", "random3d"])
    p.add_argument("--fvd_horizon", type=int, default=None,
                   help="FVD over only this many predicted frames")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model, the data and the metrics")
    add_bool_arg(p, "use_fvd", default=True)
    add_bool_arg(p, "use_lpips", default=True)
    add_bool_arg(p, "debug_plot", default=True)
    add_bool_arg(p, "thesis_protocol", default=False,
                 help="the reference's published protocol: 30-frame test "
                      "sequences, predict from frame 5, best-of-30 resamples, "
                      "FVD over 13 frames, temperature 0.7")
    return p


def apply_thesis_protocol(args):
    """Overwrite the knobs with the reference protocol's constants."""
    args.n_conditions = 5
    args.n_predictions = 25  # 30-frame sequences, predict from frame 5
    args.resamples = 30
    args.fvd_horizon = 13
    if args.n_sequences is None:
        # the reference iterates its whole test loader; generated data has
        # no fixed test set, so the protocol defaults to a CI-stable sample
        args.n_sequences = 128
    if args.temperature is None:
        args.temperature = 0.7
    return args


class _ModelSpaceData:
    """The test sampler of a frozen train config, in model space on the
    device: Moving MNIST and the shapes are made there; a frame cache's host
    batch (drawn with a seed from the generator) and a PNG loader's (drawn
    by its own seeded state) are moved there."""

    def __init__(self, raw, tcfg, device):
        self.raw, self.tcfg, self.device = raw, tcfg, torch.device(device)

    def sample(self, generator, batch_size: int):
        t = self.tcfg
        if hasattr(self.raw, "sample"):
            x = self.raw.sample(generator, batch_size)
        elif not isinstance(self.raw, FrameCache):
            x = torch.as_tensor(self.raw.sample_numpy(batch_size), device=self.device)
        else:
            if batch_size > self.raw.batch_size:
                raise ValueError(f"the frame cache holds batches of {self.raw.batch_size}, "
                                 f"not {batch_size}")
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                     device=generator.device))
            x = torch.as_tensor(self.raw.sample_numpy(seed)[:batch_size], device=self.device)
        return preprocess(x, t.n_bits, t.preprocess_range, t.preprocess_scale)


def _postprocess(tcfg):
    """Model space -> [0, 1] image space, clipped, per ``preprocess_range``."""
    def post(a):
        if tcfg.preprocess_range == "0.5":
            return torch.clamp(a + 0.5, 0.0, 1.0)
        if tcfg.preprocess_range == "minmax":
            return torch.clamp((a + 1) * 0.5, 0.0, 1.0)
        return torch.clamp(a, 0.0, 1.0)
    return post


def _listed(d: dict) -> dict:
    return {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in d.items()}


def _evaluate_once(model, tcfg, args, out_dir, temperature=None):
    da = types.SimpleNamespace(
        choose_data=tcfg.choose_data,
        n_frames=max(tcfg.n_frames, args.n_conditions + args.n_predictions),
        image_size=getattr(model.cfg, "image_size", 64), digit_size=tcfg.digit_size,
        num_digits=tcfg.num_digits, step_length=tcfg.step_length, data_root="./data",
        batch_size=args.batch_size)
    raw = build_dataset(da, train=False, device=args.device)
    settings = EvalSettings(
        n_conditions=args.n_conditions, n_predictions=args.n_predictions,
        resamples=args.resamples, n_batches=args.n_batches, batch_size=args.batch_size,
        temperature=temperature, fvd_horizon=args.fvd_horizon)
    ev = Evaluator(model, _ModelSpaceData(raw, tcfg, args.device), settings,
                   postprocess=_postprocess(tcfg), device=args.device, seed=0)
    results = _listed(ev.get_eval_values(with_lpips=args.use_lpips,
                                         save_grids_dir=out_dir if args.debug_plot else None))
    results["dataset_bpd"] = ev.get_loss()
    if args.use_fvd:
        results["fvd"] = ev.get_fvd_values(embedder=args.fvd_embedder)
    if hasattr(type(model), "elbo_importance_weighting"):
        results["iw_elbo_k20"] = ev.importance_weighted_elbo(K=20)
    # RFN's posterior-health diagnostics
    if hasattr(type(model), "probability_future"):
        results["probability_future"] = _listed(ev.probability_future_bpp())
    if hasattr(type(model), "reconstruct_elbo_gap"):
        results["elbo_gap"] = _listed(ev.elbo_gap())
    if args.debug_plot:
        ev.plot_long_rollout(40, os.path.join(out_dir, "long_rollout.png"))
        ev.plot_diversity(4, os.path.join(out_dir, "diversity.png"))
        ev.plot_random_samples(5, path=os.path.join(out_dir, "plot_rollouts.png"))
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.thesis_protocol:
        args = apply_thesis_protocol(args)
    if args.n_sequences is not None:
        args.n_batches = -(-args.n_sequences // args.batch_size)
    ckpt_dir = os.path.join(args.path, "model_folder", args.checkpoint)
    out_dir = os.path.join(args.path, "eval")
    os.makedirs(out_dir, exist_ok=True)

    temps = args.temperatures or [args.temperature]
    all_results = {}
    for t in temps:
        model, tcfg, meta = load_model_from_checkpoint(ckpt_dir, t, device=args.device)
        all_results[str(t)] = _evaluate_once(model, tcfg, args, out_dir, t)
        del model
    payload = all_results if args.temperatures else next(iter(all_results.values()))
    # provenance, so the artifact can be archived as it is
    payload["_meta"] = dict(
        checkpoint=os.path.join(args.path, args.checkpoint),
        model_class=meta.get("model_class"),
        epoch=meta.get("epoch"),
        step=meta.get("counter"),
        protocol=("thesis_protocol" if args.thesis_protocol else "custom"),
        n_conditions=args.n_conditions,
        n_predictions=args.n_predictions,
        resamples=args.resamples,
        n_sequences=args.n_sequences,
        temperature=(args.temperatures or args.temperature),
        data_source=tcfg.choose_data,
    )
    with open(os.path.join(out_dir, "evaluations.json"), "w") as f:
        json.dump(payload, f, indent=2, default=float)
    with open(os.path.join(out_dir, "eval_avg_losses.txt"), "a") as f:
        for t, res in all_results.items():
            f.write(f"temp={t} bpd={res.get('dataset_bpd')} fvd={res.get('fvd')}\n")
    print(json.dumps({k: v for k, v in payload.items() if not isinstance(v, list)},
                     default=float))
    return payload


if __name__ == "__main__":
    main()

"""Export a trained checkpoint's predict program to one ``torch.export``
artifact, the counterpart of ``recurrent_flows_tpu.cli.export_serving``:

    python -m recurrent_flows_tpu_torch.cli.export_serving \\
        --checkpoint runs/rfn/model_folder/last --out rfn_predict.pt2 \\
        --batch_size 8 [--device cpu]

Packages preprocess -> autoregressive rollout -> postprocess (weights
embedded) into one file that ``recurrent_flows_tpu_torch.serving
.load_exported`` serves with no model code, config or checkpoint; the
port's ``ops`` package (the ``rft::`` kernel operators) must be importable
where it is loaded. The program is exported on ``--device`` (the card
unless asked) and runs there. See ``serving.Predictor.export``.
"""

from __future__ import annotations

import argparse


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint dir (e.g. <run>/model_folder/last)")
    ap.add_argument("--out", required=True, help="output artifact path")
    ap.add_argument("--batch_size", type=int, required=True,
                    help="fixed serving batch size baked into the artifact")
    ap.add_argument("--n_conditions", type=int, default=5)
    ap.add_argument("--n_predictions", type=int, default=10)
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--image_size", type=int, default=None,
                    help="default: the checkpoint config's image_size")
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--platforms", default=None,
                    help="comma-separated targets, kept for the JAX CLI's flags: only "
                         "the device itself is accepted ('cuda' or 'gpu' for cuda, "
                         "'cpu' for cpu)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the program is exported on and runs on")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..serving import Predictor

    platforms = tuple(args.platforms.split(",")) if args.platforms else None
    pred = Predictor.from_checkpoint(
        args.checkpoint, device=args.device, n_conditions=args.n_conditions,
        n_predictions=args.n_predictions, temperature=args.temperature)
    blob = pred.export(args.out, batch_size=args.batch_size, image_size=args.image_size,
                       channels=args.channels, platforms=platforms)
    print(f"wrote {args.out} ({len(blob)} bytes, batch={args.batch_size}, "
          f"predict {args.n_predictions} from {args.n_conditions}, on {pred.device})")
    return blob


if __name__ == "__main__":
    main()

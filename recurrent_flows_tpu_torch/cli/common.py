"""Shared CLI plumbing, the part of ``recurrent_flows_tpu.cli.common`` that
evaluation needs: the paired boolean flags (--x / --no-x) and the dataset
of a frozen train config. The training CLIs' flag groups are ROADMAP.md
queue 1, item 7."""

from __future__ import annotations

import os


def add_bool_arg(parser, name, help="", default=False):
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("--" + name, dest=name, action="store_true", help=help)
    group.add_argument("--no-" + name, dest=name, action="store_false", help=help)
    parser.set_defaults(**{name: default})


def build_dataset(args, train: bool = True, device="cuda"):
    """The sampler of ``args.choose_data``: Moving MNIST made on ``device``
    (``.sample(generator, batch_size)``), or KTH/BAIR through the native
    frame cache where ``<data_root>/<kth|bair>_<train|test>.blob`` exists
    (``scripts/build_framecache.py``; host batches of ``args.batch_size``).
    The others raise: the generated shapes are ROADMAP.md queue 1 item 5b,
    the Python KTH/BAIR loaders item 7."""
    if args.choose_data == "mnist":
        from ..data import MovingMNIST

        return MovingMNIST(
            train=train, data_root=args.data_root, seq_len=args.n_frames,
            image_size=args.image_size, digit_size=args.digit_size,
            num_digits=args.num_digits, step_length=args.step_length,
            deterministic=False, digit_bank=getattr(args, "digit_bank", "auto"),
            device=device)
    if args.choose_data == "shapes":
        raise NotImplementedError("choose_data='shapes': the MovingShapes generator is not "
                                  "ported yet (ROADMAP.md queue 1, item 5b)")
    if args.choose_data in ("kth", "bair"):
        from ..data import framecache as fcache

        split = "train" if train else "test"
        blob = os.path.join(args.data_root, f"{args.choose_data}_{split}.blob")
        if os.path.exists(blob) and fcache.is_available():
            return fcache.FrameCache(blob, seq_len=args.n_frames, batch_size=args.batch_size)
        raise NotImplementedError(
            f"choose_data={args.choose_data!r} needs the frame blob {blob} "
            "(scripts/build_framecache.py); the Python KTH/BAIR loaders are not ported yet "
            "(ROADMAP.md queue 1, item 7)")
    raise ValueError(args.choose_data)

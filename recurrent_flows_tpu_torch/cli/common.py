"""Shared CLI plumbing, the counterpart of ``recurrent_flows_tpu.cli.common``:
the paired boolean flags (--x / --no-x), the [0, 1] restricted float, the
hyphen-separated structure DSL, the data and trainer flag groups (the JAX
CLIs' flags, defaults and choices, plus ``--device``), the dataset of a
choice and the training run.

``--multigpu`` trains data-parallel over ``torch.distributed``, one process
per card under ``torchrun`` (``parallel.initialize`` joins the group from
its environment; ``--batch_size`` is the global batch). Without a torchrun
environment it trains in one process, as the JAX CLI does with one device.
The CLI never starts processes itself.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..config import TrainConfig, parse_block


def add_bool_arg(parser, name, help="", default=False):
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("--" + name, dest=name, action="store_true", help=help)
    group.add_argument("--no-" + name, dest=name, action="store_false", help=help)
    parser.set_defaults(**{name: default})


def restricted_float(x):
    x = float(x)
    if x < 0.0 or x > 1.0:
        raise argparse.ArgumentTypeError(f"{x!r} not in range [0.0, 1.0]")
    return x


def convert_mixed_list(x):
    return int(x) if str(x).isdigit() else x


def convert_to_upscaler(x):
    return parse_block(x)


def add_data_args(p):
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_frames", type=int, default=10)
    p.add_argument("--choose_data", choices=["mnist", "bair", "kth", "shapes"],
                   default="mnist")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--digit_size", type=int, default=32)
    p.add_argument("--step_length", type=int, default=4)
    p.add_argument("--num_digits", type=int, default=2)
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--digit_bank", choices=["auto", "mnist", "synthetic", "sklearn"],
                   default="auto",
                   help="MovingMNIST digit source: real MNIST IDX files "
                        "(scripts/fetch_mnist.py), procedural sprites, or "
                        "sklearn's real 8x8 digits; auto = mnist if on disk "
                        "else synthetic")
    add_bool_arg(p, "use_validation_set", default=False)


def add_trainer_args(p):
    p.add_argument("--scheduler_type", choices=["plateau", "linear"], default="plateau")
    p.add_argument("--patience_es", type=int, default=50_000_000)
    p.add_argument("--patience_lr", type=int, default=10_000_000)
    p.add_argument("--checkpoint_every", type=int, default=1,
                   help="save a full checkpoint every N epochs")
    p.add_argument("--factor_lr", type=restricted_float, default=0.9999)
    p.add_argument("--min_lr", type=float, default=5e-5)
    p.add_argument("--n_bits", type=int, default=8)
    p.add_argument("--n_epochs", type=int, default=100)
    p.add_argument("--steps_per_epoch", type=int, default=1875)
    p.add_argument("--path", type=str, default="./runs/exp")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--preprocess_range", choices=["0.5", "1.0", "none", "minmax"],
                   default="0.5")
    p.add_argument("--preprocess_scale", type=int, default=255)
    p.add_argument("--beta_max", type=float, default=1.0)
    p.add_argument("--beta_min", type=float, default=1e-7)
    p.add_argument("--beta_steps", type=int, default=12_000)
    p.add_argument("--n_predictions", type=int, default=7)
    p.add_argument("--n_conditions", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and the data ('cuda' is "
                        "cuda:LOCAL_RANK under --multigpu)")
    add_bool_arg(p, "multigpu", default=False,
                 help="data-parallel over torch.distributed, one process per card "
                      "under torchrun; --batch_size is the global batch")
    add_bool_arg(p, "load_model", default=False)
    add_bool_arg(p, "auto_resume", default=False,
                 help="resume automatically when a checkpoint exists in --path")
    add_bool_arg(p, "verbose", default=False)


def train_config_from_args(args) -> TrainConfig:
    return TrainConfig(
        batch_size=args.batch_size,
        n_frames=args.n_frames,
        choose_data=args.choose_data,
        digit_size=args.digit_size,
        step_length=args.step_length,
        num_digits=args.num_digits,
        n_bits=args.n_bits,
        preprocess_range=args.preprocess_range,
        preprocess_scale=args.preprocess_scale,
        learning_rate=args.learning_rate,
        scheduler_type=args.scheduler_type,
        patience_lr=args.patience_lr,
        factor_lr=args.factor_lr,
        min_lr=args.min_lr,
        patience_es=args.patience_es,
        beta_max=args.beta_max,
        beta_min=args.beta_min,
        beta_steps=args.beta_steps,
        n_epochs=args.n_epochs,
        steps_per_epoch=args.steps_per_epoch,
        checkpoint_every=args.checkpoint_every,
        n_predictions=args.n_predictions,
        n_conditions=args.n_conditions,
        seed=args.seed,
        grad_clip=args.grad_clip,
    )


class FixedSubsetSampler:
    """Cycle a fixed pool of batch seeds: the generated-data equivalent of
    the reference's 500-item training subset (--use_validation_set):
    smoke runs see the same small set of sequences every epoch. Each batch
    is drawn by a ``torch.Generator`` of the inner sampler's device seeded
    from the pool, whatever generator the caller passes."""

    def __init__(self, inner, n_items: int = 500, batch_size: int = 32):
        self.inner = inner
        self.n_batches = max(n_items // batch_size, 1)
        pool = torch.Generator().manual_seed(1234)
        self._seeds = torch.randint(0, 2 ** 62, (self.n_batches,), generator=pool).tolist()
        self._i = 0

    def sample(self, generator, batch_size: int):
        seed = self._seeds[self._i % self.n_batches]
        self._i += 1
        return self.inner.sample(
            torch.Generator(device=self.inner.device).manual_seed(seed), batch_size)


def build_dataset(args, train: bool = True, device="cuda"):
    """The sampler of ``args.choose_data``: Moving MNIST or the moving shapes
    made on ``device`` (``.sample(generator, batch_size)``); KTH or BAIR
    through the native frame cache where
    ``<data_root>/<kth|bair>_<train|test>.blob`` exists
    (``python -m recurrent_flows_tpu_torch.cli.build_framecache``), else the
    PNG loaders, host batches of ``args.batch_size``."""
    from ..data import KTH, MovingMNIST, MovingShapes, PushDataset

    if args.choose_data == "mnist":
        return MovingMNIST(
            train=train, data_root=args.data_root, seq_len=args.n_frames,
            image_size=args.image_size, digit_size=args.digit_size,
            num_digits=args.num_digits, step_length=args.step_length,
            deterministic=False, digit_bank=getattr(args, "digit_bank", "auto"),
            device=device)
    if args.choose_data == "shapes":
        return MovingShapes(seq_len=args.n_frames, image_size=args.image_size, device=device)
    if args.choose_data in ("kth", "bair"):
        from ..data import framecache as fcache

        split = "train" if train else "test"
        blob = os.path.join(args.data_root, f"{args.choose_data}_{split}.blob")
        if os.path.exists(blob) and fcache.is_available():
            return fcache.FrameCache(blob, seq_len=args.n_frames, batch_size=args.batch_size)
        if args.choose_data == "kth":
            return KTH(train=train, data_root=args.data_root, seq_len=args.n_frames,
                       image_size=args.image_size, batch_size=args.batch_size)
        return PushDataset(split=split, dataset_dir=args.data_root, seq_len=args.n_frames,
                           batch_size=args.batch_size)
    raise ValueError(args.choose_data)


def setup_training(make_model, args, dp=None):
    """The built ``Trainer`` of a CLI run on this process's device: the model
    (``make_model(device)``), the training data (its digit bank written to
    ``status.txt`` as the ``data_source`` line), the data-dependent init,
    and, with ``--load_model`` (or ``--auto_resume`` and a ``last``
    checkpoint in ``--path``), the checkpoint ``last``. ``dp`` (a
    ``parallel.DataParallel``) makes it one rank of a data-parallel run."""
    from ..training import Trainer

    device = dp.device if dp is not None else torch.device(args.device)
    primary = dp is None or dp.primary
    model = make_model(device)
    tcfg = train_config_from_args(args)
    data = build_dataset(args, train=True, device=device)
    if hasattr(data, "bank_kind") and primary:
        # make the digit source unmissable in the console and in the run's record
        print(f"[data] MovingMNIST digit bank: {data.bank_kind}")
        os.makedirs(os.path.join(args.path, "model_folder"), exist_ok=True)
        with open(os.path.join(args.path, "model_folder", "status.txt"), "a") as f:
            f.write(f"data_source moving_mnist bank={data.bank_kind}\n")
    if getattr(args, "use_validation_set", False) and hasattr(data, "sample"):
        data = FixedSubsetSampler(data, 500, args.batch_size)
    tr = Trainer(model, tcfg, data, args.path, device=device, dp=dp).build()
    ckpt = os.path.join(args.path, "model_folder", "last", "meta.json")
    if args.load_model or (getattr(args, "auto_resume", False) and os.path.exists(ckpt)):
        tr.load("last")
    return tr


def run_training(make_model, args):
    """Train as the CLI's flags say (``setup_training``, then ``fit``);
    under ``--multigpu`` join the torchrun group first and leave it at the
    end. Returns the ``Trainer``."""
    from ..parallel import initialize

    dp = initialize(args.device) if args.multigpu else None
    if args.multigpu and dp is None:
        print("[multigpu] no torchrun environment (WORLD_SIZE unset): one process")
    try:
        tr = setup_training(make_model, args, dp)
        tr.fit()
    finally:
        if dp is not None:
            dp.close()
    return tr

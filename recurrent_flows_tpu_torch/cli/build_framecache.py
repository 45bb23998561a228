"""Build the native frame cache's blobs from KTH or BAIR frame directories,
the port's counterpart of ``scripts/build_framecache.py``:

    python -m recurrent_flows_tpu_torch.cli.build_framecache --dataset kth --data_root ./kth_data
    python -m recurrent_flows_tpu_torch.cli.build_framecache --dataset bair \\
        --data_root ./bair_robot_data/processed_data

Decodes every PNG once (``data.png.read_png``) and writes
``<data_root>/<dataset>_<train|test>.blob``; afterwards the training and
eval CLIs serve KTH and BAIR batches from the C++ prefetch ring
(``data.framecache.FrameCache``). Needs g++, neither matplotlib nor JAX.
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["kth", "bair"], required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--max_videos", type=int, default=None)
    return p


def main(argv=None) -> list:
    """Writes both splits' blobs; returns their paths."""
    args = build_parser().parse_args(argv)

    from ..data import KTH, PushDataset
    from ..data.framecache import blob_from_loader, ensure_built

    if not ensure_built():
        raise RuntimeError("build_framecache: the frame cache needs a g++ toolchain")
    written = []
    for split, train in (("train", True), ("test", False)):
        if args.dataset == "kth":
            loader = KTH(train=train, data_root=args.data_root, seq_len=1)
        else:
            loader = PushDataset(split=split, dataset_dir=args.data_root, seq_len=1)
        out = os.path.join(args.data_root, f"{args.dataset}_{split}.blob")
        blob_from_loader(loader, out, max_videos=args.max_videos)
        print("wrote", out)
        written.append(out)
    return written


if __name__ == "__main__":
    main()

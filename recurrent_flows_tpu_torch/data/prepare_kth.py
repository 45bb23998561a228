"""KTH download and frame extraction, the counterpart of
``recurrent_flows_tpu.data.prepare_kth``, with the same flags and the same
subprocess calls: ``wget`` and ``tar`` for the preprocessed tarball, or
``ffmpeg`` over the raw ``.avi`` files, into the layout ``data/kth.py``
reads: ``<root>/processed/<class>/<video>/image-NNN.png``. Nothing is
imported for it but the standard library; on a host without network the
download returns False and says where to put the frames.

Usage:
  python -m recurrent_flows_tpu_torch.data.prepare_kth --data_root ./kth_data \\
      [--image_size 64] [--from_raw]
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys

CLASSES = ("boxing", "handclapping", "handwaving", "jogging", "running", "walking")
_PROCESSED_URL = "http://www.cs.nyu.edu/~denton/datasets/kth.tar.gz"


def download_processed(data_root: str) -> bool:
    """wget the preprocessed tarball into ``data_root`` and untar it there;
    False (with a message on stderr) where either command fails."""
    tar = os.path.join(data_root, "kth.tar.gz")
    try:
        subprocess.run(["wget", "-q", _PROCESSED_URL, "-O", tar], check=True)
        subprocess.run(["tar", "-xzf", tar, "-C", data_root], check=True)
        return True
    except Exception as e:  # no network, no wget: the frames are placed by hand
        print(f"download failed ({e}); place frames under "
              f"{data_root}/processed/<class>/<video>/ manually", file=sys.stderr)
        return False


def extract_frames(data_root: str, image_size: int = 64) -> None:
    """ffmpeg each ``<root>/raw/<class>/*.avi`` into
    ``<root>/processed/<class>/<video>/image-NNN.png`` at ``image_size``."""
    for cls in CLASSES:
        for avi in glob.glob(os.path.join(data_root, "raw", cls, "*.avi")):
            name = os.path.splitext(os.path.basename(avi))[0]
            out_dir = os.path.join(data_root, "processed", cls, name)
            os.makedirs(out_dir, exist_ok=True)
            subprocess.run(
                ["ffmpeg", "-v", "error", "-i", avi,
                 "-vf", f"scale={image_size}:{image_size}",
                 os.path.join(out_dir, "image-%03d.png")],
                check=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default="./kth_data")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--from_raw", action="store_true",
                   help="extract frames from raw .avi files instead of "
                        "downloading the preprocessed tarball")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.data_root, exist_ok=True)
    if args.from_raw:
        extract_frames(args.data_root, args.image_size)
    else:
        download_processed(args.data_root)


if __name__ == "__main__":
    main()

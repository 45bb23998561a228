#!/usr/bin/env python3
"""Write the random weights of the JAX package's two proxy embedders to the
npz the PyTorch port reads.

    JAX_PLATFORMS=cpu python scripts/export_proxy_embedder_weights.py [--out PATH]

The LPIPS proxy (``recurrent_flows_tpu/evaluation/lpips.py``,
``_feature_pyramid``) and the FVD proxy ``random3d``
(``evaluation/fvd.py``, ``_random3d_embed``) draw their weights with
``jax.random.normal`` from seed 0. The port imports no JAX, so it reads
those arrays from ``recurrent_flows_tpu_torch/evaluation/proxy_weights.npz``
(the default ``--out``), and its proxy LPIPS and FVD are the JAX package's.
Each array is the JAX expression evaluated on the CPU, scale included:

* ``lpips/conv{i}``, i = 0..3: [3, 3, cin, ch] (HWIO), ch = 32, 64, 128,
  256, cin = 3 then the previous ch: normal(fold_in(key(0), i)) / sqrt(9·cin);
* ``random3d/conv{i}``, i = 0..2: [3, 3, 3, cin, ch] (DHWIO), ch = 16, 32,
  64, cin = 3 then the previous ch: normal(fold_in(key(0), i)) / sqrt(27·cin);
* ``random3d/proj``: [64, 256], normal(fold_in(key(0), 99)) / sqrt(64).

Both embedders take gray frames as three repeated channels, so cin = 3 is
the only first-layer width either draws at.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

OUT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                    "recurrent_flows_tpu_torch", "evaluation",
                                    "proxy_weights.npz"))


def proxy_arrays() -> dict:
    """The arrays, in the npz's keys, as numpy float32."""
    import jax

    key = jax.random.key(0)
    out, cin = {}, 3
    for i, ch in enumerate((32, 64, 128, 256)):
        w = jax.random.normal(jax.random.fold_in(key, i), (3, 3, cin, ch)) / np.sqrt(9 * cin)
        out[f"lpips/conv{i}"], cin = np.asarray(w), ch
    cin = 3
    for i, ch in enumerate((16, 32, 64)):
        w = jax.random.normal(jax.random.fold_in(key, i), (3, 3, 3, cin, ch)) / np.sqrt(
            27 * cin)
        out[f"random3d/conv{i}"], cin = np.asarray(w), ch
    proj = jax.random.normal(jax.random.fold_in(key, 99), (cin, 256)) / np.sqrt(cin)
    out["random3d/proj"] = np.asarray(proj)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args()
    arrays = proxy_arrays()
    np.savez(args.out, **arrays)
    n = sum(a.size for a in arrays.values())
    print(f"{args.out}: {len(arrays)} arrays, {n} float32 weights")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Export a checkpoint of the JAX package (orbax) to the npz the PyTorch
port reads.

    python scripts/jax_checkpoint_to_npz.py runs/rfn/model_folder/last [--out DIR]

Needs JAX, flax and orbax, so it runs on a host that has them; the port
(``recurrent_flows_tpu_torch``) cannot read orbax, which imports JAX. It
writes ``<out>/state.npz`` (``--out`` defaults to the checkpoint directory
itself) and copies ``meta.json`` beside it, so ``<out>`` is a checkpoint
that ``recurrent_flows_tpu_torch.serving.Predictor.from_checkpoint`` and
``Trainer.load`` take. The npz holds flat '/'-joined keys:
``params/...``, ``consts/...``, ``batch_stats/...`` (where the model has
running statistics), ``adam/mu/...``, ``adam/nu/...``, ``adam/count`` and
``step``.

The checkpoint is restored without a target, so optax's state comes back
as plain containers (``inject_hyperparams`` -> ``chain`` ->
``ScaleByAdamState``, tuples as lists); the Adam state is the one node
with ``mu``, ``nu`` and ``count``, wherever ``grad_clip`` put it in the
chain.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from collections.abc import Mapping

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _flatten(tree, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def _adam_states(node):
    """Every node of the restored optimizer state with mu, nu and count."""
    if isinstance(node, Mapping):
        if {"mu", "nu", "count"} <= set(node):
            yield node
            return
        children = node.values()
    elif isinstance(node, (list, tuple)):
        children = node
    else:
        return
    for child in children:
        yield from _adam_states(child)


def export(ckpt_dir: str, out_dir: str | None = None) -> str:
    """Write ``state.npz`` and ``meta.json`` of the JAX checkpoint at
    ``ckpt_dir`` into ``out_dir``; returns the npz's path."""
    from recurrent_flows_tpu.training.checkpoint import load_checkpoint

    out_dir = out_dir or ckpt_dir
    state, _ = load_checkpoint(ckpt_dir)
    adam = list(_adam_states(state["opt_state"]))
    if len(adam) != 1:
        raise ValueError(f"{ckpt_dir}: expected one Adam state in the optimizer "
                         f"state, found {len(adam)}")
    flat: dict = {}
    _flatten(state["params"], "params/", flat)
    _flatten(state.get("consts") or {}, "consts/", flat)
    _flatten(state.get("stats") or {}, "", flat)  # {'batch_stats': ...}
    _flatten({k: adam[0][k] for k in ("mu", "nu")}, "adam/", flat)
    flat["adam/count"] = np.asarray(adam[0]["count"])
    flat["step"] = np.asarray(state["step"])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "state.npz")
    np.savez(path, **flat)
    if os.path.abspath(out_dir) != os.path.abspath(ckpt_dir):
        shutil.copy(os.path.join(ckpt_dir, "meta.json"), os.path.join(out_dir, "meta.json"))
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", help="a JAX checkpoint directory (state/ and meta.json)")
    p.add_argument("--out", default=None, help="output directory (default: the checkpoint)")
    args = p.parse_args(argv)
    print(export(args.checkpoint, args.out))


if __name__ == "__main__":
    main()

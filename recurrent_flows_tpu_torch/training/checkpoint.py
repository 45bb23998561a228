"""Checkpoints: the port's own, and JAX ones exported to npz.

The counterpart of ``recurrent_flows_tpu.training.checkpoint``. A checkpoint
is a directory holding ``meta.json`` (the host-side counters, histories
and both configs, with the keys the JAX ``Trainer.checkpoint`` writes) and
the device state, one of:

* ``state.pt``, the port's own: ``torch.save`` of {"model": the model's
  ``state_dict`` with its buffers, "optimizer": Adam's ``state_dict``,
  "step": optimizer steps taken}, read back with ``weights_only=True``;
* ``state.npz``, a JAX (orbax) checkpoint exported by
  ``scripts/jax_checkpoint_to_npz.py`` on a host with JAX: the flax
  ``params``, ``consts`` and ``batch_stats`` trees and optax's Adam
  ``mu``/``nu``/``count`` as flat '/'-joined keys, plus ``step``; read
  through ``convert.from_flax`` and ``convert.adam_from_optax``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .. import config as _config
from ..config import TrainConfig, config_from_dict
from ..convert import adam_from_optax, from_flax

STATE, JAX_STATE, META = "state.pt", "state.npz", "meta.json"


def save_checkpoint(path: str, model, optimizer, step: int, meta: dict) -> None:
    """Write ``state.pt`` and ``meta.json`` under ``path``; each file is
    written aside and renamed into place, so a reader never sees half of
    one."""
    os.makedirs(path, exist_ok=True)
    state = dict(model=model.state_dict(),
                 optimizer=optimizer.state_dict() if optimizer is not None else None,
                 step=int(step))
    tmp = os.path.join(path, STATE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE))
    tmp = os.path.join(path, META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, META))


def read_meta(path: str) -> dict:
    with open(os.path.join(path, META)) as f:
        return json.load(f)


def _unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat.files:
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def load_state(path: str, model, optimizer=None) -> int:
    """Load the device state of the checkpoint at ``path`` into ``model``
    (parameters and buffers) and, when given, ``optimizer`` (an Adam over
    ``model``'s parameters). Returns the optimizer steps it had taken."""
    pt, npz = os.path.join(path, STATE), os.path.join(path, JAX_STATE)
    device = next(model.parameters()).device
    if os.path.exists(pt):
        state = torch.load(pt, map_location=device, weights_only=True)
        model.load_state_dict(state["model"])
        if optimizer is not None:
            if state["optimizer"] is None:
                raise ValueError(f"{pt} holds no optimizer state")
            optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])
    if os.path.exists(npz):
        with np.load(npz) as flat:
            tree = _unflatten(flat)
        model.load_state_dict(from_flax(tree["params"], tree.get("consts"), model,
                                        tree.get("batch_stats")))
        if optimizer is not None:
            adam = tree["adam"]
            adam_from_optax(adam["mu"], adam["nu"], int(adam["count"]), model, optimizer)
        return int(tree["step"])
    raise FileNotFoundError(f"no {STATE} or {JAX_STATE} under {path}")


FAMILIES = ("RFN", "SRNN", "VRNN", "SVG")  # model_class -> models.<name>, config.<name>Config


def load_model_from_checkpoint(ckpt_dir: str, temperature: float | None = None,
                               device="cuda"):
    """(model, tcfg, meta) of a checkpoint, the model (``meta.json``'s
    ``model_class``, one of ``FAMILIES``) on ``device`` (the card unless the
    caller asks for the CPU). ``temperature`` replaces the config's where it
    has one. ``eval_norm`` is on where the model tracked running
    statistics, as the JAX evaluator sets it."""
    from .. import models

    meta = read_meta(ckpt_dir)
    name = meta["model_class"]
    if name not in FAMILIES:
        # as the JAX registry (cli/eval_settings.py): a GlowImage's meta holds
        # its GlowConfig but not its constructor's other arguments
        raise ValueError(
            f"model_class {name!r}: checkpoints rebuild {', '.join(FAMILIES)}; build "
            "any other model yourself and load it with load_state")
    cfg = config_from_dict(getattr(_config, f"{name}Config"), meta["model_config"])
    if temperature is not None and hasattr(cfg, "temperature"):
        cfg = dataclasses.replace(cfg, temperature=temperature)
    model = getattr(models, name)(cfg, eval_norm=cfg.track_running_stats, device=device)
    load_state(ckpt_dir, model)
    return model, config_from_dict(TrainConfig, meta["train_config"]), meta

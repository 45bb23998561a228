#!/usr/bin/env python3
"""Training-curve overlay: the port's ``Trainer`` against the JAX package's,
on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_parity_curves.py [--steps 500]

Both trainers start from the same weights (the JAX ``Trainer.build`` with
its data-dependent init, converted into the port's model) and take
``--steps`` steps of ``train_epoch`` over the same numpy batches, drawn
once from the JAX package's Moving MNIST generator and fed to both as an
iterable, with the same Adam, learning rate and beta schedule. Each draws
its own loss noise (the frameworks cannot share a PRNG), so the curves
agree in distribution, not step for step. Writes the per-step losses (per
frame, as ``Trainer.losses`` keeps them) and the gap of their moving
averages to ``docs/torch/parity_curves.json``, and the overlay to
``docs/torch/parity_curves.png``. Needs JAX and matplotlib, so it runs
where JAX is installed, not on the card's machine.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

IMG, B, T, LR, SMOOTH = 32, 4, 4, 5e-4, 25


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--out", default=os.path.join(_REPO, "docs", "torch"))
    args = p.parse_args(argv)

    import jax
    import numpy as np
    import torch

    import torch_parity_utils as U
    from recurrent_flows_tpu.data import MovingMNIST as JMovingMNIST
    from recurrent_flows_tpu.models import RFN as JRFN
    from recurrent_flows_tpu.training.trainer import Trainer as JTrainer
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.training import Trainer

    torch.manual_seed(0)
    cfg = U.tiny_rfn_config(
        image_size=IMG, L=2, K=2, glow={"chain_impl": "off"},
        extractor_structure=((4, "pool", 8), (8, "pool", 16)),
        upscaler_structure=((16,), ("upsample", 8)))
    tcfg = dataclasses.replace(U.tiny_train_config(), batch_size=B, n_frames=T,
                               learning_rate=LR)
    data = JMovingMNIST(seq_len=T, image_size=IMG, digit_size=16, num_digits=1,
                        digit_bank="synthetic")
    batches = [np.asarray(data.sample(jax.random.key(1000 + i), B))
               for i in range(args.steps)]

    jm = JRFN(cfg, remat=False)
    object.__setattr__(jm, "init", jax.jit(jm.init))
    jt = JTrainer(jm, tcfg, batches, tempfile.mkdtemp())  # build makes its folders
    jt.build(jax.random.key(0))
    model = U.port_from(RFN(U.to_port(cfg)), {"params": jt.state.params,
                                              "consts": jt.state.consts})
    pt = Trainer(model, U.to_port(tcfg), batches, device="cpu").build(run_ddi=False)
    seconds = {}
    for name, trainer in (("jax", jt), ("port", pt)):
        t0 = time.perf_counter()
        trainer.train_epoch(steps=args.steps)
        seconds[name] = time.perf_counter() - t0
        print(f"{name}: {args.steps} steps in {seconds[name]:.1f} s, last loss "
              f"{trainer.losses[-1]:.2f}")

    def smooth(v):
        return np.convolve(v, np.ones(SMOOTH) / SMOOTH, mode="valid")

    curves = {name: [float(v) for v in tr.losses] for name, tr in (("jax", jt), ("port", pt))}
    sj, sp = smooth(curves["jax"]), smooth(curves["port"])
    gap = np.abs(sp - sj) / np.abs(sj)
    summary = dict(
        what="loss per frame of each train step, JAX Trainer vs the port's Trainer, "
             "same initial weights and batches, own noise each; CPU",
        config=dict(image_size=IMG, L=2, K=2, n_units_affine=U.U, batch_size=B,
                    n_frames=T, learning_rate=LR, steps=args.steps),
        smoothing=f"moving average over {SMOOTH} steps",
        mean_rel_gap=float(gap.mean()), max_rel_gap=float(gap.max()),
        first_smoothed=dict(jax=float(sj[0]), port=float(sp[0])),
        last_smoothed=dict(jax=float(sj[-1]), port=float(sp[-1])),
        cpu_seconds=seconds, curves=curves)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "parity_curves.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "curves"}))

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    for name, v in curves.items():
        ax.plot(v, alpha=0.3, label=f"{name} per step")
    ax.plot(np.arange(SMOOTH - 1, args.steps), sj, label="jax smoothed")
    ax.plot(np.arange(SMOOTH - 1, args.steps), sp, label="port smoothed")
    ax.set_xlabel("step")
    ax.set_ylabel("loss per frame")
    ax.set_title(f"JAX vs PyTorch port, CPU, {IMG}x{IMG} L=2 K=2 B={B} T={T}")
    ax.legend()
    ax.grid()
    fig.tight_layout()
    fig.savefig(os.path.join(args.out, "parity_curves.png"), dpi=80)


if __name__ == "__main__":
    main()

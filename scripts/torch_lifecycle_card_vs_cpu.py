#!/usr/bin/env python3
"""How far ``reconstruct``, ``sample`` and ``probability_future`` of a
fitted ``rfn_mnist_production`` model differ between the card and the CPU,
over several fits, and how large its flow samples are: the data behind the
limits of ``chip_smoke.py`` phase 11.

    python3 scripts/torch_lifecycle_card_vs_cpu.py [--seeds 0 1 2 3]

For each seed, as phase 11 does with seed 0: the model at full width
(``chain_impl='sample'``) made from the seed and moved off its init
(``perturb_``, seed + 1), a ``Trainer`` on the card's Moving MNIST with
``tcfg.seed`` = seed, the largest |x| of a flow sample before ``build``,
after it (data-dependent init) and after ``fit`` (2 epochs of 2 steps);
then ``chip_smoke.lifecycle_card_vs_cpu``. Prints per output the largest
|err|, the largest |err|/(1+|ref|) over elements, |err|/(1+max|ref|) and
max |ref|; the card's name and power limit first. Writes
``chiprun_out/lifecycle_card_vs_cpu.json``. About a minute per seed on one
H100.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from recurrent_flows_tpu_torch.config import rfn_mnist_production
    from recurrent_flows_tpu_torch.data import MovingMNIST
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.ops._build import build_all
    from recurrent_flows_tpu_torch.training import Trainer

    card = chip_smoke.card_info()
    print(f"card: {card}", flush=True)
    build_all()
    mcfg, tcfg = rfn_mnist_production()
    mcfg = chip_smoke.with_glow(mcfg, chain_impl="sample")
    data = MovingMNIST(digit_bank="synthetic", digit_size=32, num_digits=2,
                       seq_len=tcfg.n_frames)
    out = dict(card=card, runs=[])
    for seed in args.seeds:
        t0 = time.perf_counter()
        run_tcfg = dataclasses.replace(tcfg, steps_per_epoch=chip_smoke.FIT_STEPS, seed=seed)
        model = RFN(mcfg, device="cuda", generator=torch.Generator().manual_seed(seed))
        chip_smoke.perturb_(model, seed=seed + 1)
        trainer = Trainer(model, run_tcfg, data)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        xm = trainer._to_model_space(data.sample(gen, chip_smoke.BATCH))
        magnitude = {"random": chip_smoke.sample_max(model, xm)}
        trainer.build()
        magnitude["after_init"] = chip_smoke.sample_max(model, xm)
        for _ in range(chip_smoke.FIT_EPOCHS):
            trainer.train_epoch()
        magnitude["after_fit"] = chip_smoke.sample_max(model, xm)
        errs = chip_smoke.lifecycle_card_vs_cpu(model, np.random.default_rng(0))
        for v in errs.values():
            v["norm_rel_err"] = v["max_abs_err"] / (1.0 + v["max_abs_ref"])
        out["runs"].append(dict(seed=seed, sample_max_abs=magnitude, card_vs_cpu=errs,
                                seconds=time.perf_counter() - t0))
        print(f"seed {seed}: largest |x| of a sample "
              + ", ".join(f"{k} {v:.1f}" for k, v in magnitude.items()), flush=True)
        for k, v in errs.items():
            print(f"  {k}: max |err| {v['max_abs_err']:.3e}, elementwise "
                  f"{v['rel_err']:.3e} of 1+|ref|, {v['norm_rel_err']:.3e} of "
                  f"1+max|ref|, max |ref| {v['max_abs_ref']:.1f}", flush=True)
        del trainer, model
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "lifecycle_card_vs_cpu.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""How well-conditioned the train step's gradients are in float32, for the
flow variants the port runs.

    python3 scripts/torch_conditioning.py           # CPU, a reduced width
    python3 scripts/torch_conditioning.py --card    # the card, full width

Without arguments (on the CPU, the kernels' plain versions): the
batch-norm variant of ``rfn_kth`` (``flow_norm`` and ``base_norm``
'batchnorm', ``lu_decomposed=False``, ``track_running_stats``) at reduced
widths (h=32, z=8, K=4, U=32, narrow feature nets; 64x64, L=4), one loss
and backward in float32 and in float64 on the same weights and noise, at
B = 2, 4 and 8: the largest and the median error of the float32 gradients
against the float64 ones, each relative to the tensor's largest entry.

With ``--card``: ``rfn_bair`` and the same batch-norm variant at full
width, B=2, 3 frames, as ``chip_smoke.train_card_vs_cpu`` builds them: the
gradients on the card through the kernels and through their plain
versions, each against the CPU, for the parameters that differ most.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from recurrent_flows_tpu_torch.config import rfn_bair, rfn_kth  # noqa: E402
from recurrent_flows_tpu_torch.flows import modules as flow_modules  # noqa: E402
from recurrent_flows_tpu_torch.models import RFN  # noqa: E402
from recurrent_flows_tpu_torch.nn import convlstm  # noqa: E402
from recurrent_flows_tpu_torch.ops import fused  # noqa: E402
from recurrent_flows_tpu_torch.training import Trainer  # noqa: E402
from recurrent_flows_tpu_torch.utils import NoiseSource, float32_precision  # noqa: E402

PLAIN = dict(actnorm_invconv=fused.actnorm_invconv_ref,
             coupling_transform=fused.coupling_transform_ref)


def use_plain_versions(on: bool):
    """Route the module path's kernel wrappers to their plain versions (which
    also take float64), or back."""
    for name, ref in PLAIN.items():
        setattr(flow_modules, name, ref if on else getattr(fused, name))
    convlstm.convlstm_gates = fused.convlstm_gates_ref if on else fused.convlstm_gates


def batchnorm_variant(mcfg):
    return dataclasses.replace(
        cs.with_glow(mcfg, flow_norm="batchnorm", base_norm="batchnorm", lu_decomposed=False),
        track_running_stats=True)


def grads(model, x, noise):
    model.zero_grad(set_to_none=True)
    with float32_precision():
        out = model.loss(x.to(next(model.parameters()).device), noise)
        (out["nll"] + 0.5 * out["kl_free_bits"]).backward()
    return {n: p.grad.double().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def rel(a, b):
    """max |a - b| over the largest entry of b (the reference)."""
    return (a - b).abs().max().item() / (b.abs().max().item() + 1e-30)


def cpu_precision():
    use_plain_versions(True)
    mcfg, tcfg = rfn_kth()
    mcfg = batchnorm_variant(dataclasses.replace(
        mcfg, h_dim=32, z_dim=8, K=4,
        extractor_structure=((8, "pool", 16), (16, "pool", 32), (32, "pool", 32),
                             (32, "pool", 32)),
        upscaler_structure=((32, 16), ("upsample", 16, 16), ("upsample", 16, 16),
                            ("upsample", 8, 8)),
        prior_structure=(32, 16), encoder_structure=(32, 16),
        glow=dataclasses.replace(mcfg.glow, K=4, n_units_affine=32, n_units_prior=32)))
    for b in (2, 4, 8):
        batch = cs.moving_squares(np.random.default_rng(0), b, 3, 64)
        model = RFN(mcfg, device="cpu", generator=torch.Generator().manual_seed(0))
        cs.perturb_(model, 1)
        Trainer(model, tcfg, [batch], device="cpu").build(
            noise=NoiseSource(generator=torch.Generator().manual_seed(9)))
        model.remat = False
        rec = cs.RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(5)))
        x = torch.tensor(batch) - 0.5
        g32 = grads(model, x, rec)
        g64 = grads(model.double(), x.double(),
                    NoiseSource(replay=[d.double() for d in rec.draws]))
        # a conv bias in front of a batch norm has a zero gradient by
        # construction: float noise on both sides, left out
        errs = sorted((rel(g32[n], g64[n]), n) for n in g64
                      if g64[n].abs().max() > 1e-6 * max(g.abs().max() for g in g64.values()))
        print(f"B={b}: float32 against float64 gradients, of the largest entry: median "
              f"{statistics.median(e for e, _ in errs):.2e}, largest {errs[-1][0]:.2e} "
              f"({errs[-1][1]})")


def card_against_cpu():
    for label, (mcfg, tcfg) in (("rfn_bair", rfn_bair()),
                                ("rfn_kth batch-norm variant", rfn_kth())):
        if label != "rfn_bair":
            mcfg = batchnorm_variant(mcfg)
        batch = cs.moving_squares(np.random.default_rng(0), 2, 3, mcfg.image_size,
                                  mcfg.x_channels)
        gpu = RFN(mcfg, device="cuda", generator=torch.Generator().manual_seed(0))
        cs.perturb_(gpu, seed=1)
        Trainer(gpu, tcfg, [batch]).build()
        gpu.remat = False
        cpu = copy.deepcopy(gpu).cpu()
        x = torch.tensor(batch) - 0.5
        rec = cs.RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(5)))
        g_cpu = grads(cpu, x, rec)
        g_kernels = grads(gpu, x, NoiseSource(replay=rec.draws))
        use_plain_versions(True)
        g_plain = grads(gpu, x, NoiseSource(replay=rec.draws))
        use_plain_versions(False)
        worst = sorted(g_cpu, key=lambda n: -rel(g_kernels[n], g_cpu[n]))[:10]
        for n in worst + ["flow.scale3_step0.affine.net0.conv.kernel"]:
            print(f"{label} {n}: of the largest entry, kernels against CPU "
                  f"{rel(g_kernels[n], g_cpu[n]):.2e}, plain versions against CPU "
                  f"{rel(g_plain[n], g_cpu[n]):.2e}, kernels against plain "
                  f"{rel(g_kernels[n], g_plain[n]):.2e}")
        del gpu, cpu
        torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--card", action="store_true", help="full width, card against CPU")
    if p.parse_args().card:
        if not torch.cuda.is_available():
            raise SystemExit("--card needs an NVIDIA GPU")
        print(cs.card_info())
        card_against_cpu()
    else:
        cpu_precision()


if __name__ == "__main__":
    main()

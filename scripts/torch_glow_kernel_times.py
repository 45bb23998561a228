#!/usr/bin/env python3
"""Device times of the port's two GlowStep kernels on one NVIDIA GPU, by
launch plan and by phase.

    python3 scripts/torch_glow_kernel_times.py            # the default plans
    python3 scripts/torch_glow_kernel_times.py --sweep    # batch tile x cluster size
    python3 scripts/torch_glow_kernel_times.py --profile  # clocks per phase

Times ``glowchain`` (reverse at B=8, forward at B=30, K=10) and ``glowstep``
(forward at B=30) at the four shapes that ``rfn_mnist_production`` gives
them (U=256), on random weights, by CUDA-graph replay
(``chip_smoke.cuda_ms``). ``--sweep`` fixes the batch tile, the blocks
per cluster and the route of the first hidden map (shared memory or L2), then the depth of
the weight ring, then the register tiles per thread, of ``ops.glowstep.launch_plan`` in turn. ``--profile`` builds
the kernels with ``-DGLOW_PROFILE`` and prints, for one launch of each
case, the share of block 0's clocks spent in each phase of
``csrc/glowstep_body.cuh`` and, inside the phases, at the weight stream. Prints the card's name and power limit first;
writes ``chiprun_out/glow_kernel_times_<mode>.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from recurrent_flows_tpu_torch.ops import (GlowStepParams, _build, glowchain,  # noqa: E402
                                           glowstep)

# the module, not the function of the same name that the package exports
glowstep_module = importlib.import_module("recurrent_flows_tpu_torch.ops.glowstep")

SCALES = ((16, 8, 32), (8, 16, 64), (4, 32, 128), (2, 64, 256))  # hw, C, Cc
U, K = 256, 10
PHASES = ("set-up, load, store", "before the net", "first conv", "barrier 1",
          "gather + 1x1", "last conv", "barrier 2", "sum, clamp, affine, after")
# inside the phases, over all chunks of the weight stream
IN_CHUNKS = ("waiting for copies", "block barrier", "starting copies")
DEFAULT_PLAN = glowstep_module.launch_plan


def make_inputs(gen, b, hw, c, cc, k):
    def n(*shape, scale=0.1):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    ps = GlowStepParams(
        an_bias=n(k, c), an_logs=n(k, c),
        w1x1=torch.eye(c, device="cuda").repeat(k, 1, 1) + n(k, c, c),
        wa=n(k, 9, c // 2 + cc, U, scale=0.02), ana_bias=n(k, U), ana_logs=n(k, U),
        wb=n(k, U, U, scale=0.05), anb_bias=n(k, U), anb_logs=n(k, U),
        wc=n(k, 9, U, c, scale=0.01), bias_c=n(k, c),
        clamp_scale=1 + n(k, c // 2), clamp_shift=n(k, c // 2))
    return n(b, hw, hw, c, scale=1.0), n(b, hw, hw, cc, scale=1.0), ps


def cases(gen):
    """(name, scale index, shape, callable) of every timed launch."""
    for l, (hw, c, cc) in enumerate(SCALES, start=1):
        x8, cond8, ps = make_inputs(gen, 8, hw, c, cc, K)
        x30, cond30, _ = make_inputs(gen, 30, hw, c, cc, 1)
        p1 = GlowStepParams(*(t[0].contiguous() for t in ps))
        yield ("glowchain reverse B=8", l, (8, hw, hw, c, cc, U),
               functools.partial(glowchain, x8, cond8, ps, "realnvp", True))
        yield ("glowchain forward B=30", l, (30, hw, hw, c, cc, U),
               functools.partial(glowchain, x30, cond30, ps, "realnvp", False))
        yield ("glowstep forward B=30", l, (30, hw, hw, c, cc, U),
               functools.partial(glowstep, x30, cond30, p1, "realnvp", False))


def set_plan(**fixed):
    glowstep_module.launch_plan = functools.partial(DEFAULT_PLAN, **fixed)
    glowstep_module._plan_ints.cache_clear()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = chip_smoke.card_info()
    print(f"card: {card}")
    if args.profile:
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DGLOW_PROFILE")
    print("build:", {k: round(s, 1) for k, (_, s) in
                     _build.build_all(("glowstep", "glowchain")).items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, l, shape, fn in cases(gen):
        b, hw = shape[0], shape[1]
        plans = [dict()]
        if args.sweep:
            plans += [dict(batch_tile=bt, cluster_blocks=nb, ha_global=via_l2)
                      for bt in (1, 2, 4) if bt <= b and bt * hw * hw <= 256
                      for nb in (8, 16) for via_l2 in (False, True)]
            plans += [dict(stages=n) for n in (2, 3, 4)]
            plans += [dict(im=im) for im in (1, 2)]
        for fixed in plans:
            set_plan(**fixed)
            try:
                plan = glowstep_module.launch_plan(*shape)
            except ValueError as e:
                print(f"{name} scale {l} {fixed}: no plan ({e})")
                continue
            row = dict(case=name, scale=l, fixed=fixed, plan=plan._asdict())
            if args.profile:
                lib = glowstep_module.load_library(name.split()[0], 9 if "chain" in name else 8)
                out = (ctypes.c_longlong * (len(PHASES) + len(IN_CHUNKS)))()
                read = getattr(lib, name.split()[0] + "_read_profile")
                read.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
                fn()
                torch.cuda.synchronize()
                read(out)  # drop the first launch's clocks
                fn()
                torch.cuda.synchronize()
                if read(out):
                    raise RuntimeError("reading the phase clocks failed")
                total = sum(out[:len(PHASES)])
                row["clocks"] = dict(zip(PHASES + IN_CHUNKS, out))
                print(f"{name} scale {l}: {total} clocks of block 0: " + ", ".join(
                    f"{p} {v / total:.1%}" for p, v in zip(PHASES, out))
                    + "; of these in the weight stream: " + ", ".join(
                    f"{p} {v / total:.1%}" for p, v in zip(IN_CHUNKS, out[len(PHASES):])))
            else:
                try:
                    row["ms"] = chip_smoke.cuda_ms(fn, iters=10)
                except RuntimeError as e:
                    print(f"{name} scale {l} {fixed}: launch failed ({e})")
                    continue
                print(f"{name} scale {l} {fixed or 'default'}: {row['ms']:.4f} ms "
                      f"(tile {plan.batch_tile}, {plan.clusters} clusters of "
                      f"{plan.cluster_blocks}, IM {plan.im}, {plan.stages} stages of "
                      f"{plan.stage_floats * 4} B, {plan.smem_bytes} B)", flush=True)
            rows.append(row)
    set_plan()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    kind = "profile" if args.profile else "sweep" if args.sweep else "default"
    (out_dir / f"glow_kernel_times_{kind}.json").write_text(
        json.dumps(dict(card=card, rows=rows), indent=1))
    print(card)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Device times of the folded actnorm + 1x1 kernel's tile design on one
NVIDIA GPU, at the plan ``ops.ainv_plan`` picks and at every other tile it
could take, beside the compile-time instance (vec 1) at 24, 48 and 96 and
``F.linear``: the measurement the plan's model of a block's time was checked
against.

    python3 scripts/torch_ainv_tiles.py [--ptxas] [--quick]

Builds the package's kernels. At each shape of
``SHAPES`` (x [rows, C] of the RGB and wide scales the programs launch) it
checks the kernel against its plain version within 1e-5·(1+|ref|) and bit for
bit on a repeat, then times (``chip_smoke.small_ms``, CUDA-graph replays,
TF32 off) the package's kernel, at 24, 48 and 96 also its compile-time
instance (``ops.fused.ainv_row_plan``), ``F.linear`` on the folded weights,
the plain version and an in-place add over x; then every tile (rows, 4-wide
output vectors, lanes) of one stage that the kernel takes, each checked
before it is timed. ``--ptxas`` first prints nvcc's register and spill
report of ``csrc/actnorm_invconv.cu``; ``--quick`` skips the sweep. Prints
the card's name and power limit first and last; writes
``chiprun_out/ainv_tiles.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from recurrent_flows_tpu_torch import ops  # noqa: E402
from recurrent_flows_tpu_torch.ops import _build, fused  # noqa: E402
from recurrent_flows_tpu_torch.utils import float32_precision  # noqa: E402

# x [rows, C]: rfn_bair's and the BAIR CLI step's scales (B=32), the request's
# (B=8) and twice its rows, the wide widths at [512, C], the CLI's 2x2x192 (B=32)
SHAPES = [(32768, 12), (8192, 24), (2048, 48), (512, 96), (2048, 24), (512, 48), (128, 96),
          (4096, 24), (1024, 48), (256, 96), (512, 128), (512, 192), (512, 256), (128, 192)]


def tiles(rows: int, c: int):
    """Every one-stage tile plan of x [rows, c] the kernel takes, each lane
    with at least 4 channels."""
    n_vec = -(-c // 4)
    for tm in range(4, fused.AINV_TILE_ROWS + 1, 4):
        for groups in range(1, min(n_vec, fused.AINV_TILE_COLS // 4) + 1):
            lanes = 1
            while 4 * lanes <= c:
                threads = lanes * tm // 4 * groups
                k_stage = -(-c // (4 * lanes)) * 4 * lanes
                smem = fused.ainv_tile_smem(tm, 4 * groups, lanes, k_stage, c)
                if threads <= fused.AINV_MAX_THREADS and smem <= fused.AINV_MAX_SMEM:
                    blocks = -(-rows // tm) * -(-n_vec // groups)
                    yield fused.AinvPlan(2, lanes, groups, tm, threads, blocks, k_stage)
                lanes *= 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = chip_smoke.card_info()
    print(f"card: {card}", flush=True)
    if args.ptxas:
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              "/dev/null", str(_build.CSRC / "actnorm_invconv.cu")],
                             capture_output=True, text=True)
        print(out.stderr, flush=True)
    print("build:", {k: round(s, 1) for k, (_, s) in _build.build_all().items()}, flush=True)
    launch = fused.ainv_launch_plan
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s, scale=1.0: scale * torch.randn(s, generator=gen, device="cuda")
    import torch.nn.functional as F

    results = dict(card=card, floor_ms=chip_smoke.launch_floor_ms(), shapes=[])
    with float32_precision():
        for rows, c in SHAPES:
            x, bias, logs = rnd(rows, c), rnd(c, scale=0.3), rnd(c, scale=0.3)
            w = torch.linalg.qr(rnd(c, c))[0].contiguous()
            ref = ops.actnorm_invconv_ref(x, bias, logs, w)
            y = ops.actnorm_invconv(x, bias, logs, w)
            e = chip_smoke.check_elementwise(f"actnorm_invconv [{rows}, {c}]", (y,), (ref,),
                                             (chip_smoke.TOL_INVCONV,))
            chip_smoke.check_repeats(f"actnorm_invconv [{rows}, {c}]",
                                     lambda: (ops.actnorm_invconv(x, bias, logs, w),))
            wf, sh = chip_smoke.folded_linear(bias, logs, w)
            add = torch.zeros_like(x)
            plan = ops.ainv_plan(rows, c)
            row = dict(shape=[rows, c], plan=plan._asdict(), err=e,
                       ms=chip_smoke.small_ms(lambda: ops.actnorm_invconv(x, bias, logs, w)),
                       library_ms=chip_smoke.small_ms(lambda: F.linear(x, wf, sh)),
                       plain_ms=chip_smoke.cuda_ms(
                           lambda: ops.actnorm_invconv_ref(x, bias, logs, w)),
                       add_ms=chip_smoke.small_ms(lambda: add.add_(1.0)),
                       **chip_smoke.bound(chip_smoke.nbytes(x, bias, logs, w, x),
                                          2 * x.numel() * c + 2 * x.numel()))
            also = ""
            if c in (24, 48, 96):  # the other design of these widths
                other = (fused.ainv_row_plan(rows, c, 1) if plan.vec == 2
                         else fused._tile_plan(rows, c))
                row["other_plan"] = other._asdict()
                row["other_err"] = chip_smoke.rel_err(launch(other, x, bias, logs, w), ref)[1]
                row["other_ms"] = chip_smoke.small_ms(lambda: launch(other, x, bias, logs, w))
                also = f" (vec {other.vec}: {row['other_ms']:.5f})"
            print(f"[{rows}, {c}] plan {tuple(plan)}: {row['ms']:.5f} ms{also}, "
                  f"F.linear {row['library_ms']:.5f}, plain {row['plain_ms']:.5f}, add "
                  f"{row['add_ms']:.5f}, bound "
                  f"{row['bound_ms']:.6f} ({row['bound_by']}); err {e:.2e}", flush=True)
            sweep = []
            if not args.quick:
                for p in tiles(rows, c):
                    got = launch(p, x, bias, logs, w)
                    err = chip_smoke.rel_err(got, ref)[1]
                    if err > chip_smoke.TOL_INVCONV:
                        raise AssertionError(f"[{rows}, {c}] plan {p}: rel err {err:.3e}")
                    sweep.append(dict(plan=p._asdict(), err=err, ms=chip_smoke.small_ms(
                        lambda: launch(p, x, bias, logs, w))))
                sweep.sort(key=lambda s: s["ms"])
                for s in sweep[:6]:
                    print(f"    {s['ms']:.5f} ms  " + " ".join(
                        f"{k}={s['plan'][k]}" for k in ("rows_per_block", "groups", "lanes",
                                                        "threads", "blocks")), flush=True)
                ranked = [s["plan"] for s in sweep]
                rank = ranked.index(plan._asdict()) + 1 if plan._asdict() in ranked else "-"
                print(f"    {len(sweep)} tiles; the plan's rank {rank}", flush=True)
            row["sweep"] = sweep
            results["shapes"].append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ainv_tiles.json").write_text(json.dumps(results, indent=1))
    print(card)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Device times of the three small kernels, ``coupling_transform``,
``actnorm_invconv`` and ``convlstm_gates``, of the port in a checkout,
beside the launch floor: for a side-by-side run of two checkouts on one
NVIDIA GPU, in one call.

    python3 scripts/torch_flow_kernel_times.py [--root DIR] [--out NAME]

Times the package under DIR (default: this checkout) with the helpers of
this checkout's ``chip_smoke.py`` phase 3, at its shapes: the launch floor
(``launch_floor_ms``); ``coupling_transform`` at the serving request's
shape and the five of the train step (``coupling_cases``, ``coupling_times``),
on the 'split'/'cross' views AffineCoupling passes and on contiguous copies
(a package whose wrapper takes only contiguous tensors, as before the
kernel read views, gets copies made in the timed call, as its
AffineCoupling made them); ``actnorm_invconv`` at the train step's five
scales beside ``F.linear`` (``ainv_times``), on random weights;
``convlstm_gates`` at the serving request's gates [8,2,2,800] and the train
step's [30,2,2,800] (``gates_times``: device ms, an in-place add over c,
host µs per eager call). Prints the card's name and power limit first;
writes ``chiprun_out/flow_kernel_times_<NAME>.json``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--out", default="this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path.insert(0, str(args.root.resolve()))
    ops = importlib.import_module("recurrent_flows_tpu_torch.ops")
    from recurrent_flows_tpu_torch.ops import _build

    card = chip_smoke.card_info()
    print(f"card: {card}")
    print(f"package: {Path(ops.__file__).parents[1]}")
    print("build:", {k: round(s, 1) for k, (_, s) in _build.build_all().items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s, scale=1.0: scale * torch.randn(s, generator=gen, device="cuda")
    floor = chip_smoke.launch_floor_ms()
    print(f"launch floor (in-place add on one element): {floor:.5f} ms", flush=True)
    rows = [dict(case="launch floor", ms=floor)]

    def report(case, times):
        rows.append(dict(case=case, **times))
        print(f"{case}: {times['ms']:.5f} ms ({times['ms'] / floor:.2f} floors)"
              + "".join(f", {k} {v:.5f}" for k, v in times.items() if k != "ms"), flush=True)

    coupling = ops.coupling_transform
    if not hasattr(ops, "nhwc_view"):  # a wrapper that takes contiguous tensors only
        coupling = lambda z2, shift, s, rev: ops.coupling_transform(
            z2.contiguous(), shift.contiguous(), s, rev)
    for shape, rev, views in chip_smoke.coupling_cases(rnd, chip_smoke.COUPLING_TIMED):
        report(f"coupling {'reverse' if rev else 'forward'} z2 {shape}",
               chip_smoke.coupling_times(coupling, *views, rev))
    for l, (hw, c) in enumerate(chip_smoke.FLOW_SCALES):
        x = rnd(chip_smoke.TRAIN_BATCH * hw * hw, c)
        bias, logs = rnd(c, scale=0.3), rnd(c, scale=0.3)
        w = torch.linalg.qr(rnd(c, c))[0].contiguous()
        report(f"actnorm_invconv scale {l} x {list(x.shape)}",
               chip_smoke.ainv_times(ops.actnorm_invconv, x, bias, logs, w))
    hc = 200  # h_dim of rfn_mnist_production
    for b in (chip_smoke.BATCH, chip_smoke.TRAIN_BATCH):
        gates, c = rnd(b, 2, 2, 4 * hc), rnd(b, 2, 2, hc)
        peeps = [rnd(1, 2, 2, hc, scale=0.1) for _ in range(3)]
        report(f"convlstm_gates gates {list(gates.shape)}",
               chip_smoke.gates_times(ops.convlstm_gates, gates, c, peeps))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"flow_kernel_times_{args.out}.json").write_text(
        json.dumps(dict(card=card, package=str(args.root), rows=rows), indent=1))
    print(card)


if __name__ == "__main__":
    main()

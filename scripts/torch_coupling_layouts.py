#!/usr/bin/env python3
"""The flow's coupling net in both layouts on the card, with the cuDNN
kernels each picks: channel-major (``AffineCoupling``'s net off a grid)
and NHWC (the same modules on channels-last maps, as on a grid).

    python3 scripts/torch_coupling_layouts.py [--batch 720] [--reps 5]

At rfn_mnist_production's shapes (U=256) and ``--batch`` (the train
cell's by default), TF32 off as the program runs:

- ``net``: scale 1's whole net (x [B, 32, 32, 4], 16 condition channels),
  forward + backward, per layout in turns (channel-major, NHWC, NHWC,
  channel-major): device ms by CUDA events (mean over ``--reps``), then
  one call profiled: device ms by kernel, and the part that is cuDNN's
  layout transposes (``utils.profiling.TRANSPOSE_KERNELS``);
- ``convs``: at each of the five scales, each conv of the net (net0 3x3,
  net1 1x1, net2 3x3) alone, fprop, dgrad and wgrad, on NCHW and on
  channels-last memory: CUDA-event ms and the kernels it ran.

Prints a summary and writes ``chiprun_out/coupling_layouts.json``. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from recurrent_flows_tpu_torch.flows.modules import AffineCoupling, to_channel_major  # noqa: E402
from recurrent_flows_tpu_torch.nn.layers import act  # noqa: E402
from recurrent_flows_tpu_torch.utils import float32_precision  # noqa: E402
from recurrent_flows_tpu_torch.utils.profiling import TRANSPOSE_KERNELS  # noqa: E402

# (H = W, C, condition channels) of rfn_mnist_production's five scales
SCALES = [(32, 4, 16), (16, 8, 32), (8, 16, 64), (4, 32, 128), (2, 64, 256)]
UNITS = 256


def kernel_ms(fn) -> dict:
    """{kernel name: device ms} of one call of ``fn``, profiled."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation():
            out[ev.name()] = out.get(ev.name(), 0.0) + (ev.end_ns() - ev.start_ns()) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def event_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def whole_net(b: int, reps: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    hw, c, cc = SCALES[0]
    m = AffineCoupling(c, cc, UNITS, device="cuda", generator=gen)
    with torch.no_grad():  # net2 and the clamp start at zero
        for p in m.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen, device="cuda"))
    z1 = torch.randn(b, hw, hw, c // 2, generator=gen, device="cuda", requires_grad=True)
    cond = torch.randn(b, hw, hw, cc, generator=gen, device="cuda")
    cond_cm = to_channel_major(cond)

    def nhwc():  # the NCHW views of channels-last memory, as on a grid
        h = act(m.net0(torch.cat([z1, cond], -1)), m.non_lin)
        return m.net2(act(m.net1(h), m.non_lin))

    nets = {"channel_major": lambda: m._net(z1, cond, False, cond_cm), "nhwc": nhwc}
    steps = {name: (lambda net=net: net().square().sum().backward())
             for name, net in nets.items()}
    out = {name: dict(event_ms=[]) for name in nets}
    for name in ("channel_major", "nhwc", "nhwc", "channel_major"):
        out[name]["event_ms"].append(event_ms(steps[name], reps))
    for name, step in steps.items():
        ms = kernel_ms(step)
        out[name].update(device_ms=sum(ms.values()),
                         transpose_ms=sum(v for k, v in ms.items()
                                          if any(t in k for t in TRANSPOSE_KERNELS)),
                         kernels=ms)
    return out


def convs(b: int, reps: int) -> list:
    rows = []
    for hw, c, cc in SCALES:
        for conv, cin, cout, k in (("net0", c // 2 + cc, UNITS, 3), ("net1", UNITS, UNITS, 1),
                                   ("net2", UNITS, c, 3)):
            p = (k - 1) // 2
            w = 0.05 * torch.randn(cout, cin, k, k, device="cuda")
            x0 = torch.randn(b, cin, hw, hw, device="cuda")
            gy0 = torch.randn(b, cout, hw, hw, device="cuda")
            for layout, fmt in (("nchw", torch.contiguous_format),
                                ("nhwc", torch.channels_last)):
                x, gy = x0.contiguous(memory_format=fmt), gy0.contiguous(memory_format=fmt)

                def grad(mask, x=x, gy=gy, w=w, p=p, cout=cout):
                    return torch.ops.aten.convolution_backward(
                        gy, x, w, [cout], [1, 1], [p, p], [1, 1], False, [0, 0], 1, mask)

                ops = {"fprop": lambda x=x, w=w, p=p: F.conv2d(x, w, None, 1, p),
                       "dgrad": lambda grad=grad: grad([True, False, False]),
                       "wgrad": lambda grad=grad: grad([False, True, False])}
                for op, fn in ops.items():
                    rows.append(dict(hw=hw, conv=conv, layout=layout, op=op,
                                     ms=event_ms(fn, reps), kernels=kernel_ms(fn)))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=720)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    with float32_precision():
        result = dict(card=torch.cuda.get_device_name(0), torch=torch.__version__,
                      batch=args.batch, net=whole_net(args.batch, args.reps),
                      convs=convs(args.batch, args.reps))
    for name, row in result["net"].items():
        print(f"net {name}: {row['event_ms']} ms, transposes {row['transpose_ms']:.3f} ms")
    for r in result["convs"]:
        top = next(iter(r["kernels"]), "")[:60]
        print(f"{r['hw']:>2} {r['conv']} {r['layout']} {r['op']}: {r['ms']:.4f} ms ({top})")
    dest = ROOT / "chiprun_out" / "coupling_layouts.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()

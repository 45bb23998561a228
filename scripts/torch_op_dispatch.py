#!/usr/bin/env python3
"""Host µs per call of four ways to bind a function to PyTorch, on a device:
the plain Python function, a ``torch.autograd.Function`` (how the port
bound its kernels before they became operators), ``torch.library.custom_op``
and ``torch.library.Library(..., "DEF")`` with ``impl`` (how ``ops.library``
binds them), both with an autograd formula registered. The function only
allocates its two outputs (``torch.empty``), so the times are the binding's
own cost, under ``no_grad`` as the serving rollout calls the kernels.

    python3 scripts/torch_op_dispatch.py [--device cuda|cpu] [--calls N]

Prints one JSON line (the medians of 5 rounds of N calls each, and the
card's name and power limit on a card).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch


def body(x, y):
    return torch.empty_like(x), torch.empty(x.shape[:1], device=x.device)


class Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, flag):
        return body(x, y)

    @staticmethod
    def backward(ctx, gx, gl):
        return gx, gx, None


@torch.library.custom_op("rft_dispatch::custom", mutates_args=())
def custom(x: torch.Tensor, y: torch.Tensor, flag: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return body(x, y)


custom.register_fake(lambda x, y, flag: body(x, y))
_LIB = torch.library.Library("rft_dispatch", "DEF")
_LIB.define("low(Tensor x, Tensor y, bool flag) -> (Tensor, Tensor)")
for key in ("CPU", "CUDA"):
    _LIB.impl("low", lambda x, y, flag: body(x, y), key)
torch.library.register_fake("rft_dispatch::low", lambda x, y, flag: body(x, y), lib=_LIB)


def _setup(ctx, inputs, output):
    ctx.flag = inputs[2]


def _backward(ctx, gx, gl):
    return gx, gx, None


custom.register_autograd(_backward, setup_context=_setup)
torch.library.register_autograd("rft_dispatch::low", _backward, setup_context=_setup, lib=_LIB)


def per_call_us(fn, x, y, calls: int) -> float:
    def sync():
        if x.is_cuda:
            torch.cuda.synchronize()

    rounds = []
    for _ in range(6):
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(x, y, False)
        sync()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(rounds[1:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    dev = torch.device(args.device)
    x, y = torch.zeros(8, 2, 2, 200, device=dev), torch.zeros(8, 2, 2, 200, device=dev)
    ways = {"python_function": lambda a, b, f: body(a, b), "autograd_function": Fn.apply,
            "custom_op": custom, "library_def": torch.ops.rft_dispatch.low.default}
    with torch.no_grad():
        us = {name: per_call_us(fn, x, y, args.calls) for name, fn in ways.items()}
    card = None
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    print(json.dumps(dict(device=str(dev), card=card, torch=torch.__version__,
                          calls=args.calls, host_us_per_call=us)))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (``Predictor.predict`` -> ``RFN.predict``)
at the full width of ``rfn_mnist_production`` with ``chain_impl='sample'``
on random weights made from a seed, and checks it phase by phase:

1. the card: CUDA must be available (there is no CPU path);
2. the build of the CUDA library (nvcc, from the sources in the checkout);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (TF32 off), with both device times;
4. the slice: warm-up plus 3 requests of 8 sequences through
   ``Predictor``, with the launch count of every kernel per request,
   then one more request under ``torch.profiler`` (device busy time,
   idle share, device time by kind of kernel);
5. the slice on the card against the slice on the CPU, same weights and
   the same injected noise.

Any failure raises and the script exits non-zero. The last two lines of
standard output are the kernels' JSON record and the device record; the
full record is written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

# tolerances (float32 everywhere, TF32 off): the kernels sum in another
# order than cuBLAS/cuDNN and use the hardware exp, so they agree with
# their plain versions to a few float32 ulps per operation. Each kernel
# check holds every element to |err| <= tol·(1+|ref|).
TOL_ELEMENTWISE = 1e-5  # coupling / gates outputs
TOL_COUPLING_LD = 1e-4  # logdet: a sum of 2048 terms
TOL_CHAIN = 1e-4  # 10 chained steps of 3 convs each
TOL_CHAIN_LD = 1e-4  # summed coupling logdets of 10 steps
# card vs CPU rollout, max |err| absolute: the first predicted frame passes
# 50 flow steps once; later frames feed that frame back through the
# extractor and the LSTM
TOL_FIRST_FRAME = 1e-3
TOL_LATER_FRAMES = 1e-2

BATCH, N_COND, N_PRED, N_REQUESTS = 8, 5, 10, 3
ROOT = Path(__file__).resolve().parent


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn`` in ms: ``iters`` calls are
    captured into a CUDA graph, which is replayed between two CUDA events,
    so the host's cost of launching from Python is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got-ref|, max over elements of |got-ref| / (1+|ref|))."""
    err = (got - ref).abs()
    return err.max().item(), (err / (1.0 + ref.abs())).max().item()


# device kernels by name: the port's own, then cuDNN convolutions with
# their layout transposes, then cuBLAS products and triangular solves
KERNEL_KINDS = (("glowchain", ("glowchain",)),
                ("coupling_transform", ("_coupling_kernel",)),
                ("convlstm_gates", ("_gates_kernel",)),
                ("conv", ("conv", "fprop", "cudnn", "winograd", "nchw", "nhwc")),
                ("gemm", ("gemm", "gemv", "trsm")))


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile_request(pred, ctx, median_ms: float) -> dict:
    """One more request under ``torch.profiler``: device busy time (the
    union of the device kernels' intervals), the device's idle share of
    the profiled call and of the unprofiled median request, and device
    time by kind of kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(ctx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiled request ran no device kernel")
    busy_us, end = 0.0, float("-inf")
    by_kind, by_name = {}, {}
    for t_start, t_end, name in spans:
        busy_us += max(0.0, t_end - max(t_start, end))
        end = max(end, t_end)
        for table, key in ((by_kind, kernel_kind(name)), (by_name, name)):
            n, us = table.get(key, (0, 0.0))
            table[key] = (n + 1, us + t_end - t_start)
    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms, n_kernels=len(spans),
        idle_share_profiled=1.0 - busy_ms / wall_ms,
        idle_share_of_median=1.0 - busy_ms / median_ms,
        by_kind={k: dict(n=n, ms=us / 1e3) for k, (n, us) in by_kind.items()},
        top_kernels=[dict(name=k[:120], n=n, ms=us / 1e3) for k, (n, us) in top])


def perturb_(model: torch.nn.Module, seed: int, scale: float = 0.02):
    """Move every parameter off its init (zero-initialised Conv2dZeros and
    realnvp scales would make each coupling the identity and hide a wrong
    kernel)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape, generator=g).to(p.device))


class RecordedNoise:
    """A NoiseSource that keeps every draw, so it can be replayed."""

    def __init__(self, inner):
        self.inner, self.draws = inner, []

    def normal(self, like):
        eps = self.inner.normal(like)
        self.draws.append(eps.detach().cpu().clone())
        return eps


def moving_squares(rng, batch: int, t: int, size: int) -> np.ndarray:
    """Context sequences in [0,1]: a bright square moving in a straight
    line over a dim noisy background, one per sequence."""
    x = 0.1 * rng.random((batch, t, size, size, 1), dtype=np.float32)
    for b in range(batch):
        pos = rng.integers(0, size - 16, 2)
        vel = rng.integers(-3, 4, 2)
        for i in range(t):
            r, c = np.clip(pos + i * vel, 0, size - 16)
            x[b, i, r:r + 16, c:c + 16, 0] = 1.0
    return x


def check_kernels(model, record):
    """Phase 3: every kernel against its plain version at the slice's shapes."""
    from recurrent_flows_tpu_torch.flows.glow import prep_glowstep_params
    from recurrent_flows_tpu_torch.ops import (GlowStepParams, convlstm_gates,
                                               convlstm_gates_ref,
                                               coupling_transform,
                                               coupling_transform_ref,
                                               glowchain, glowchain_ref)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale
    kernels = {}

    # coupling tail: AffineCoupling reverse at scale 0, z2 [B,32,32,2]
    z2, shift, s = rnd(BATCH, 32, 32, 2), rnd(BATCH, 32, 32, 2), rnd(BATCH, 32, 32, 2, scale=0.5)
    worst = 0.0
    for reverse in (False, True):
        t0 = time.perf_counter()
        out, ld = coupling_transform(z2, shift, s, reverse)
        torch.cuda.synchronize()
        if reverse is False:
            print(f"coupling_transform first launch (Triton compile): "
                  f"{time.perf_counter() - t0:.2f} s")
        ref_out, ref_ld = coupling_transform_ref(z2, shift, s, reverse)
        e, r = rel_err(out, ref_out)
        el, rl = rel_err(ld, ref_ld)
        print(f"coupling_transform reverse={reverse}: out err {e:.3e}, "
              f"logdet err {el:.3e}")
        if r > TOL_ELEMENTWISE or rl > TOL_COUPLING_LD:
            raise AssertionError(f"coupling_transform disagrees (reverse={reverse})")
        worst = max(worst, e, el)
    kernels["coupling_transform"] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: coupling_transform(z2, shift, s, True)),
        plain_ms=cuda_ms(lambda: coupling_transform_ref(z2, shift, s, True)))

    # ConvLSTM gates: gates [B,2,2,800], c [B,2,2,200]
    hc = model.cfg.h_dim
    gates, c = rnd(BATCH, 2, 2, 4 * hc), rnd(BATCH, 2, 2, hc)
    peeps = [rnd(1, 2, 2, hc, scale=0.1) for _ in range(3)]
    got = convlstm_gates(gates, c, *peeps)
    torch.cuda.synchronize()
    ref = convlstm_gates_ref(gates, c, *peeps)
    worst = 0.0
    for a, b in zip(got, ref):
        e, r = rel_err(a, b)
        if r > TOL_ELEMENTWISE:
            raise AssertionError(f"convlstm_gates disagrees: {e:.3e}")
        worst = max(worst, e)
    print(f"convlstm_gates: err {worst:.3e}")
    kernels["convlstm_gates"] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: convlstm_gates(gates, c, *peeps)),
        plain_ms=cuda_ms(lambda: convlstm_gates_ref(gates, c, *peeps)))

    # glowchain: scales 1-4 of the flow, both directions, all clamps, on the
    # model's own (perturbed) weights
    flow = model.flow
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    with torch.no_grad():
        for l in range(1, flow.cfg.L):
            hw = flow.scale_hw[l]
            cc = flow.step(l, 0).affine.net0.conv.kernel.shape[1] - flow.step(l, 0).channels // 2
            c_l = flow.step(l, 0).channels
            x, cond = rnd(BATCH, hw, hw, c_l), rnd(BATCH, hw, hw, cc)
            for reverse in (False, True):
                order = reversed(range(flow.cfg.K)) if reverse else range(flow.cfg.K)
                preps = [prep_glowstep_params(flow.step(l, k), reverse)[0] for k in order]
                ps = GlowStepParams(*(torch.stack(v).contiguous() for v in zip(*preps)))
                # the model's own weights for realnvp (the slice's clamp); for
                # the other clamps the last conv is scaled down 10x, so that
                # the unclamped 'none' stays finite over 10 steps
                small = ps._replace(wc=0.1 * ps.wc, bias_c=0.1 * ps.bias_c)
                for clamp in ("realnvp", "glow", "softclamp", "none"):
                    p_c = ps if clamp == "realnvp" else small
                    y, ld = glowchain(x, cond, p_c, clamp, reverse)
                    torch.cuda.synchronize()
                    y_ref, ld_ref = glowchain_ref(x, cond, p_c, clamp, reverse)
                    if not (torch.isfinite(y_ref).all() and torch.isfinite(ld_ref).all()):
                        raise AssertionError(f"glowchain reference not finite at scale {l}, {clamp}")
                    e, r = rel_err(y, y_ref)
                    el, rl = rel_err(ld, ld_ref)
                    record["glowchain_checks"].append(dict(
                        scale=l, shape=[BATCH, hw, hw, c_l], cond=cc,
                        reverse=reverse, clamp=clamp, err=e, ld_err=el))
                    print(f"glowchain scale {l} x{[BATCH, hw, hw, c_l]} cond {cc} "
                          f"reverse={reverse} {clamp}: err {e:.3e} (rel {r:.1e}), "
                          f"logdet err {el:.3e}")
                    if not (r <= TOL_CHAIN and rl <= TOL_CHAIN_LD):
                        raise AssertionError(f"glowchain disagrees at scale {l}")
                    worst = max(worst, e, el)
                if reverse:
                    t_k = cuda_ms(lambda: glowchain(x, cond, ps, "realnvp", True), iters=10)
                    t_p = cuda_ms(lambda: glowchain_ref(x, cond, ps, "realnvp", True), iters=10)
                    record["glowchain_ms"].append(dict(scale=l, ms=t_k, plain_ms=t_p))
                    print(f"glowchain scale {l} reverse: {t_k:.3f} ms, plain {t_p:.3f} ms")
                    ms, plain_ms = ms + t_k, plain_ms + t_p
    kernels["glowchain"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)
    return kernels


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.config import rfn_mnist_production
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.ops._build import build
    from recurrent_flows_tpu_torch.serving import Predictor
    from recurrent_flows_tpu_torch.utils import NoiseSource, float32_precision

    t_start = time.perf_counter()
    card = card_info()
    print(f"card: {card}")
    record = dict(card=card, device=torch.cuda.get_device_name(0),
                  torch=torch.__version__, cuda=torch.version.cuda,
                  glowchain_checks=[], glowchain_ms=[])

    # phase 2: build
    _, secs = build("glowchain")
    print(f"build: glowchain.cu compiled in {secs:.1f} s")
    record["build_s"] = secs

    # the slice's model: production widths, chain_impl='sample', seeded
    mcfg, tcfg = rfn_mnist_production()
    mcfg = dataclasses.replace(
        mcfg, glow=dataclasses.replace(mcfg.glow, chain_impl="sample"))
    model = RFN(mcfg, device="cuda", generator=torch.Generator().manual_seed(0))
    perturb_(model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: rfn_mnist_production, chain_impl='sample', {n_params} parameters")

    # phase 3: kernels against their plain versions, the plain side in
    # full float32; phases 4-5 run with torch's defaults, as a user would
    with float32_precision():
        kernels = check_kernels(model, record)

    # phase 4: the slice through Predictor
    pred = Predictor(model, tcfg, n_conditions=N_COND, n_predictions=N_PRED,
                     seed=0, device="cuda")
    t0 = time.perf_counter()
    pred.warmup(batch_size=BATCH)
    torch.cuda.synchronize()
    print(f"warmup: {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    want = dict(convlstm_gates=N_COND - 1 + N_PRED,
                coupling_transform=mcfg.K * N_PRED,
                glowchain=(mcfg.L - 1) * N_PRED)
    request_ms = []
    ops.reset_launch_counts()
    for i in range(N_REQUESTS):
        ctx = moving_squares(rng, BATCH, N_COND, mcfg.image_size)
        before = ops.launch_counts()
        t0 = time.perf_counter()
        out = pred.predict(ctx)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
        if counts != want:
            raise AssertionError(f"request {i}: launches {counts}, expected {want}")
        if out.shape != (BATCH, N_PRED, mcfg.image_size, mcfg.image_size, 1):
            raise AssertionError(f"request {i}: output shape {out.shape}")
        if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
            raise AssertionError(f"request {i}: output not finite in [0, 1]")
        print(f"request {i}: {request_ms[-1]:.1f} ms, launches {counts}, "
              f"mean {out.mean():.4f}, std {out.std():.4f}")
    launches = ops.launch_counts()
    med = statistics.median(request_ms)
    print(f"predict: median {med:.1f} ms per request of {BATCH} sequences "
          f"({N_COND} context, {N_PRED} predicted frames) on {card}")
    record.update(request_ms=request_ms, median_request_ms=med,
                  launches_per_request=want)
    prof = profile_request(pred, ctx, med)
    record["profile"] = prof
    kinds = ", ".join(f"{k} {v['ms']:.1f} ms ({v['n']})" for k, v in
                      sorted(prof["by_kind"].items(), key=lambda kv: -kv[1]["ms"]))
    print(f"profiled request: device busy {prof['device_busy_ms']:.1f} ms "
          f"in {prof['n_kernels']} kernels, wall {prof['wall_ms']:.1f} ms "
          f"(idle share {prof['idle_share_profiled']:.2f}; "
          f"{prof['idle_share_of_median']:.2f} of the unprofiled median); "
          f"by kind: {kinds}")

    # phase 5: card against CPU, same weights and noise, B=2, 3 context, 2 predicted
    x = torch.tensor(moving_squares(rng, 2, 3, mcfg.image_size) - 0.5)
    cpu_model = copy.deepcopy(model).cpu()
    rec = RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(3)))
    _, p_cpu = cpu_model.predict(x, 2, 3, rec)
    _, p_gpu = model.predict(x.cuda(), 2, 3, NoiseSource(replay=rec.draws))
    p_gpu = p_gpu.cpu()
    errs = [(p_gpu[t] - p_cpu[t]).abs().max().item() for t in range(2)]
    print(f"card vs CPU: max |err| per predicted frame {errs}, "
          f"max |x| {p_cpu.abs().max().item():.3f}")
    record["card_vs_cpu_err"] = errs
    if not (torch.isfinite(p_gpu).all() and errs[0] <= TOL_FIRST_FRAME
            and errs[1] <= TOL_LATER_FRAMES):
        raise AssertionError(f"card and CPU rollouts disagree: {errs}")

    src = {"coupling_transform": ("triton", "recurrent_flows_tpu_torch/ops/fused.py",
                                  "recurrent_flows_tpu/ops/pallas/fused.py:75"),
           "convlstm_gates": ("triton", "recurrent_flows_tpu_torch/ops/fused.py",
                              "recurrent_flows_tpu/ops/pallas/fused.py:257"),
           "glowchain": ("cuda", "recurrent_flows_tpu_torch/csrc/glowchain.cu",
                         "recurrent_flows_tpu/ops/pallas/glowchain.py:84")}
    line = {"kernels": [
        dict(name=name, route=src[name][0], source=src[name][1],
             replaces=src[name][2], launches=launches[name], **kernels[name])
        for name in ("coupling_transform", "convlstm_gates", "glowchain")]}
    record.update(line, total_s=time.perf_counter() - t_start)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths at the full width of
``rfn_mnist_production`` on random weights made from a seed: the serving
rollout (``Predictor.predict`` -> ``RFN.predict``, ``chain_impl='sample'``)
and the training step (``Trainer.build`` -> ``Trainer.train_step`` ->
``RFN.loss`` -> ``ListGlow.log_prob``, forward and backward, with Adam) in
its three configurations: A the preset as it is, B ``coupling_impl='fused'``,
C ``chain_impl='all'``. Phase by phase:

1. the card: CUDA must be available (there is no CPU path);
2. the build of the CUDA libraries (one nvcc per source, started together);
3. each of the five kernels against its plain PyTorch version on the card,
   at the shapes the main paths give it (TF32 off), with the device times
   of the kernel, the plain version and, where one PyTorch call computes
   the same function, that call, beside the least time the card could
   take; for the two GlowStep kernels also the launch plan of every shape
   and a second launch that must repeat the first bit for bit; then each
   kernel's autograd Function against autograd through its plain version;
4. serving: warm-up plus 3 requests of 8 sequences through ``Predictor``,
   with the launch count of every kernel per request, then one more
   request under ``torch.profiler`` (device busy time, idle share, device
   time by kind of kernel);
5. the rollout on the card against the rollout on the CPU, same weights
   and the same injected noise;
6. training: ``Trainer.build`` (data-dependent init) and train steps of
   30 sequences of 10 frames, three of A (then one without recomputation,
   for the peak memory, and one under ``torch.profiler``) and one each of B
   and C, with exact launch counts, ms and peak memory per step;
7. one train step of A at a small batch on the card against the same step
   on the CPU, same weights and noise: the loss pieces and a few named
   gradients.

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
TOL_STEP = 1e-4  # one GlowStep: 3 convs, sums of up to 2,592 terms
TOL_INVCONV = 1e-5  # a C-term sum per output, C <= 64
# gradients through an autograd Function against autograd through the plain
# version: the same backward arithmetic from forward values that differ by
# the kernel's rounding
TOL_GRAD = 1e-4
# train step on the card against the CPU (B=2, 3 frames, full width): each
# loss piece within tol·(1+|ref|); each named gradient within tol of its
# largest entry. Parameters with a direct term in the objective (the
# coupling nets' and splits' convs through the log-determinant and the
# log-likelihood, the prior through the KL) agree to ~2e-5 of it. The
# others are reached only through the flow's main stream, 50 invertible
# steps backward: that gradient is ill-conditioned in float32, and the card
# and the CPU differ by up to ~1e-2 of the largest entry there, with the
# kernels or with their plain versions alike
TOL_STEP_LOSS = 1e-4
TOL_STEP_GRAD_DIRECT = 2e-4
TOL_STEP_GRAD_STREAM = 3e-2
# card vs CPU rollout, max |err| absolute: the first predicted frame passes
# 50 flow steps once; later frames feed that frame back through the
# extractor and the LSTM
TOL_FIRST_FRAME = 1e-3
TOL_LATER_FRAMES = 1e-2

BATCH, N_COND, N_PRED, N_REQUESTS = 8, 5, 10, 3
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS_A = 30, 10, 3
# published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and the float32 rate outside the tensor cores
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12
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


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the float32 operations over the peak rate outside the tensor cores."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def glowstep_flops(x, cond, u: int) -> int:
    """float32 operations of one GlowStep: the 1x1 and the three convs."""
    b, h, w, c = x.shape
    ca = c // 2 + cond.shape[-1]
    return 2 * b * h * w * (c * c + 9 * ca * u + u * u + 9 * u * c)


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got-ref|, max over elements of |got-ref| / (1+|ref|))."""
    err = (got - ref).abs()
    return err.max().item(), (err / (1.0 + ref.abs())).max().item()


# device kernels by name: the port's own, then cuDNN convolutions with
# their layout transposes, then cuBLAS products and triangular solves
KERNEL_KINDS = (("glowchain", ("glowchain",)),
                ("glowstep", ("glowstep",)),
                ("actnorm_invconv", ("actnorm_invconv",)),
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


def profile_call(fn, median_ms: float) -> dict:
    """One more call of ``fn`` (a request, a train step) under
    ``torch.profiler``: device busy time (the union of the device kernels'
    intervals), the device's idle share of the profiled call and of the
    unprofiled median call, and device time by kind of kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiled call ran no device kernel")
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

    def uniform(self, like, low, high):
        u = self.inner.uniform(like, low, high)
        self.draws.append(u.detach().cpu().clone())
        return u


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


def flow_scales(flow):
    """Per flow scale: (hw, x channels, cond channels)."""
    out = []
    for l in range(flow.cfg.L):
        step = flow.step(l, 0)
        out.append((flow.scale_hw[l], step.channels,
                    step.affine.net0.conv.kernel.shape[1] - step.channels // 2))
    return out


def check_repeats(name, fn):
    """Two launches on the same inputs must agree bit for bit (the kernels
    sum in a fixed order and use no atomics)."""
    first = fn()
    torch.cuda.synchronize()
    second = fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")


def check_elementwise(name, got, ref, tols):
    """Largest |err| over the outputs; raises where an element of output i
    exceeds tols[i]·(1+|ref|)."""
    worst = 0.0
    for a, b, tol in zip(got, ref, tols):
        e, r = rel_err(a, b)
        if not r <= tol:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"|err| {e:.3e}, {r:.3e} of 1+|ref| (> {tol})")
        worst = max(worst, e)
    return worst


def check_kernels(model, record):
    """Phase 3: every kernel against its plain version at the shapes of the
    main paths: the serving rollout (B=8) and the train step (B=30)."""
    import torch.nn.functional as F

    from recurrent_flows_tpu_torch.flows.glow import prep_glowstep_params
    from recurrent_flows_tpu_torch.ops import (
        GlowStepParams, actnorm_invconv, actnorm_invconv_ref, convlstm_gates,
        convlstm_gates_ref, coupling_transform, coupling_transform_ref,
        glowchain, glowchain_ref, glowstep, glowstep_ref, launch_plan)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale
    flow = model.flow
    scales = flow_scales(flow)
    u = flow.cfg.n_units_affine
    kernels = {}

    # coupling tail: AffineCoupling at scale 0 when serving, z2 [8,32,32,2]
    # (timed), and forward at every scale of the train step, [30,H,W,C/2]
    z2, shift, s = rnd(BATCH, 32, 32, 2), rnd(BATCH, 32, 32, 2), rnd(BATCH, 32, 32, 2, scale=0.5)
    t0 = time.perf_counter()
    coupling_transform(z2, shift, s, True)
    torch.cuda.synchronize()
    print(f"coupling_transform first launch (Triton compile): "
          f"{time.perf_counter() - t0:.2f} s")
    worst = 0.0
    shapes = [(BATCH, 32, 32, 2)] + [(TRAIN_BATCH, hw, hw, c // 2) for hw, c, _ in scales]
    for shape in shapes:
        a, b, c_ = rnd(*shape), rnd(*shape), rnd(*shape, scale=0.5)
        for reverse in (False, True):
            worst = max(worst, check_elementwise(
                f"coupling_transform {shape} reverse={reverse}",
                coupling_transform(a, b, c_, reverse),
                coupling_transform_ref(a, b, c_, reverse),
                (TOL_ELEMENTWISE, TOL_COUPLING_LD)))
    print(f"coupling_transform: {len(shapes)} shapes, both directions, err {worst:.3e}")
    kernels["coupling_transform"] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: coupling_transform(z2, shift, s, True)),
        plain_ms=cuda_ms(lambda: coupling_transform_ref(z2, shift, s, True)),
        library_ms=None,
        # 3 reads, 1 write, the logdet; ~4 operations per element
        **bound(nbytes(z2, shift, s, z2) + 4 * BATCH, 4 * z2.numel()))

    # ConvLSTM gates: gates [B,2,2,800], c [B,2,2,200], B=8 (timed) and 30
    hc = model.cfg.h_dim
    worst = 0.0
    for batch in (TRAIN_BATCH, BATCH):
        gates, c = rnd(batch, 2, 2, 4 * hc), rnd(batch, 2, 2, hc)
        peeps = [rnd(1, 2, 2, hc, scale=0.1) for _ in range(3)]
        worst = max(worst, check_elementwise(
            f"convlstm_gates B={batch}", convlstm_gates(gates, c, *peeps),
            convlstm_gates_ref(gates, c, *peeps), (TOL_ELEMENTWISE,) * 2))
    print(f"convlstm_gates: err {worst:.3e}")
    kernels["convlstm_gates"] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: convlstm_gates(gates, c, *peeps)),
        plain_ms=cuda_ms(lambda: convlstm_gates_ref(gates, c, *peeps)),
        library_ms=None,
        # gates, c and the peepholes in, h and c out; ~25 operations per state
        **bound(nbytes(gates, c, *peeps, c, c), 25 * c.numel()))

    # actnorm_invconv: the folded actnorm -> 1x1 of every scale of the train
    # step, x [30·H·W, C], on the model's own weights; times are summed over
    # the five scales. The library call is F.linear on the folded weights.
    worst, t = 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, n_bytes=0, flops=0)
    with torch.no_grad():
        for l, (hw, c, _) in enumerate(scales):
            step = flow.step(l, 0)
            x = rnd(TRAIN_BATCH, hw, hw, c)
            bias, logs = step.norm.bias.detach(), step.norm.logs.detach()
            w = step.invconv.weight(False).contiguous()
            y = actnorm_invconv(x, bias, logs, w)
            torch.cuda.synchronize()
            e = check_elementwise(f"actnorm_invconv scale {l}", (y,),
                                  (actnorm_invconv_ref(x, bias, logs, w),),
                                  (TOL_INVCONV,))
            worst = max(worst, e)
            wf = (w * torch.exp(logs)).contiguous()
            sh = (bias * torch.exp(logs)) @ w.T
            check_elementwise(f"F.linear scale {l}", (F.linear(x, wf, sh),), (y,),
                              (1e-4,))
            row = dict(scale=l, shape=[TRAIN_BATCH * hw * hw, c], err=e,
                       ms=cuda_ms(lambda: actnorm_invconv(x, bias, logs, w)),
                       plain_ms=cuda_ms(lambda: actnorm_invconv_ref(x, bias, logs, w)),
                       library_ms=cuda_ms(lambda: F.linear(x, wf, sh)),
                       n_bytes=nbytes(x, bias, logs, w, x),
                       flops=2 * x.numel() * c + 2 * x.numel())
            row.update(bound(row["n_bytes"], row["flops"]))
            record["actnorm_invconv"].append(row)
            print(f"actnorm_invconv scale {l} x{row['shape']}: err {e:.3e}, "
                  f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f}, F.linear "
                  f"{row['library_ms']:.5f}, bound {row['bound_ms']:.6f} ({row['bound_by']})")
            for k in t:
                t[k] += row[k]
    kernels["actnorm_invconv"] = dict(
        max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"],
        library_ms=t["library_ms"], **bound(t["n_bytes"], t["flops"]))

    # glowstep (train step, B=30, forward timed) and glowchain (serving, B=8,
    # reverse timed; train step, B=30, forward timed too): scales 1-4, both
    # directions, all clamps, on the model's own (perturbed) weights
    step_t = dict(ms=0.0, plain_ms=0.0, n_bytes=0, flops=0)
    chain_t = dict(ms=0.0, plain_ms=0.0, n_bytes=0, flops=0)
    step_worst = chain_worst = 0.0
    with torch.no_grad():
        for l in range(1, flow.cfg.L):
            hw, c_l, cc = scales[l]
            xs = {b: (rnd(b, hw, hw, c_l), rnd(b, hw, hw, cc)) for b in (BATCH, TRAIN_BATCH)}
            for b in xs:
                plan = launch_plan(b, hw, hw, c_l, cc, u)
                record["launch_plans"].append(dict(scale=l, batch=b, **plan._asdict()))
                print(f"launch plan scale {l} B={b}: tile of {plan.batch_tile} "
                      f"samples, {plan.clusters} clusters of {plan.cluster_blocks} "
                      f"blocks, {plan.stages} stages of {4 * plan.stage_floats} B, "
                      f"{plan.smem_bytes} B of shared memory, first hidden map "
                      f"through {'L2' if plan.ha_global else 'shared memory'}")
            for reverse in (False, True):
                order = reversed(range(flow.cfg.K)) if reverse else range(flow.cfg.K)
                preps = [prep_glowstep_params(flow.step(l, k), reverse)[0] for k in order]
                ps = GlowStepParams(*(torch.stack(v).contiguous() for v in zip(*preps)))
                # the model's own weights for realnvp (the slice's clamp); for
                # the other clamps the last conv is scaled down 10x, so that
                # the unclamped 'none' stays finite over 10 steps
                small = lambda p: p._replace(wc=0.1 * p.wc, bias_c=0.1 * p.bias_c)
                for clamp in ("realnvp", "glow", "softclamp", "none"):
                    p1 = preps[0] if clamp == "realnvp" else small(preps[0])
                    x, cond = xs[TRAIN_BATCH]
                    got = glowstep(x, cond, p1, clamp, reverse)
                    torch.cuda.synchronize()
                    e = check_elementwise(
                        f"glowstep scale {l} reverse={reverse} {clamp}", got,
                        glowstep_ref(x, cond, p1, clamp, reverse), (TOL_STEP, TOL_STEP))
                    record["glowstep_checks"].append(dict(
                        scale=l, shape=list(x.shape), cond=cc, reverse=reverse,
                        clamp=clamp, err=e))
                    step_worst = max(step_worst, e)
                    p_c = ps if clamp == "realnvp" else small(ps)
                    for b, (x, cond) in xs.items():
                        got = glowchain(x, cond, p_c, clamp, reverse)
                        torch.cuda.synchronize()
                        ref = glowchain_ref(x, cond, p_c, clamp, reverse)
                        if not all(torch.isfinite(r).all() for r in ref):
                            raise AssertionError(f"glowchain reference not finite at scale {l}, {clamp}")
                        e = check_elementwise(
                            f"glowchain scale {l} B={b} reverse={reverse} {clamp}",
                            got, ref, (TOL_CHAIN, TOL_CHAIN_LD))
                        record["glowchain_checks"].append(dict(
                            scale=l, shape=list(x.shape), cond=cc,
                            reverse=reverse, clamp=clamp, err=e))
                        chain_worst = max(chain_worst, e)
                print(f"glowstep, glowchain scale {l} {hw}x{hw}x{c_l} cond {cc} "
                      f"reverse={reverse}: 4 clamps agree")
                if not reverse:
                    x, cond = xs[TRAIN_BATCH]
                    check_repeats(f"glowstep scale {l}",
                                  lambda: glowstep(x, cond, preps[0], "realnvp", False))
                    check_repeats(f"glowchain scale {l} forward",
                                  lambda: glowchain(x, cond, ps, "realnvp", False))
                    row = dict(scale=l, shape=list(x.shape),
                               ms=cuda_ms(lambda: glowstep(x, cond, preps[0], "realnvp", False)),
                               plain_ms=cuda_ms(lambda: glowstep_ref(x, cond, preps[0], "realnvp", False)),
                               n_bytes=nbytes(x, cond, *preps[0], x) + 4 * TRAIN_BATCH,
                               flops=glowstep_flops(x, cond, u))
                    row.update(bound(row["n_bytes"], row["flops"]))
                    record["glowstep_ms"].append(row)
                    print(f"glowstep scale {l} forward B={TRAIN_BATCH}: {row['ms']:.3f} ms, "
                          f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']})")
                    for k in step_t:
                        step_t[k] += row[k]
                    row = dict(scale=l,
                               ms=cuda_ms(lambda: glowchain(x, cond, ps, "realnvp", False), iters=5),
                               plain_ms=cuda_ms(lambda: glowchain_ref(x, cond, ps, "realnvp", False), iters=5),
                               **bound(nbytes(x, cond, *ps, x) + 4 * TRAIN_BATCH,
                                       flow.cfg.K * glowstep_flops(x, cond, u)))
                    record["glowchain_train_ms"].append(row)
                    print(f"glowchain scale {l} forward B={TRAIN_BATCH}: {row['ms']:.3f} ms, "
                          f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']})")
                else:
                    x, cond = xs[BATCH]
                    check_repeats(f"glowchain scale {l} reverse",
                                  lambda: glowchain(x, cond, ps, "realnvp", True))
                    row = dict(scale=l,
                               ms=cuda_ms(lambda: glowchain(x, cond, ps, "realnvp", True), iters=10),
                               plain_ms=cuda_ms(lambda: glowchain_ref(x, cond, ps, "realnvp", True), iters=10),
                               n_bytes=nbytes(x, cond, *ps, x) + 4 * BATCH,
                               flops=flow.cfg.K * glowstep_flops(x, cond, u))
                    row.update(bound(row["n_bytes"], row["flops"]))
                    record["glowchain_ms"].append(row)
                    print(f"glowchain scale {l} reverse B={BATCH}: {row['ms']:.3f} ms, "
                          f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']})")
                    for k in chain_t:
                        chain_t[k] += row[k]
    kernels["glowstep"] = dict(
        max_abs_err=step_worst, ms=step_t["ms"], plain_ms=step_t["plain_ms"],
        library_ms=None, **bound(step_t["n_bytes"], step_t["flops"]))
    kernels["glowchain"] = dict(
        max_abs_err=chain_worst, ms=chain_t["ms"], plain_ms=chain_t["plain_ms"],
        library_ms=None, **bound(chain_t["n_bytes"], chain_t["flops"]))
    return kernels


def check_gradients(model):
    """Each kernel's autograd Function against autograd through its plain
    version, on a random projection of every output, at the train step's
    scale-2 shapes (B=30, 8x8x16, cond 64)."""
    from recurrent_flows_tpu_torch.flows.glow import prep_glowstep_params
    from recurrent_flows_tpu_torch.ops import (
        GlowStepParams, actnorm_invconv, actnorm_invconv_ref, convlstm_gates,
        convlstm_gates_ref, coupling_transform, coupling_transform_ref,
        glowchain, glowchain_ref, glowstep, glowstep_ref)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale
    flow = model.flow
    hw, c, cc = flow_scales(flow)[2]
    hc = model.cfg.h_dim
    with torch.no_grad():
        step = prep_glowstep_params(flow.step(2, 0), False)[0]
        chain = flow.chain_params(2, False)[0]
        w = flow.step(2, 0).invconv.weight(False).contiguous()
    x, cond = rnd(TRAIN_BATCH, hw, hw, c), rnd(TRAIN_BATCH, hw, hw, cc)
    half = [rnd(TRAIN_BATCH, hw, hw, c // 2, scale=0.5) for _ in range(3)]
    lstm = [rnd(TRAIN_BATCH, 2, 2, 4 * hc), rnd(TRAIN_BATCH, 2, 2, hc)] + [
        rnd(1, 2, 2, hc, scale=0.1) for _ in range(3)]
    pack = lambda i: (i[0], i[1], GlowStepParams(*i[2:]), "realnvp", False)
    cases = [
        ("coupling_transform", lambda i: coupling_transform(*i),
         lambda i: coupling_transform_ref(*i), half),
        ("convlstm_gates", lambda i: convlstm_gates(*i),
         lambda i: convlstm_gates_ref(*i), lstm),
        ("actnorm_invconv", lambda i: actnorm_invconv(*i),
         lambda i: actnorm_invconv_ref(*i), [x, rnd(c, scale=0.3), rnd(c, scale=0.3), w]),
        ("glowstep", lambda i: glowstep(*pack(i)), lambda i: glowstep_ref(*pack(i)),
         [x, cond, *step]),
        ("glowchain", lambda i: glowchain(*pack(i)), lambda i: glowchain_ref(*pack(i)),
         [x, cond, *chain]),
    ]
    errs = {}
    for name, fn, ref, inputs in cases:
        grads = []
        for f in (fn, ref):
            ins = [t.detach().clone().requires_grad_(True) for t in inputs]
            outs = f(ins)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pg = torch.Generator(device=dev).manual_seed(3)
            loss = sum((o * torch.randn(o.shape, generator=pg, device=dev)).sum()
                       for o in outs)
            grads.append(torch.autograd.grad(loss, ins))
        errs[name] = check_elementwise(f"gradient of {name}", grads[0], grads[1],
                                       (TOL_GRAD,) * len(inputs))
        print(f"gradient of {name}: {len(inputs)} inputs, max |err| {errs[name]:.3e}")
    return errs


def with_glow(mcfg, **glow):
    return dataclasses.replace(mcfg, glow=dataclasses.replace(mcfg.glow, **glow))


def serve(model, mcfg, tcfg, rng, record, card):
    """Phases 4-5: the serving path through Predictor, then card against CPU.
    Returns the launches of the timed requests."""
    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.serving import Predictor
    from recurrent_flows_tpu_torch.utils import NoiseSource

    pred = Predictor(model, tcfg, n_conditions=N_COND, n_predictions=N_PRED, seed=0)
    t0 = time.perf_counter()
    pred.warmup(batch_size=BATCH)
    torch.cuda.synchronize()
    print(f"warmup: {time.perf_counter() - t0:.2f} s")
    want = dict(actnorm_invconv=0, convlstm_gates=N_COND - 1 + N_PRED,
                coupling_transform=mcfg.K * N_PRED,
                glowchain=(mcfg.L - 1) * N_PRED, glowstep=0)
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
    prof = profile_call(lambda: pred.predict(ctx), med)
    record["profile"] = prof
    print_profile("request", prof)

    # phase 5: card against CPU, same weights and noise, B=2, 3 context, 2 predicted
    x = torch.tensor(moving_squares(rng, 2, 3, mcfg.image_size) - 0.5)
    cpu_model = copy.deepcopy(model).cpu()
    rec = RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(3)))
    _, p_cpu = cpu_model.predict(x, 2, 3, rec)
    _, p_gpu = model.predict(x.cuda(), 2, 3, NoiseSource(replay=rec.draws))
    p_gpu = p_gpu.cpu()
    errs = [(p_gpu[t] - p_cpu[t]).abs().max().item() for t in range(2)]
    print(f"card vs CPU rollout: max |err| per predicted frame {errs}, "
          f"max |x| {p_cpu.abs().max().item():.3f}")
    record["card_vs_cpu_err"] = errs
    if not (torch.isfinite(p_gpu).all() and errs[0] <= TOL_FIRST_FRAME
            and errs[1] <= TOL_LATER_FRAMES):
        raise AssertionError(f"card and CPU rollouts disagree: {errs}")
    return launches


def print_profile(what, prof):
    kinds = ", ".join(f"{k} {v['ms']:.1f} ms ({v['n']})" for k, v in
                      sorted(prof["by_kind"].items(), key=lambda kv: -kv[1]["ms"]))
    print(f"profiled {what}: device busy {prof['device_busy_ms']:.1f} ms "
          f"in {prof['n_kernels']} kernels, wall {prof['wall_ms']:.1f} ms "
          f"(idle share {prof['idle_share_profiled']:.2f}; "
          f"{prof['idle_share_of_median']:.2f} of the unprofiled median); "
          f"by kind: {kinds}")


def train_launches(mcfg, config: str, remat: bool) -> dict:
    """Launches of one train step of TRAIN_FRAMES frames. The h-LSTM runs
    once per input frame. Each of the T-1 per-frame steps runs L·K GlowSteps;
    with recomputation its forward runs twice (once in the forward pass,
    once replayed in the backward), so the flow's forward launches double."""
    frames = TRAIN_FRAMES - 1
    passes = 2 if remat else 1
    fused_scales = mcfg.L - 1  # scales 1-4 have H·W <= 256; scale 0 (32x32) never
    module_steps = mcfg.K * (mcfg.L if config == "A" else 1)
    return dict(
        actnorm_invconv=frames * passes * module_steps,
        convlstm_gates=frames,
        coupling_transform=frames * passes * module_steps,
        glowchain=frames * passes * fused_scales if config == "C" else 0,
        glowstep=frames * passes * fused_scales * mcfg.K if config == "B" else 0)


def train(mcfg, tcfg, rng, record, card):
    """Phase 6: Trainer.build and train steps of configurations A, B, C.
    Returns the summed launches of the counted steps."""
    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.training import Trainer

    configs = dict(A=mcfg, B=with_glow(mcfg, coupling_impl="fused"),
                   C=with_glow(mcfg, chain_impl="all"))
    batches = [moving_squares(rng, TRAIN_BATCH, TRAIN_FRAMES, mcfg.image_size)
               for _ in range(TRAIN_STEPS_A)]
    total = dict.fromkeys(ops.launch_counts(), 0)
    record["train"] = {}
    for name, cfg in configs.items():
        model = RFN(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        perturb_(model, seed=1)
        t0 = time.perf_counter()
        trainer = Trainer(model, tcfg, batches).build()
        torch.cuda.synchronize()
        print(f"train {name}: build with data-dependent init {time.perf_counter() - t0:.2f} s")
        steps = []

        def one_step(batch, remat=True, count=True):
            model.remat = remat
            want = train_launches(mcfg, name, remat)
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = {k: float(v) for k, v in trainer.train_step(
                batch, beta=tcfg.beta_min, lr=tcfg.learning_rate).items()}
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            if counts != want:
                raise AssertionError(f"train {name}: launches {counts}, expected {want}")
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"train {name}: metrics not finite: {m}")
            if count:
                for k, v in counts.items():
                    total[k] += v
            gib = torch.cuda.max_memory_allocated() / 2**30
            steps.append(dict(remat=remat, ms=ms, peak_gib=gib, launches=counts, **m))
            print(f"train {name} step {len(steps) - 1} (remat={remat}): {ms:.1f} ms, "
                  f"peak {gib:.2f} GiB, loss {m['loss']:.1f} = nll {m['nll']:.1f} + "
                  f"beta·kl (kl {m['kl']:.2f}), {m['bits']:.4f} bits/dim, launches {counts}")

        for batch in batches[:TRAIN_STEPS_A if name == "A" else 1]:
            one_step(batch)
        if name == "A":
            one_step(batches[0], remat=False, count=False)
            model.remat = True
            med = statistics.median(s["ms"] for s in steps[1:TRAIN_STEPS_A])
            prof = profile_call(lambda: trainer.train_step(
                batches[1], beta=tcfg.beta_min, lr=tcfg.learning_rate), med)
            record["train_profile"] = prof
            print_profile("train step A", prof)
        record["train"][name] = steps
        del trainer, model
        torch.cuda.empty_cache()
    print(f"train: {TRAIN_BATCH} sequences of {TRAIN_FRAMES} frames per step on {card}")
    return total


def train_card_vs_cpu(mcfg, tcfg, rng, record):
    """Phase 7: one train step's loss and gradients, card against CPU."""
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.training import Trainer
    from recurrent_flows_tpu_torch.utils import NoiseSource, float32_precision

    batch = moving_squares(rng, 2, 3, mcfg.image_size)
    gpu = RFN(mcfg, device="cuda", generator=torch.Generator().manual_seed(0))
    perturb_(gpu, seed=1)
    Trainer(gpu, tcfg, [batch]).build()  # actnorms from data, on the card
    gpu.remat = False  # the same arithmetic; spares the CPU a second forward
    cpu = copy.deepcopy(gpu).cpu()
    x = torch.tensor(batch) - 0.5
    rec = RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(5)))
    results = []
    for model, noise in ((cpu, rec), (gpu, None)):
        noise = noise or NoiseSource(replay=rec.draws)
        with float32_precision():
            out = model.loss(x.to(next(model.parameters()).device), noise)
            (out["nll"] + 0.5 * out["kl_free_bits"]).backward()
        results.append(({k: v.item() for k, v in out.items()},
                        {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.grad is not None}))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results
    for k, ref in l_cpu.items():
        if not abs(l_gpu[k] - ref) <= TOL_STEP_LOSS * (1 + abs(ref)):
            raise AssertionError(f"train step {k}: card {l_gpu[k]}, CPU {ref}")
    direct = ["flow.scale0_step9.affine.net2.conv.kernel",
              "flow.scale4_step0.affine.net0.conv.kernel",
              "flow.scale4_step9.affine.scale", "flow.split1.conv.conv.kernel",
              "flow.prior_out.conv.kernel", "prior.param_conv.kernel"]
    stream = ["flow.scale0_step0.invconv.lower", "flow.scale2_step5.norm.logs",
              "lstm.gates.kernel", "lstm.Wci", "extractor.b0_1.kernel",
              "upscaler.b4_2.kernel", "encoder.param_conv.kernel", "z_0x"]
    tols = {**dict.fromkeys(direct, TOL_STEP_GRAD_DIRECT),
            **dict.fromkeys(stream, TOL_STEP_GRAD_STREAM)}
    scales = {n: g_cpu[n].abs().max().item() for n in tols}
    errs = {n: (g_gpu[n] - g_cpu[n]).abs().max().item() / scales[n] for n in tols}
    print(f"card vs CPU train step: loss pieces card {l_gpu}, CPU {l_cpu}; "
          f"named gradients, err of max |g|: "
          + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()))
    record["train_card_vs_cpu"] = dict(card=l_gpu, cpu=l_cpu, grad_err=errs)
    bad = {n: e for n, e in errs.items() if not (scales[n] > 0 and e <= tols[n])}
    if bad:
        raise AssertionError(f"train step gradients disagree: {bad}")


SOURCES = {
    "coupling_transform": ("triton", "recurrent_flows_tpu_torch/ops/fused.py",
                           "recurrent_flows_tpu/ops/pallas/fused.py:75"),
    "actnorm_invconv": ("cuda", "recurrent_flows_tpu_torch/csrc/actnorm_invconv.cu",
                        "recurrent_flows_tpu/ops/pallas/fused.py:166"),
    "convlstm_gates": ("triton", "recurrent_flows_tpu_torch/ops/fused.py",
                       "recurrent_flows_tpu/ops/pallas/fused.py:257"),
    "glowstep": ("cuda", "recurrent_flows_tpu_torch/csrc/glowstep.cu",
                 "recurrent_flows_tpu/ops/pallas/glowstep.py:164"),
    "glowchain": ("cuda", "recurrent_flows_tpu_torch/csrc/glowchain.cu",
                  "recurrent_flows_tpu/ops/pallas/glowchain.py:84"),
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    from recurrent_flows_tpu_torch.config import rfn_mnist_production
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.ops._build import build_all
    from recurrent_flows_tpu_torch.utils import float32_precision

    t_start = time.perf_counter()
    card = card_info()
    print(f"card: {card}")
    record = dict(card=card, device=torch.cuda.get_device_name(0),
                  torch=torch.__version__, cuda=torch.version.cuda,
                  glowchain_checks=[], glowchain_ms=[], glowchain_train_ms=[],
                  glowstep_checks=[], glowstep_ms=[], actnorm_invconv=[],
                  launch_plans=[])

    # phase 2: build
    t0 = time.perf_counter()
    built = build_all()
    record["build_s"] = {name: secs for name, (_, secs) in built.items()}
    print(f"build: {record['build_s']} s, {time.perf_counter() - t0:.1f} s in all")

    # the serving model: production widths, chain_impl='sample', seeded
    mcfg, tcfg = rfn_mnist_production()
    model = RFN(with_glow(mcfg, chain_impl="sample"), device="cuda",
                generator=torch.Generator().manual_seed(0))
    perturb_(model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: rfn_mnist_production, {n_params} parameters")

    # phase 3: kernels against their plain versions, the plain side in
    # full float32; the later phases run with torch's defaults, as a user would
    with float32_precision():
        kernels = check_kernels(model, record)
        record["gradient_err"] = check_gradients(model)
    print(f"phase 3 done at {time.perf_counter() - t_start:.0f} s")

    rng = np.random.default_rng(0)
    launches = serve(model, mcfg, tcfg, rng, record, card)
    del model
    torch.cuda.empty_cache()
    print(f"serving done at {time.perf_counter() - t_start:.0f} s")
    for name, n in train(mcfg, tcfg, rng, record, card).items():
        launches[name] += n
    print(f"training done at {time.perf_counter() - t_start:.0f} s")
    train_card_vs_cpu(mcfg, tcfg, rng, record)

    never = [name for name in SOURCES if launches[name] == 0]
    if never:
        raise AssertionError(f"kernels the main paths never launched: {never}")
    line = {"kernels": [
        dict(name=name, route=route, source=source, replaces=replaces,
             launches=launches[name], **kernels[name])
        for name, (route, source, replaces) in SOURCES.items()]}
    record.update(line, total_s=time.perf_counter() - t_start)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"total {record['total_s']:.0f} s")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

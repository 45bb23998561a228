#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths at the full width of
``rfn_mnist_production``, then of ``rfn_bair`` and of a batch-norm variant
of ``rfn_kth`` (and, in phase 12, the families SRNN, VRNN and SVG at their
presets), on random weights made from a seed: the serving rollout
(``Predictor.predict`` -> ``RFN.predict``, ``chain_impl='sample'``) and the
training step (``Trainer.build`` -> ``Trainer.train_step`` -> ``RFN.loss``
-> ``ListGlow.log_prob``, forward and backward, with Adam) in its three
configurations: A the preset as it is, B ``coupling_impl='fused'``, C
``chain_impl='all'``. Phase by phase:

1. the card: CUDA must be available (there is no CPU path);
2. the build of the CUDA libraries (one nvcc per source, started together);
3. the launch floor (the device time of one in-place add on a one-element
   tensor), then each of the five kernels against its plain PyTorch version
   on the card, at the shapes the main paths give it (TF32 off), with the
   device times of the kernel, the plain version and, where one PyTorch
   call computes the same function, that call, beside the least time the
   card could take; for the coupling (on the strided 'split'/'cross' views
   AffineCoupling passes it, which must give what their contiguous copies
   give), the folded 1x1 and the gates (at B=8 and B=30, with the host's
   µs per eager call) also an in-place add over as much data, for all five
   the launch plan of every shape and a second launch that must repeat
   the first bit for bit; the coupling and the folded 1x1 also at the
   served batch (B=8) of every scale, as ``reconstruct`` and the
   diagnostics run them, checked and not timed; the host µs of one eager
   call through each kernel's ``torch.library`` operator (``rft::``) at
   every timed shape; then each kernel's registered autograd formula
   against autograd through its plain version, and
   ``torch.library.opcheck`` of each operator with CUDA tensors at one
   small shape;
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
   gradients;
8. the five kernels against their plain versions at the shapes of
   ``rfn_bair`` and ``rfn_kth`` (the folded 1x1 at 12-96 channels, at
   128-256, at the BAIR CLI step's 2x2x192, ``--L 6``'s 1x1x384 and the
   request's 4x4x96, at 24-96 beside the compile-time instance on the same
   inputs, with its gradients above 64; the coupling at rfn_bair's
   scales; the gates at h=256; the GlowStep kernels at rfn_bair's scale 3
   and rfn_kth's scales 2-3), times beside bounds, bit-for-bit repeats;
9. ``rfn_bair`` at full width: build with data-dependent init, 3 requests
   of 8 sequences (2 context, 10 predicted frames), train steps of 32
   sequences of 12 frames in A, B and C, with exact launch counts, a
   profiled request and step, then card against CPU (rollout, train step);
10. the batch-norm variant of ``rfn_kth`` (``flow_norm`` and ``base_norm``
    'batchnorm', ``lu_decomposed=False``, ``track_running_stats``): build,
    2 train steps that must move no running buffer, ``refresh_stats`` that
    must move them, a request with ``eval_norm``, card against CPU;
11. RFN's lifecycle at ``rfn_mnist_production``: ``MovingMNIST`` makes 30
    sequences on the card (device time by the profiler); a ``Trainer`` on
    it builds and fits 2 epochs of 2 steps (the largest |x| of a flow
    sample before the build, after it and after fit; launches per step as
    phase 6's step A; losses, ``status.txt``, ``metrics.jsonl``, the ``last``
    checkpoint, and its plots: ``losses.png`` and ``samples<n>.png`` decode
    with ``read_png``, no plot failure), then the plots' device part; a
    fresh ``Trainer`` loads
    ``last`` bit for bit and takes a step; ``Predictor.from_checkpoint``
    answers 3 requests each of ``predict``, ``reconstruct`` and ``sample``
    with exact launch counts and one profiled ``reconstruct``; then
    ``reconstruct``, ``sample`` and ``probability_future`` card against
    CPU (each element within a tolerance times 1 + its |ref|), and the
    diagnostics (``param_analysis``, ``probability_future``,
    ``reconstruct_elbo_gap``) on the card with exact launch counts;
12. the other families, ``srnn_mnist``, ``vrnn_mnist`` and ``svg_mnist`` at
    full width: the gates kernel against its plain version at h = 256 on
    8x8 (B=32 and B=8), both timed with their inputs out of L2; then per preset, on Moving MNIST made on the card:
    ``Trainer.build`` and 2 train steps of 32 sequences of 10 frames (ms,
    peak GiB) and one profiled, the ``last`` checkpoint served by
    ``Predictor.from_checkpoint`` bit for bit, 3 requests each of
    ``predict`` (5 context + 10 predicted frames), ``reconstruct`` and
    ``sample`` (10 frames) of 8 sequences with exact launch counts and a
    profiled ``predict``; then the loss pieces, a ``predict`` and the
    IW-ELBO on the card against the CPU at B=2;
13. the evaluation suite: the metrics (SSIM/PSNR/MSE of [8, 25, 64, 64, 1])
    and the embedders (the LPIPS proxy, ``lpips_alex`` and I3D on
    ``random_params(0)``, ``random3d``) against the CPU, with device times;
    the eval CLI (``cli.eval_settings.main``, in this process) on phase
    11's checkpoint with the thesis protocol (one batch of 8, 5 context and
    25 predicted frames, 30 resamples, FVD over 13 with ``random3d``,
    temperature 0.7): the wall ms and exact launches of each ``Evaluator``
    method, the shares of ``get_eval_values`` in rollouts, metrics and
    LPIPS, ``evaluations.json`` with the JAX CLI's keys and every number
    finite; one profiled 25-frame rollout; ``get_eval_values``,
    ``probability_future_bpp`` and ``elbo_gap`` card against CPU (B=2, 2
    resamples, 3 predicted frames, replayed noise); then the CLI with the
    default protocol on phase 12's ``srnn_mnist`` checkpoint (one batch of
    8, 5 + 10 frames, 5 resamples, the IW-ELBO with K=20), exact launches;
14. the training CLIs (``cli.main_*.main``, in this process, under
    ``runs/chip_smoke_cli/``): ``main_rfn`` at its defaults (K=15, L=5,
    with_skip, B=32, T=10) on Moving MNIST made on the card, 1 epoch of 1
    step (ms, peak GiB and exact launches per step), then
    ``--load_model`` (the loaded state bit for bit the saved one, the
    counter going on), the eval CLI on that checkpoint (one batch of 8, 2
    resamples, ``random3d``, exact launches per method); the kernels at the
    CLI's shapes against their plain versions (the gates at h = 256 on 2x2,
    the coupling and the folded 1x1 at B=32, the folded 1x1 also at the five
    scales of ``--choose_data bair`` (12-192 channels, with ``F.linear``'s
    time and a bit-for-bit repeat), ``glowchain`` at K=15 on the
    checkpoint's parameters) and 3 requests of the checkpoint served with
    ``chain_impl='sample'``; one step of ``--choose_data shapes``; for
    ``kth`` and ``bair``, on PNG trees the phase writes with row filters 3
    and 4, one step through the PNG loader, then both splits' blobs built
    by ``cli.build_framecache.main`` and one step through ``FrameCache``
    (shapes and KTH on 4 frames, BAIR at the defaults)
    (the loader's host ms per batch of both); ``main_srnn``, ``main_vrnn`` and
    ``main_svg`` at their defaults (1 step, exact gates launches);
    ``Trainer.train_epoch(1, profile_dir=...)`` (the Chrome trace parses
    and holds CUDA kernels); ``--multigpu`` in a one-process NCCL group
    against the same build and step without it, bit for bit. Every CLI
    run's plots decode with ``read_png`` and none failed;
15. the serving export: phase 11's checkpoint exported by
    ``cli.export_serving.main`` and phase 12's ``srnn_mnist`` one by
    ``Predictor.export`` (B=8, 5 context + 10 predicted frames; seconds to
    export and to load, the artifact's bytes, its ``rft::`` nodes); each
    artifact served by ``load_exported`` for 3 requests with exact launches
    per request, equal to the eager request's, and frames equal bit for bit
    to ``Predictor(seed=s).predict`` on the same checkpoint and context
    (with deterministic cuDNN algorithms for that comparison: by default
    SRNN's transposed convs sum with atomics, and two eager requests
    differ in the last bits);
16. the standalone models: the folded 1x1, the coupling and ``glowchain``
    against their plain versions at the shapes GlowImage and cGlow give
    them (device times beside bounds, bit-for-bit repeats); ``GlowImage``
    at BASELINE config 3 (64x64 gray, L=3, K=8, 128 units, conditions of
    8) on Moving MNIST made on the card (B=16, T=6: 96 frames a step):
    ``Trainer.build`` (DDI), 3 steps of A (``chain_impl='off'``) and one of
    C (``'all'``), ``sample(16)`` with ``'sample'`` (a warm-up and 3
    requests), exact launches, ms and peak GiB, then a step's nll and named
    gradients and a sample card against CPU; cGlow (32x32 RGB, L=2, K=4,
    conditions of 32, B=16) on a PNG tree of colour images through
    ``prepare_celeba`` -> ``get_celeba`` -> ``get_joint_conditioned_data``:
    the DDI pass, 3 Adam steps and 3 samples with exact launches, card
    against CPU; VRNN-1D on sinusoids (30 Adam steps, the loss must fall;
    ``predict(5, 4)``); RealNVP-2D on two-moons (400 steps: the loss must
    fall by more than 0.5 and the samples lie within 0.25 of the moons on
    average), one step each of the conditional RealNVP and
    ``AutoregFlow2D``; ``rfn_mnist_production`` with the VGG ops 'squeeze'
    and 'deconv' (build, a step of A, a request, exact launches); and
    ``scripts/torch_validate_training.py --model glow --image_size 64`` for
    40 steps (its verdict recorded, ``improved`` not asserted);
17. the spatial grid: the three pointwise kernels at the local shapes a
    rank of a 1x2 (data x model) grid gives them; the one-process steps A,
    B and C of ``rfn_mnist_production`` (B=30, T=10, a warm-up and a timed
    step, each from the same state with a fresh Adam and the noise of a
    fixed seed) and one ``srnn_mnist`` step; then two processes
    (``python3 chip_smoke.py --grid-rank R 2 PORT``) share the card over
    gloo on the grid (``parallel.make_mesh``, each rank 32 of the 64 rows)
    and take the same steps (no recomputation in either): exact halo,
    gather and launch counts per rank and step, every parameter,
    gradient and module output on the card,
    loss, kl and nll within 1e-5 of the one-process step's, gradients and
    updated parameters within the bar stated at ``GRID_T_FLOOR``; the ms
    per step sharded and in one process and the host ms in exchanges;
    then ``examples/torch_two_moons.py`` for 400 steps on the card (each
    flow's loss falls, every figure decodes).

Any failure raises and the script exits non-zero. The last two lines of
standard output are the kernels' JSON record (with each kernel's launches
per path) and the device record; the full record is written to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
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
TOL_INVCONV = 1e-5  # a C-term sum per output
# gradients through a kernel operator's registered backward against autograd
# through the plain version: the same backward arithmetic from forward values that differ by
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
# the same, relative to 1 + max|x| of the CPU's frames, for rfn_bair and
# rfn_kth: on random weights their rollouts reach |x| ~1.5e3 where
# rfn_mnist_production's stays under ~15, and the absolute tolerances above
# are 1e-3 and 1e-2 of 1 + 15
TOL_FIRST_FRAME_REL = TOL_FIRST_FRAME / 16
TOL_LATER_FRAMES_REL = TOL_LATER_FRAMES / 16
# phase 11, card vs CPU of the fitted rfn_mnist_production model: each
# element within tol·(1+|ref|), for an output that passes the flow once
# (recons, the first sampled frame) and one that passes it twice
# (recons_flow, the second sampled frame). The data-dependent init makes a
# flow sample reach |x| ~100-220 where phase 5's random model stays under
# ~16, and the card-vs-CPU difference grows with it (7.2e-6 to 1.3e-5 of
# 1 + max|x| over five fits, phase 5's 6.7e-6); elementwise it was
# 3.0e-4 to 7.0e-4 where the flow is passed once and up to 5.0e-3 where
# twice (scripts/torch_lifecycle_card_vs_cpu.py and this script). Twice
# phase 5's absolute tolerances hold them with a margin of 3-4x
TOL_LIFE_ONCE = 2 * TOL_FIRST_FRAME
TOL_LIFE_TWICE = 2 * TOL_LATER_FRAMES

BATCH, N_COND, N_PRED, N_REQUESTS = 8, 5, 10, 3
# phase 11: epochs and steps of fit; frames a reconstruct request takes and
# a sample request makes
FIT_EPOCHS, FIT_STEPS, LIFE_FRAMES = 2, 2, 10
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS_A = 30, 10, 3
# published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and the float32 rate outside the tensor cores
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12
# its L2 (NVIDIA's data sheet): what cold_ms rotates its copies past
L2_BYTES = 50 * 2**20
ROOT = Path(__file__).resolve().parent


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, repeats: int = 1) -> float:
    """Mean device time of one call of ``fn`` in ms: ``iters`` calls are
    captured into a CUDA graph, which is replayed between two CUDA events,
    so the host's cost of launching from Python is left out; with
    ``repeats`` > 1 the median over that many replays."""
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
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


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


# (H = W, C) of x at the flow's five scales in rfn_mnist_production
FLOW_SCALES = [(32 >> l, 4 << l) for l in range(5)]


def small_ms(fn) -> float:
    """``cuda_ms`` for the kernels of a few microseconds (the launch floor,
    the coupling, the folded 1x1, the gates): the median of 5 replays of 100
    calls."""
    return cuda_ms(fn, iters=100, repeats=5)


def cold_ms(fn, make_args, n_bytes: int) -> float:
    """``small_ms`` of ``fn(*args)`` with its inputs and outputs out of L2:
    the calls cycle through enough copies ``make_args()`` that more than
    three L2s of bytes (``n_bytes`` per call) pass between two reads of one
    copy, and every call's outputs are kept, so that none is written where
    an earlier one was. The time to hold against a bound of bytes over the
    device memory rate."""
    copies = [make_args() for _ in range(max(2, -(-3 * L2_BYTES // n_bytes)))]
    kept, turn = [], iter(range(10**9))

    def call():
        kept.append(fn(*copies[next(turn) % len(copies)]))

    ms = small_ms(call)
    del kept[:]
    return ms


def launch_floor_ms() -> float:
    """Device time of one in-place add on a one-element tensor: the least a
    standalone launch costs, the yardstick of the three small kernels."""
    one = torch.zeros(1, device="cuda")
    return small_ms(lambda: one.add_(1.0))


# (B, H = W, C/2, reverse) of the coupling tail timed in phase 3: the
# serving request (reverse, z2 [8,32,32,2]) and every scale of the train
# step (forward, [30,H,W,C/2])
COUPLING_TIMED = [(BATCH, 32, 2, True)] + [(TRAIN_BATCH, hw, c // 2, False)
                                           for hw, c in FLOW_SCALES]
# checked in both directions but not timed: the served batch at scales 1-4,
# where reconstruct and the diagnostics run log_prob (forward) on B=8
COUPLING_CHECKED = [(BATCH, hw, c // 2, False) for hw, c in FLOW_SCALES[1:]]


def coupling_cases(rnd, shapes):
    """([B, H, W, C/2], reverse, (z2, shift, s)) of the coupling tail at
    ``shapes`` (B, H = W, C/2, reverse): the 'split' half of x and the
    'cross' halves of the coupling net's output, as AffineCoupling passes
    them; ``rnd(*shape, scale=)`` draws the data."""
    for b, hw, ch, rev in shapes:
        x, h = rnd(b, hw, hw, 2 * ch), rnd(b, hw, hw, 2 * ch, scale=0.5)
        yield [b, hw, hw, ch], rev, (x[..., ch:], h[..., 0::2], torch.tanh(h[..., 1::2]))


def coupling_times(fn, z2, shift, s, reverse) -> dict:
    """Device ms of ``fn(z2, shift, s, reverse)`` on the views and on
    contiguous copies of z2 and shift, beside an in-place add over a tensor
    of z2's size (``add_ms``: one elementwise pass over as much data), and
    the host µs of one eager call on the views under ``no_grad``
    (``host_us``)."""
    dz2, dshift = z2.contiguous(), shift.contiguous()
    add = torch.zeros(z2.shape, device=z2.device)
    with torch.no_grad():
        host_us = eager_us(lambda: fn(z2, shift, s, reverse))
    return dict(ms=small_ms(lambda: fn(z2, shift, s, reverse)),
                contiguous_ms=small_ms(lambda: fn(dz2, dshift, s, reverse)),
                add_ms=small_ms(lambda: add.add_(1.0)), host_us=host_us)


def folded_linear(bias, logs, w):
    """(weight, bias) of the ``F.linear`` call that computes
    ``actnorm_invconv(x, bias, logs, w)``: its library yardstick."""
    return (w * torch.exp(logs)).contiguous(), (bias * torch.exp(logs)) @ w.T


def ainv_times(fn, x, bias, logs, w) -> dict:
    """Device ms of ``fn(x, bias, logs, w)`` beside ``F.linear`` on the
    folded weights (``library_ms``) and an in-place add over x (``add_ms``),
    and the host µs of one eager call under ``no_grad`` (``host_us``)."""
    import torch.nn.functional as F

    wf, sh = folded_linear(bias, logs, w)
    add = torch.zeros_like(x)
    with torch.no_grad():
        host_us = eager_us(lambda: fn(x, bias, logs, w))
    return dict(ms=small_ms(lambda: fn(x, bias, logs, w)),
                library_ms=small_ms(lambda: F.linear(x, wf, sh)),
                add_ms=small_ms(lambda: add.add_(1.0)), host_us=host_us)


def call_us(fn, calls: int = 50) -> float:
    """Host µs of one eager call of ``fn`` alone, for the kernels whose
    device time exceeds their host time: the median over ``calls`` calls
    of ``time.perf_counter`` around the call, the device idle before each."""
    times = []
    for _ in range(calls + 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times[5:])


def eager_us(fn, calls: int = 1000) -> float:
    """Host µs per eager call of ``fn``: ``time.perf_counter`` around
    ``calls`` calls with one synchronize at the end, after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def gates_times(fn, gates, c, peeps) -> dict:
    """Device ms of ``fn(gates, c, *peeps)`` beside an in-place add over c
    (``add_ms``), and the host µs of one eager call under ``no_grad`` as the
    serving rollout makes it (``host_us``)."""
    add = torch.zeros_like(c)
    with torch.no_grad():
        host_us = eager_us(lambda: fn(gates, c, *peeps))
    return dict(ms=small_ms(lambda: fn(gates, c, *peeps)),
                add_ms=small_ms(lambda: add.add_(1.0)), host_us=host_us)


# device kernels by name: the port's own, then cuDNN convolutions with
# their layout transposes, then cuBLAS products and triangular solves
KERNEL_KINDS = (("glowchain", ("glowchain",)),
                ("glowstep", ("glowstep",)),
                ("actnorm_invconv", ("actnorm_invconv", "ainv_kernel")),
                ("coupling_transform", ("coupling_kernel",)),
                ("convlstm_gates", ("gates_kernel",)),
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


def moving_squares(rng, batch: int, t: int, size: int, channels: int = 1) -> np.ndarray:
    """Context sequences in [0,1]: a bright square (of a random colour where
    there are several channels) moving in a straight line over a dim noisy
    background, one per sequence."""
    x = 0.1 * rng.random((batch, t, size, size, channels), dtype=np.float32)
    for b in range(batch):
        pos = rng.integers(0, size - 16, 2)
        vel = rng.integers(-3, 4, 2)
        colour = 1.0 if channels == 1 else rng.uniform(0.3, 1.0, channels)
        for i in range(t):
            r, c = np.clip(pos + i * vel, 0, size - 16)
            x[b, i, r:r + 16, c:c + 16, :] = colour
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
        GlowStepParams, actnorm_invconv, actnorm_invconv_ref, ainv_plan, convlstm_gates,
        convlstm_gates_ref, coupling_mode, coupling_plan, coupling_transform,
        coupling_transform_ref, gates_plan, glowchain, glowchain_ref, glowstep,
        glowstep_ref, launch_plan, nhwc_view)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale
    flow = model.flow
    scales = flow_scales(flow)
    u = flow.cfg.n_units_affine
    kernels = {}

    record["launch_floor_ms"] = floor = launch_floor_ms()
    print(f"launch floor (in-place add on one element): {floor:.5f} ms")

    def check_coupling(shape, z2, shift, s, rev):
        """Both directions against the plain version, the views against
        their contiguous copies, a repeat; returns (err, plan, mode)."""
        b, hh, ww, ch = shape
        plan = coupling_plan(b, hh * ww * ch)
        mode = coupling_mode(ch, hh * ww * ch, [(v.data_ptr(), *nhwc_view("v", v))
                                               for v in (z2, shift, s)])
        dz2, dshift = z2.contiguous(), shift.contiguous()
        e = 0.0
        for reverse in (False, True):
            got = coupling_transform(z2, shift, s, reverse)
            e = max(e, check_elementwise(
                f"coupling_transform {shape} reverse={reverse}", got,
                coupling_transform_ref(z2, shift, s, reverse),
                (TOL_ELEMENTWISE, TOL_COUPLING_LD)))
            dense = coupling_transform(dz2, dshift, s, reverse)
            if not all(torch.equal(a, b_) for a, b_ in zip(got, dense)):
                raise AssertionError(f"coupling_transform {shape}: the strided "
                                     "views and their contiguous copies give other results")
        check_repeats(f"coupling_transform {shape}",
                      lambda: coupling_transform(z2, shift, s, rev))
        return e, plan, mode

    # coupling tail at the request's shape and every train-step scale, on
    # the views AffineCoupling passes; times summed over the six shapes
    if [(hw, c) for hw, c, _ in scales] != FLOW_SCALES:
        raise AssertionError(f"the flow's scales {scales} are not {FLOW_SCALES}")
    worst, t = 0.0, dict(ms=0.0, plain_ms=0.0, n_bytes=0, flops=0)
    for shape, rev, (z2, shift, s) in coupling_cases(rnd, COUPLING_TIMED):
        b = shape[0]
        e, plan, mode = check_coupling(shape, z2, shift, s, rev)
        worst = max(worst, e)
        row = dict(shape=shape, reverse=rev, plan=plan._asdict(), mode=mode, err=e,
                   **coupling_times(coupling_transform, z2, shift, s, rev),
                   plain_ms=cuda_ms(lambda: coupling_transform_ref(z2, shift, s, rev)),
                   # 3 reads, 1 write, the logdet; ~4 operations per element
                   n_bytes=nbytes(z2, shift, s, z2) + 4 * b, flops=4 * z2.numel())
        row.update(bound(row["n_bytes"], row["flops"]))
        record["coupling_transform"].append(row)
        print(f"coupling_transform z2 {shape} {'reverse' if rev else 'forward'}: "
              f"plan {plan.blocks} blocks of {plan.threads} threads, mode {mode}; "
              f"{row['ms']:.5f} ms on the views ({row['ms'] / floor:.2f} floors), "
              f"{row['contiguous_ms']:.5f} on contiguous copies, in-place add "
              f"{row['add_ms']:.5f}, plain {row['plain_ms']:.5f}, "
              f"bound {row['bound_ms']:.6f} ({row['bound_by']}), {row['host_us']:.1f} µs "
              "of host per eager call")
        for k in t:
            t[k] += row[k]
    for shape, rev, (z2, shift, s) in coupling_cases(rnd, COUPLING_CHECKED):
        e, plan, mode = check_coupling(shape, z2, shift, s, rev)
        worst = max(worst, e)
        record["served_batch_checks"].append(dict(
            kernel="coupling_transform", shape=shape, plan=plan._asdict(), mode=mode, err=e))
        print(f"coupling_transform z2 {shape} (checked, not timed): plan {plan.blocks} "
              f"blocks of {plan.threads} threads, mode {mode}; err {e:.3e}")
    rows = record["coupling_transform"]
    print(f"coupling_transform: {len(rows)} shapes timed and {len(COUPLING_CHECKED)} "
          f"checked, both directions, err {worst:.3e}")
    # ms, plain_ms and bound_ms are sums over `shapes`; request_ms is the
    # serving request's shape alone, the one shape timed before the train
    # shapes were
    kernels["coupling_transform"] = dict(
        max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"], library_ms=None,
        **bound(t["n_bytes"], t["flops"]), request_ms=rows[0]["ms"],
        shapes=[r["shape"] for r in rows])

    # ConvLSTM gates: gates [B,2,2,800] -> h', c' [B,2,2,200] at the train
    # step (B=30) and the request (B=8); times summed over the two shapes
    hc = model.cfg.h_dim
    worst, t = 0.0, dict(ms=0.0, plain_ms=0.0, n_bytes=0, flops=0)
    for batch in (TRAIN_BATCH, BATCH):
        gates, c = rnd(batch, 2, 2, 4 * hc), rnd(batch, 2, 2, hc)
        peeps = [rnd(1, 2, 2, hc, scale=0.1) for _ in range(3)]
        plan = gates_plan(batch, 4, hc)
        e = check_elementwise(
            f"convlstm_gates B={batch}", convlstm_gates(gates, c, *peeps),
            convlstm_gates_ref(gates, c, *peeps), (TOL_ELEMENTWISE,) * 2)
        worst = max(worst, e)
        check_repeats(f"convlstm_gates B={batch}", lambda: convlstm_gates(gates, c, *peeps))
        row = dict(shape=list(gates.shape), plan=plan._asdict(), err=e,
                   **gates_times(convlstm_gates, gates, c, peeps),
                   plain_ms=cuda_ms(lambda: convlstm_gates_ref(gates, c, *peeps)),
                   # gates, c and the peepholes in, h and c out; ~25 operations per state
                   n_bytes=nbytes(gates, c, *peeps, c, c), flops=25 * c.numel())
        row.update(bound(row["n_bytes"], row["flops"]))
        record["convlstm_gates"].append(row)
        print(f"convlstm_gates gates {row['shape']}: plan {plan.blocks} blocks of "
              f"{plan.threads} threads, one state each; "
              f"err {e:.3e}, {row['ms']:.5f} ms ({row['ms'] / floor:.2f} floors), in-place "
              f"add {row['add_ms']:.5f}, plain {row['plain_ms']:.5f}, bound "
              f"{row['bound_ms']:.6f} ({row['bound_by']}), {row['host_us']:.1f} µs of "
              "host per eager call")
        for k in t:
            t[k] += row[k]
    rows = record["convlstm_gates"]
    # ms, plain_ms and bound_ms are sums over `shapes`; request_ms is the
    # serving request's shape alone, the one shape timed before the train
    # shape was
    kernels["convlstm_gates"] = dict(
        max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"], library_ms=None,
        **bound(t["n_bytes"], t["flops"]), request_ms=rows[-1]["ms"],
        shapes=[r["shape"] for r in rows])

    # actnorm_invconv: the folded actnorm -> 1x1 of every scale of the train
    # step, x [30·H·W, C], on the model's own weights; times are summed over
    # the five scales. The library call is F.linear on the folded weights.
    worst, t = 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, n_bytes=0, flops=0)
    with torch.no_grad():
        for l, (hw, c, _) in enumerate(scales):
            step = flow.step(l, 0)
            x = rnd(TRAIN_BATCH, hw, hw, c)
            bias, logs = step.norm.bias.detach(), step.norm.logs.detach()
            w = step.invconv.matrix(False).contiguous()
            y = actnorm_invconv(x, bias, logs, w)
            torch.cuda.synchronize()
            e = check_elementwise(f"actnorm_invconv scale {l}", (y,),
                                  (actnorm_invconv_ref(x, bias, logs, w),),
                                  (TOL_INVCONV,))
            worst = max(worst, e)
            check_repeats(f"actnorm_invconv scale {l}",
                          lambda: (actnorm_invconv(x, bias, logs, w),))
            plan = ainv_plan(TRAIN_BATCH * hw * hw, c)
            check_elementwise(f"F.linear scale {l}",
                              (F.linear(x, *folded_linear(bias, logs, w)),), (y,), (1e-4,))
            row = dict(scale=l, shape=[TRAIN_BATCH * hw * hw, c], err=e, plan=plan._asdict(),
                       **ainv_times(actnorm_invconv, x, bias, logs, w),
                       plain_ms=cuda_ms(lambda: actnorm_invconv_ref(x, bias, logs, w)),
                       n_bytes=nbytes(x, bias, logs, w, x),
                       flops=2 * x.numel() * c + 2 * x.numel())
            row.update(bound(row["n_bytes"], row["flops"]))
            record["actnorm_invconv"].append(row)
            print(f"actnorm_invconv scale {l} x{row['shape']}: plan {plan.blocks} blocks "
                  f"of {plan.threads} threads ({plan.rows_per_block} rows x {plan.groups} "
                  f"output vectors, {plan.lanes} lanes each), err {e:.3e}, "
                  f"{row['ms']:.5f} ms ({row['ms'] / floor:.2f} floors), in-place add "
                  f"{row['add_ms']:.5f}, plain {row['plain_ms']:.5f}, F.linear "
                  f"{row['library_ms']:.5f}, "
                  f"bound {row['bound_ms']:.6f} ({row['bound_by']}), {row['host_us']:.1f} µs "
                  "of host per eager call")
            for k in t:
                t[k] += row[k]
        # the served batch (B=8) at every scale, as reconstruct and the
        # diagnostics run it through log_prob: checked, not timed
        for l, (hw, c, _) in enumerate(scales):
            step = flow.step(l, 0)
            x = rnd(BATCH, hw, hw, c)
            bias, logs = step.norm.bias.detach(), step.norm.logs.detach()
            w = step.invconv.matrix(False).contiguous()
            name = f"actnorm_invconv scale {l} B={BATCH}"
            e = check_elementwise(name, (actnorm_invconv(x, bias, logs, w),),
                                  (actnorm_invconv_ref(x, bias, logs, w),), (TOL_INVCONV,))
            worst = max(worst, e)
            check_repeats(name, lambda: (actnorm_invconv(x, bias, logs, w),))
            plan = ainv_plan(BATCH * hw * hw, c)
            record["served_batch_checks"].append(dict(
                kernel="actnorm_invconv", scale=l, shape=[BATCH * hw * hw, c],
                plan=plan._asdict(), err=e))
            print(f"actnorm_invconv scale {l} x{[BATCH * hw * hw, c]} (checked, not timed): "
                  f"plan {plan.blocks} blocks of {plan.threads} threads "
                  f"({plan.rows_per_block} rows x {plan.groups} output vectors, "
                  f"{plan.lanes} lanes each), err {e:.3e}")
    # every time a sum over `shapes`, the five scales of the train step
    kernels["actnorm_invconv"] = dict(
        max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"],
        library_ms=t["library_ms"], **bound(t["n_bytes"], t["flops"]),
        shapes=[r["shape"] for r in record["actnorm_invconv"]])

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
                               host_us=call_us(lambda: glowstep(x, cond, preps[0], "realnvp", False)),
                               ms=cuda_ms(lambda: glowstep(x, cond, preps[0], "realnvp", False)),
                               plain_ms=cuda_ms(lambda: glowstep_ref(x, cond, preps[0], "realnvp", False)),
                               n_bytes=nbytes(x, cond, *preps[0], x) + 4 * TRAIN_BATCH,
                               flops=glowstep_flops(x, cond, u))
                    row.update(bound(row["n_bytes"], row["flops"]))
                    record["glowstep_ms"].append(row)
                    print(f"glowstep scale {l} forward B={TRAIN_BATCH}: {row['ms']:.3f} ms, "
                          f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']}), {row['host_us']:.1f} µs of host per call")
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
                               host_us=call_us(lambda: glowchain(x, cond, ps, "realnvp", True)),
                               ms=cuda_ms(lambda: glowchain(x, cond, ps, "realnvp", True), iters=10),
                               plain_ms=cuda_ms(lambda: glowchain_ref(x, cond, ps, "realnvp", True), iters=10),
                               n_bytes=nbytes(x, cond, *ps, x) + 4 * BATCH,
                               flops=flow.cfg.K * glowstep_flops(x, cond, u))
                    row.update(bound(row["n_bytes"], row["flops"]))
                    record["glowchain_ms"].append(row)
                    print(f"glowchain scale {l} reverse B={BATCH}: {row['ms']:.3f} ms, "
                          f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']}), {row['host_us']:.1f} µs of host per call")
                    for k in chain_t:
                        chain_t[k] += row[k]
    kernels["glowstep"] = dict(
        max_abs_err=step_worst, ms=step_t["ms"], plain_ms=step_t["plain_ms"],
        library_ms=None, **bound(step_t["n_bytes"], step_t["flops"]))
    kernels["glowchain"] = dict(
        max_abs_err=chain_worst, ms=chain_t["ms"], plain_ms=chain_t["plain_ms"],
        library_ms=None, **bound(chain_t["n_bytes"], chain_t["flops"]))
    # host µs per eager call through each kernel's operator, at every shape
    # timed above (no_grad, as the rollout calls them)
    record["op_host_us"] = {name: [round(r["host_us"], 2) for r in record[key]] for name, key in (
        ("coupling_transform", "coupling_transform"), ("actnorm_invconv", "actnorm_invconv"),
        ("convlstm_gates", "convlstm_gates"), ("glowstep", "glowstep_ms"),
        ("glowchain", "glowchain_ms"))}
    print(f"host µs per eager call through the operators: {record['op_host_us']}")
    return kernels


def check_gradients(model):
    """Each kernel's registered autograd formula (``ops.library``) against
    autograd through its plain version, on a random projection of every
    output, at the train step's scale-2 shapes (B=30, 8x8x16, cond 64)."""
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
        w = flow.step(2, 0).invconv.matrix(False).contiguous()
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


def check_opchecks(record) -> dict:
    """``torch.library.opcheck`` of each of the five ``rft::`` operators with
    CUDA tensors at one small shape (the coupling on 'split'/'cross' views):
    the schema, the autograd registration, the fake implementation against
    the kernel, and AOT dispatch with dynamic shapes. Returns seconds per
    operator."""
    from recurrent_flows_tpu_torch.ops import GlowStepParams

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=g, device=dev) * scale).requires_grad_()
    c, cc, u = 4, 2, 8
    shapes = dict(an_bias=(c,), an_logs=(c,), w1x1=(c, c), wa=(9, c // 2 + cc, u),
                  ana_bias=(u,), ana_logs=(u,), wb=(u, u), anb_bias=(u,), anb_logs=(u,),
                  wc=(9, u, c), bias_c=(c,), clamp_scale=(c // 2,), clamp_shift=(c // 2,))
    params = lambda lead: [rnd(*lead, *shapes[f], scale=0.1) for f in GlowStepParams._fields]
    x, h = rnd(2, 4, 4, 8), rnd(2, 4, 4, 8, scale=0.5)
    cases = {
        "coupling_transform": (x[..., 4:], h[..., 0::2], torch.tanh(h[..., 1::2]), False),
        "actnorm_invconv": (rnd(16, 8), rnd(8, scale=0.3), rnd(8, scale=0.3),
                            torch.linalg.qr(torch.randn(8, 8, device=dev))[0].contiguous().requires_grad_()),
        "convlstm_gates": (rnd(2, 2, 2, 16), rnd(2, 2, 2, 4),
                           *(rnd(1, 2, 2, 4, scale=0.1) for _ in range(3))),
        "glowstep": (rnd(2, 4, 4, c), rnd(2, 4, 4, cc), *params(()), "realnvp", False),
        "glowchain": (rnd(2, 4, 4, c), rnd(2, 4, 4, cc), *params((2,)), "realnvp", True),
    }
    # the GlowStep operators' registered backward re-runs their plain version
    # under autograd, device-agnostic, held by the CPU opchecks and by
    # check_gradients on the card; here their inputs take no gradient, which
    # keeps AOT dispatch from tracing that backward (20-30 s each)
    for name in ("glowstep", "glowchain"):
        cases[name] = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                            for a in cases[name])
    seconds = {}
    for name, args in cases.items():
        t0 = time.perf_counter()
        torch.library.opcheck(getattr(torch.ops.rft, name).default, args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    record["opcheck_s"] = seconds
    print("torch.library.opcheck on the card: " + ", ".join(
        f"rft::{k} passed ({v:.1f} s)" for k, v in seconds.items()))
    return seconds


# rfn_bair: (H = W, C) of x at its four flow scales; the scale its with_skip
# conditions leave to the glowstep/glowchain kernels (scales 1-2 have no
# launch plan); its serving context
BAIR_SCALES = [(32 >> l, 12 << l) for l in range(4)]
BAIR_KERNEL_SCALES = [3]
BAIR_N_COND, BAIR_TRAIN_BATCH = 2, 32
# the folded 1x1 above 96 channels on rows of 32·4·4: gray at L = 6 (128),
# RGB at L = 5 (192: main_rfn --choose_data bair at its defaults, whose
# 2x2x192 scale phase 14 runs) and gray at L = 7 (256); then that CLI step's
# own x [32·2·2, 192]
WIDE_INVCONV = (128, 192, 256)
BAIR_CLI_WIDE = (BAIR_TRAIN_BATCH * 4, 192)
# main_rfn --choose_data bair --L 6: its last scale, x [32·1·1, 384], beyond
# the 256 channels one stage holds (two stage buffers take turns)
BAIR_L6_WIDE = (BAIR_TRAIN_BATCH, 384)
# rfn_bair's serving request at its widest scale, x [8·4·4, 96]: the RGB widths
# at this little work take the compile-time instance (ops.AINV_REGISTER_WORK)
BAIR_REQUEST_96 = (BATCH * 16, 96)
# (H = W, C, cond) of the GlowStep kernels' new shapes: rfn_bair scale 3,
# rfn_kth scales 2-3
NEW_GLOW_SHAPES = [(4, 96, 384), (8, 16, 384), (4, 32, 384)]


def glow_params(rnd, k: int, c: int, cc: int, u: int):
    """Kernel-ready parameters of k stacked GlowSteps, drawn with fan-in
    scales so that 10 steps stay finite (the recipe of the card tests)."""
    from recurrent_flows_tpu_torch.ops import GlowStepParams

    fan_a, fan_c = 9 * (c // 2 + cc), 9 * u
    eye = torch.eye(c, device="cuda").repeat(k, 1, 1)
    return GlowStepParams(
        an_bias=rnd(k, c, scale=0.1), an_logs=rnd(k, c, scale=0.1),
        w1x1=eye + rnd(k, c, c, scale=0.3 / c),
        wa=rnd(k, 9, c // 2 + cc, u, scale=fan_a ** -0.5), ana_bias=rnd(k, u, scale=0.1),
        ana_logs=rnd(k, u, scale=0.1), wb=rnd(k, u, u, scale=u ** -0.5),
        anb_bias=rnd(k, u, scale=0.1), anb_logs=rnd(k, u, scale=0.1),
        wc=rnd(k, 9, u, c, scale=0.3 * fan_c ** -0.5), bias_c=rnd(k, c, scale=0.1),
        clamp_scale=1 + rnd(k, c // 2, scale=0.1), clamp_shift=rnd(k, c // 2, scale=0.1))


def check_new_shapes(record):
    """Every kernel against its plain version at the shapes rfn_bair and
    rfn_kth give it (and the folded 1x1 at 128-256 channels, at the BAIR
    CLI step's 2x2x192, --L 6's 1x1x384 and the request's 4x4x96; at 24-96
    the train step's x also timed in the compile-time instance), with the
    tolerances of phase 3, a bit-for-bit repeat,
    device times beside their bounds, and the folded 1x1's gradients above
    64 channels. Returns per kernel the worst error and the times summed
    over its shapes."""
    import torch.nn.functional as F

    from recurrent_flows_tpu_torch.ops import (
        GlowStepParams, actnorm_invconv, actnorm_invconv_ref, ainv_plan, convlstm_gates,
        convlstm_gates_ref, coupling_transform, coupling_transform_ref, gates_plan,
        glowchain, glowchain_ref, glowstep, glowstep_ref, launch_plan)
    from recurrent_flows_tpu_torch.ops.fused import ainv_launch_plan, ainv_row_plan

    g = torch.Generator(device="cuda").manual_seed(11)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale
    out = {}

    def add(name, row, err):
        t = out.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                      library_ms=None, n_bytes=0, flops=0))
        t["max_abs_err"] = max(t["max_abs_err"], err)
        for k in ("ms", "plain_ms", "n_bytes", "flops"):
            t[k] += row[k]
        if row.get("library_ms") is not None:
            t["library_ms"] = (t["library_ms"] or 0.0) + row["library_ms"]
        record.setdefault(name, []).append(row)

    # the folded 1x1: x [32·H·W, C] at rfn_bair's four scales, then 128-256,
    # the BAIR CLI step's 2x2x192, --L 6's 1x1x384 and the request's 4x4x96;
    # at 24, 48 and 96 the train step's x also through the compile-time
    # instance (vec 1), the design ainv_plan leaves there at little work
    cases = [(BAIR_TRAIN_BATCH * hw * hw, c) for hw, c in BAIR_SCALES]
    cases += [(BAIR_TRAIN_BATCH * 16, c) for c in WIDE_INVCONV]
    cases += [BAIR_CLI_WIDE, BAIR_L6_WIDE, BAIR_REQUEST_96]
    for rows, c in cases:
        x = rnd(rows, c)
        bias, logs = rnd(c, scale=0.3), rnd(c, scale=0.3)
        w = torch.linalg.qr(rnd(c, c))[0].contiguous()  # orthogonal, as InvConv's init
        y = actnorm_invconv(x, bias, logs, w)
        torch.cuda.synchronize()
        ref = actnorm_invconv_ref(x, bias, logs, w)
        e = check_elementwise(f"actnorm_invconv [{rows}, {c}]", (y,), (ref,), (TOL_INVCONV,))
        check_repeats(f"actnorm_invconv [{rows}, {c}]",
                      lambda: (actnorm_invconv(x, bias, logs, w),))
        check_elementwise(f"F.linear [{rows}, {c}]",
                          (F.linear(x, *folded_linear(bias, logs, w)),), (y,), (1e-4,))
        plan = ainv_plan(rows, c)
        row = dict(shape=[rows, c], err=e, plan=plan._asdict(),
                   **ainv_times(actnorm_invconv, x, bias, logs, w),
                   plain_ms=cuda_ms(lambda: actnorm_invconv_ref(x, bias, logs, w)),
                   n_bytes=nbytes(x, bias, logs, w, x), flops=2 * x.numel() * c + 2 * x.numel())
        row.update(bound(row["n_bytes"], row["flops"]))
        also = ""
        if c in (24, 48, 96) and plan.vec == 2:
            vec1 = ainv_row_plan(rows, c, 1)
            row["vec1_err"] = check_elementwise(
                f"actnorm_invconv [{rows}, {c}] in vec 1",
                (ainv_launch_plan(vec1, x, bias, logs, w),), (ref,), (TOL_INVCONV,))
            row["vec1_ms"] = small_ms(lambda: ainv_launch_plan(vec1, x, bias, logs, w))
            also = f" (vec 1 {row['vec1_ms']:.5f})"
        add("actnorm_invconv", row, e)
        print(f"actnorm_invconv x[{rows}, {c}]: plan vec {plan.vec}, {plan.blocks} blocks of "
              f"{plan.threads} threads, err {e:.3e}, {row['ms']:.5f} ms{also}, plain "
              f"{row['plain_ms']:.5f}, F.linear {row['library_ms']:.5f}, bound "
              f"{row['bound_ms']:.6f} ({row['bound_by']})")
    grads = {}
    for c in (96, 256):
        inputs = [rnd(BAIR_TRAIN_BATCH * 16, c), rnd(c, scale=0.3), rnd(c, scale=0.3),
                  torch.linalg.qr(rnd(c, c))[0].contiguous()]
        got = []
        for f in (actnorm_invconv, actnorm_invconv_ref):
            ins = [t.detach().clone().requires_grad_(True) for t in inputs]
            pg = torch.Generator(device="cuda").manual_seed(3)
            o = f(*ins)
            got.append(torch.autograd.grad((o * torch.randn(o.shape, generator=pg,
                                                            device="cuda")).sum(), ins))
        grads[c] = check_elementwise(f"gradient of actnorm_invconv at C={c}", got[0],
                                     got[1], (TOL_GRAD,) * 4)
    record["actnorm_invconv_grad_err"] = grads
    print(f"gradient of actnorm_invconv above 64 channels: {grads}")

    # the coupling tail: the serving request's reverse at scale 0 (B=8) and
    # the train step's four scales forward (B=32), on AffineCoupling's views
    shapes = [(BATCH, 32, 6, True)] + [(BAIR_TRAIN_BATCH, hw, c // 2, False)
                                       for hw, c in BAIR_SCALES]
    for b, hw, ch, rev in shapes:
        x, h = rnd(b, hw, hw, 2 * ch), rnd(b, hw, hw, 2 * ch, scale=0.5)
        z2, shift, s = x[..., ch:], h[..., 0::2], torch.tanh(h[..., 1::2])
        e = 0.0
        for reverse in (False, True):
            e = max(e, check_elementwise(
                f"coupling_transform {[b, hw, hw, ch]} reverse={reverse}",
                coupling_transform(z2, shift, s, reverse),
                coupling_transform_ref(z2, shift, s, reverse),
                (TOL_ELEMENTWISE, TOL_COUPLING_LD)))
        check_repeats(f"coupling_transform {[b, hw, hw, ch]}",
                      lambda: coupling_transform(z2, shift, s, rev))
        row = dict(shape=[b, hw, hw, ch], reverse=rev, err=e,
                   **coupling_times(coupling_transform, z2, shift, s, rev),
                   plain_ms=cuda_ms(lambda: coupling_transform_ref(z2, shift, s, rev)),
                   n_bytes=nbytes(z2, shift, s, z2) + 4 * b, flops=4 * z2.numel())
        row.update(bound(row["n_bytes"], row["flops"]))
        add("coupling_transform", row, e)
        print(f"coupling_transform z2 {row['shape']} {'reverse' if rev else 'forward'}: "
              f"err {e:.3e}, {row['ms']:.5f} ms, plain {row['plain_ms']:.5f}, bound "
              f"{row['bound_ms']:.6f} ({row['bound_by']})")

    # the gates at h = 256, 4x4: the request (B=8) and the train step (B=32)
    for b in (BATCH, BAIR_TRAIN_BATCH):
        gates, c = rnd(b, 4, 4, 1024), rnd(b, 4, 4, 256)
        peeps = [rnd(1, 4, 4, 256, scale=0.1) for _ in range(3)]
        e = check_elementwise(f"convlstm_gates [{b},4,4,1024]",
                              convlstm_gates(gates, c, *peeps),
                              convlstm_gates_ref(gates, c, *peeps), (TOL_ELEMENTWISE,) * 2)
        check_repeats(f"convlstm_gates [{b},4,4,1024]",
                      lambda: convlstm_gates(gates, c, *peeps))
        plan = gates_plan(b, 16, 256)
        row = dict(shape=list(gates.shape), plan=plan._asdict(), err=e,
                   **gates_times(convlstm_gates, gates, c, peeps),
                   plain_ms=cuda_ms(lambda: convlstm_gates_ref(gates, c, *peeps)),
                   n_bytes=nbytes(gates, c, *peeps, c, c), flops=25 * c.numel())
        row.update(bound(row["n_bytes"], row["flops"]))
        add("convlstm_gates", row, e)
        print(f"convlstm_gates gates {row['shape']}: plan {plan.blocks} blocks of "
              f"{plan.threads} threads, err {e:.3e}, {row['ms']:.5f} ms, plain "
              f"{row['plain_ms']:.5f}, bound {row['bound_ms']:.6f} ({row['bound_by']})")

    # glowstep and glowchain (K = 10) at rfn_bair scale 3 and rfn_kth scales
    # 2-3, both directions, B = 8 and 32; timed: glowstep forward and the
    # chain forward at B=32, the chain reverse at B=8
    u = 256
    for hw, c, cc in NEW_GLOW_SHAPES:
        ps = glow_params(rnd, 10, c, cc, u)
        p0 = GlowStepParams(*(t[0].contiguous() for t in ps))
        for b in (BATCH, BAIR_TRAIN_BATCH):
            plan = launch_plan(b, hw, hw, c, cc, u)
            record.setdefault("launch_plans", []).append(
                dict(shape=[b, hw, hw, c], cond=cc, **plan._asdict()))
            x, cond = rnd(b, hw, hw, c), rnd(b, hw, hw, cc)
            for reverse in (False, True):
                for name, fn, ref, p, tol in (("glowstep", glowstep, glowstep_ref, p0, TOL_STEP),
                                              ("glowchain", glowchain, glowchain_ref, ps,
                                               TOL_CHAIN)):
                    got = fn(x, cond, p, "realnvp", reverse)
                    torch.cuda.synchronize()
                    e = check_elementwise(f"{name} {[b, hw, hw, c]} cond {cc} "
                                          f"reverse={reverse}", got,
                                          ref(x, cond, p, "realnvp", reverse), (tol, tol))
                    check_repeats(f"{name} {[b, hw, hw, c]} reverse={reverse}",
                                  lambda: fn(x, cond, p, "realnvp", reverse))
                    k = 1 if name == "glowstep" else 10
                    timed = (b == BAIR_TRAIN_BATCH and not reverse) or (
                        name == "glowchain" and b == BATCH and reverse)
                    row = dict(shape=[b, hw, hw, c], cond=cc, reverse=reverse, err=e,
                               ms=0.0, plain_ms=0.0, n_bytes=0, flops=0)
                    if timed:
                        row.update(
                            ms=cuda_ms(lambda: fn(x, cond, p, "realnvp", reverse), iters=5),
                            plain_ms=cuda_ms(lambda: ref(x, cond, p, "realnvp", reverse),
                                             iters=5),
                            n_bytes=nbytes(x, cond, *p, x) + 4 * b,
                            flops=k * glowstep_flops(x, cond, u))
                        row.update(bound(row["n_bytes"], row["flops"]))
                        print(f"{name} {row['shape']} cond {cc} reverse={reverse}: "
                              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
                              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
                    add(name, row, e)
        print(f"glowstep, glowchain {hw}x{hw}x{c} cond {cc}: B=8 and 32, both "
              "directions agree and repeat")
    for t in out.values():
        t.update(bound(t.pop("n_bytes"), t.pop("flops")))
    return out


def with_glow(mcfg, **glow):
    return dataclasses.replace(mcfg, glow=dataclasses.replace(mcfg.glow, **glow))


def request_launches(mcfg, chain_scales, n_cond: int, n_pred: int = N_PRED) -> dict:
    """Launches of one request (a rollout of n_pred frames): the h-LSTM over
    the n_cond-1 warm-up frames and once per predicted frame; per predicted
    frame one glowchain per chain scale and K coupling tails per other scale
    (the sampling direction has no folded 1x1)."""
    return dict(actnorm_invconv=0, convlstm_gates=n_cond - 1 + n_pred,
                coupling_transform=mcfg.K * (mcfg.L - len(chain_scales)) * n_pred,
                glowchain=len(chain_scales) * n_pred, glowstep=0)


def serve(model, mcfg, tcfg, rng, record, card, want, n_cond, label="request"):
    """The serving path through Predictor: warm-up, N_REQUESTS requests of
    BATCH sequences with exact launch counts, then one profiled request.
    Returns the launches of the timed requests."""
    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.serving import Predictor

    img, ch = mcfg.image_size, mcfg.x_channels
    pred = Predictor(model, tcfg, n_conditions=n_cond, n_predictions=N_PRED, seed=0)
    t0 = time.perf_counter()
    pred.warmup(batch_size=BATCH)
    torch.cuda.synchronize()
    print(f"{label} warmup: {time.perf_counter() - t0:.2f} s")
    request_ms = []
    ops.reset_launch_counts()
    for i in range(N_REQUESTS):
        ctx = moving_squares(rng, BATCH, n_cond, img, ch)
        before = ops.launch_counts()
        t0 = time.perf_counter()
        out = pred.predict(ctx)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
        if counts != want:
            raise AssertionError(f"{label} {i}: launches {counts}, expected {want}")
        if out.shape != (BATCH, N_PRED, img, img, ch):
            raise AssertionError(f"{label} {i}: output shape {out.shape}")
        if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
            raise AssertionError(f"{label} {i}: output not finite in [0, 1]")
        print(f"{label} {i}: {request_ms[-1]:.1f} ms, launches {counts}, "
              f"mean {out.mean():.4f}, std {out.std():.4f}")
    launches = ops.launch_counts()
    med = statistics.median(request_ms)
    print(f"{label}: median {med:.1f} ms per request of {BATCH} sequences "
          f"({n_cond} context, {N_PRED} predicted frames) on {card}")
    record.update(request_ms=request_ms, median_request_ms=med,
                  launches_per_request=want)
    prof = profile_call(lambda: pred.predict(ctx), med)
    record["profile"] = prof
    print_profile(label, prof)
    return launches


def rollout_card_vs_cpu(model, rng, record, relative=False):
    """The rollout on the card against the CPU, same weights and noise: B=2,
    3 context, 2 predicted frames; max |err| per frame within the absolute
    tolerances, or with ``relative`` within the relative ones times
    1 + max|x|."""
    from recurrent_flows_tpu_torch.utils import NoiseSource

    cfg = model.cfg
    x = torch.tensor(moving_squares(rng, 2, 3, cfg.image_size, cfg.x_channels) - 0.5)
    cpu_model = copy.deepcopy(model).cpu()
    rec = RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(3)))
    _, p_cpu = cpu_model.predict(x, 2, 3, rec)
    _, p_gpu = model.predict(x.cuda(), 2, 3, NoiseSource(replay=rec.draws))
    p_gpu = p_gpu.cpu()
    errs = [(p_gpu[t] - p_cpu[t]).abs().max().item() for t in range(2)]
    scale = 1.0 + p_cpu.abs().max().item()
    tols = ((TOL_FIRST_FRAME_REL * scale, TOL_LATER_FRAMES_REL * scale) if relative
            else (TOL_FIRST_FRAME, TOL_LATER_FRAMES))
    print(f"card vs CPU rollout: max |err| per predicted frame {errs} (limits {tols}), "
          f"max |x| {scale - 1:.3f}")
    record["card_vs_cpu_err"] = errs
    if not (torch.isfinite(p_gpu).all() and errs[0] <= tols[0] and errs[1] <= tols[1]):
        raise AssertionError(f"card and CPU rollouts disagree: {errs}")


def print_profile(what, prof):
    kinds = ", ".join(f"{k} {v['ms']:.1f} ms ({v['n']})" for k, v in
                      sorted(prof["by_kind"].items(), key=lambda kv: -kv[1]["ms"]))
    print(f"profiled {what}: device busy {prof['device_busy_ms']:.1f} ms "
          f"in {prof['n_kernels']} kernels, wall {prof['wall_ms']:.1f} ms "
          f"(idle share {prof['idle_share_profiled']:.2f}; "
          f"{prof['idle_share_of_median']:.2f} of the unprofiled median); "
          f"by kind: {kinds}")


def train_launches(mcfg, config: str, remat: bool, frames: int, kernel_scales,
                   folded: bool = True) -> dict:
    """Launches of one train step over ``frames`` + 1 frames. The h-LSTM runs
    once per input frame. Each of the per-frame steps runs L·K GlowSteps;
    with recomputation its forward runs twice (once in the forward pass,
    once replayed in the backward), so the flow's forward launches double.
    ``kernel_scales`` are the scales configurations B and C send to their
    kernel; ``folded`` is False where the step norm is a BatchNormFlow (no
    folded 1x1)."""
    passes = 2 if remat else 1
    n_kernel = len(kernel_scales) if config in ("B", "C") else 0
    module_steps = mcfg.K * (mcfg.L - n_kernel)
    return dict(
        actnorm_invconv=frames * passes * module_steps if folded else 0,
        convlstm_gates=frames,
        coupling_transform=frames * passes * module_steps,
        glowchain=frames * passes * n_kernel if config == "C" else 0,
        glowstep=frames * passes * n_kernel * mcfg.K if config == "B" else 0)


def train(mcfg, tcfg, rng, record, card, kernel_scales, steps_a=TRAIN_STEPS_A,
          label="train"):
    """Trainer.build and train steps of configurations A (``steps_a`` of
    them, then one without recomputation for the peak memory, and one
    profiled), B and C (one each), with exact launch counts. Returns the
    summed launches of the counted steps."""
    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.flows.glow import kernel_fits
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.training import Trainer

    configs = dict(A=mcfg, B=with_glow(mcfg, coupling_impl="fused"),
                   C=with_glow(mcfg, chain_impl="all"))
    batches = [moving_squares(rng, tcfg.batch_size, tcfg.n_frames, mcfg.image_size,
                              mcfg.x_channels) for _ in range(steps_a)]
    total = dict.fromkeys(ops.launch_counts(), 0)
    record["train"] = {}
    for name, cfg in configs.items():
        model = RFN(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        perturb_(model, seed=1)
        t0 = time.perf_counter()
        trainer = Trainer(model, tcfg, batches).build()
        torch.cuda.synchronize()
        print(f"{label} {name}: build with data-dependent init {time.perf_counter() - t0:.2f} s")
        steps = []
        if name != "A":
            eligible = {l for l, (hw, c, cc) in enumerate(model.flow.scale_shapes)
                        if kernel_fits(cfg.glow, tcfg.batch_size, hw, hw, c, cc)}
            if eligible != set(kernel_scales):
                raise AssertionError(f"{label} {name}: the gates send scales "
                                     f"{sorted(eligible)} to the kernel, expected "
                                     f"{sorted(kernel_scales)}")

        def one_step(batch, remat=True, count=True):
            model.remat = remat
            want = train_launches(mcfg, name, remat, tcfg.n_frames - 1, kernel_scales)
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = {k: float(v) for k, v in trainer.train_step(
                batch, beta=tcfg.beta_min, lr=tcfg.learning_rate).items()}
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            if counts != want:
                raise AssertionError(f"{label} {name}: launches {counts}, expected {want}")
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"{label} {name}: metrics not finite: {m}")
            if count:
                for k, v in counts.items():
                    total[k] += v
            gib = torch.cuda.max_memory_allocated() / 2**30
            steps.append(dict(remat=remat, ms=ms, peak_gib=gib, launches=counts, **m))
            print(f"{label} {name} step {len(steps) - 1} (remat={remat}): {ms:.1f} ms, "
                  f"peak {gib:.2f} GiB, loss {m['loss']:.1f} = nll {m['nll']:.1f} + "
                  f"beta·kl (kl {m['kl']:.2f}), {m['bits']:.4f} bits/dim, launches {counts}")

        for batch in batches[:steps_a if name == "A" else 1]:
            one_step(batch)
        if name == "A":
            one_step(batches[0], remat=False, count=False)
            model.remat = True
            med = statistics.median(s["ms"] for s in steps[1:steps_a])
            prof = profile_call(lambda: trainer.train_step(
                batches[1], beta=tcfg.beta_min, lr=tcfg.learning_rate), med)
            record["train_profile"] = prof
            print_profile(f"{label} step A", prof)
        record["train"][name] = steps
        del trainer, model
        torch.cuda.empty_cache()
    print(f"{label}: {tcfg.batch_size} sequences of {tcfg.n_frames} frames per step on {card}")
    return total


def train_card_vs_cpu(mcfg, tcfg, rng, record, direct, stream, batch_size=2):
    """One train step's loss and the ``direct`` and ``stream`` named
    gradients (see the tolerances), card against CPU: B=2 (or
    ``batch_size``), 3 frames."""
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.training import Trainer
    from recurrent_flows_tpu_torch.utils import NoiseSource, float32_precision

    batch = moving_squares(rng, batch_size, 3, mcfg.image_size, mcfg.x_channels)
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
    return gpu


# the named gradients of the card-vs-CPU train step: parameters with a direct
# term in the objective, and parameters reached only through the flow's stream
MNIST_GRADS = (
    ["flow.scale0_step9.affine.net2.conv.kernel", "flow.scale4_step0.affine.net0.conv.kernel",
     "flow.scale4_step9.affine.scale", "flow.split1.conv.conv.kernel",
     "flow.prior_out.conv.kernel", "prior.param_conv.kernel"],
    ["flow.scale0_step0.invconv.lower", "flow.scale2_step5.norm.logs",
     "lstm.gates.kernel", "lstm.Wci", "extractor.b0_1.kernel",
     "upscaler.b4_2.kernel", "encoder.param_conv.kernel", "z_0x"])
# At rfn_bair the first step of the last scale is a stream parameter: its
# gradient passes the scale's 9 later steps, and on random weights the last
# scale's values reach ~1e3; its card-vs-CPU error was 3.2e-3 of its largest
# entry in this script's runs, where rfn_mnist_production's scale4_step0
# gives 1.8e-5, and the plain versions on the card differ from the CPU
# alike (scripts/torch_conditioning.py --card). The last step of the last
# scale feeds only the base prior.
BAIR_GRADS = (
    ["flow.scale0_step9.affine.net2.conv.kernel", "flow.scale3_step9.affine.net0.conv.kernel",
     "flow.scale3_step9.affine.scale", "flow.split1.conv.conv.kernel",
     "flow.prior_out.conv.kernel", "prior.param_conv.kernel"],
    ["flow.scale0_step0.invconv.lower", "flow.scale2_step5.norm.logs",
     "flow.scale3_step0.affine.net0.conv.kernel",
     "lstm.gates.kernel", "lstm.Wci", "extractor.b0_1.kernel",
     "upscaler.b3_2.kernel", "encoder.param_conv.kernel", "z_0x"])
BN_GRADS = (
    ["flow.scale0_step9.affine.net2.conv.kernel", "flow.scale3_step9.affine.net0.conv.kernel",
     "flow.scale3_step9.affine.scale", "flow.split1.conv.conv.kernel",
     "flow.prior_out.conv.kernel", "prior.param_conv.kernel"],
    ["flow.scale0_step0.invconv.weight", "flow.scale2_step5.norm.log_gamma",
     "flow.scale3_step0.affine.net0.conv.kernel",
     "lstm.gates.kernel", "lstm.Wci", "extractor.b0_1.kernel",
     "upscaler.b3_2.kernel", "encoder.param_conv.kernel", "z_0x"])


# The batch-norm variant's train step is held card against CPU at B=8, not
# 2: a BatchNormFlow normalises each position over the batch, and over 2
# samples a position where both agree (the squares overlap) has a variance
# near eps, so the loss and its gradients are ill-conditioned in float32.
# scripts/torch_conditioning.py measures it: at a reduced width on the CPU,
# float32 against float64 gradients differ by a median 8.5e-4 of the
# largest entry at B=2, 1.4e-4 at B=4 and 2e-6 at B=8; with --card, at
# full width and B=2, the card's gradients differ from the CPU's by up to
# 14 times their largest entries through the kernels and 52 times through
# the plain versions.
BN_CARD_VS_CPU_BATCH = 8


def bair(rng, record, card):
    """rfn_bair at full width: serving (chain_impl='sample') and training in
    configurations A, B, C, then card against CPU. Returns
    {path: launches}."""
    from recurrent_flows_tpu_torch.config import rfn_bair
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.training import Trainer

    mcfg, tcfg = rfn_bair()
    model = RFN(with_glow(mcfg, chain_impl="sample"), device="cuda",
                generator=torch.Generator().manual_seed(0))
    perturb_(model, seed=1)
    print(f"model: rfn_bair, {sum(p.numel() for p in model.parameters())} parameters")
    t0 = time.perf_counter()
    Trainer(model, tcfg, [moving_squares(rng, tcfg.batch_size, 2, mcfg.image_size, 3)]).build()
    torch.cuda.synchronize()
    print(f"bair: build with data-dependent init {time.perf_counter() - t0:.2f} s")
    chain = sorted(model.flow.prepare_chain(BATCH))
    if chain != BAIR_KERNEL_SCALES:
        raise AssertionError(f"bair: chain scales {chain}, expected {BAIR_KERNEL_SCALES}")
    record["serve"] = {}
    launches = {"bair_serve": serve(
        model, mcfg, tcfg, rng, record["serve"], card,
        request_launches(mcfg, BAIR_KERNEL_SCALES, BAIR_N_COND), BAIR_N_COND,
        label="bair request")}
    rollout_card_vs_cpu(model, rng, record["serve"], relative=True)
    del model
    torch.cuda.empty_cache()
    launches["bair_train"] = train(mcfg, tcfg, rng, record, card, BAIR_KERNEL_SCALES,
                                   label="bair train")
    train_card_vs_cpu(mcfg, tcfg, rng, record, *BAIR_GRADS)
    return launches


def kth_batchnorm(rng, record, card):
    """The batch-norm variant of rfn_kth at full width: build, 2 train steps
    that move no running buffer, refresh_stats that moves them, a request
    with eval_norm, then the train step and the rollout card against CPU.
    Returns {path: launches}."""
    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.config import rfn_kth
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.training import Trainer

    mcfg, tcfg = rfn_kth()
    mcfg = dataclasses.replace(with_glow(mcfg, flow_norm="batchnorm", base_norm="batchnorm",
                                         lu_decomposed=False), track_running_stats=True)
    model = RFN(mcfg, device="cuda", generator=torch.Generator().manual_seed(0))
    perturb_(model, seed=1)
    batches = [moving_squares(rng, tcfg.batch_size, tcfg.n_frames, mcfg.image_size)
               for _ in range(3)]
    t0 = time.perf_counter()
    trainer = Trainer(model, tcfg, batches).build()
    torch.cuda.synchronize()
    print(f"kth batchnorm: build (init pass + data-dependent init) "
          f"{time.perf_counter() - t0:.2f} s")
    buffers = lambda: {n: b.clone() for n, b in model.named_buffers()}
    start = buffers()
    if not start or any(torch.equal(start[n], torch.ones_like(start[n]))
                        for n in start if n.startswith("flow.") and "running_var" in n):
        raise AssertionError("kth batchnorm: build left a flow running variance at 1")
    want = train_launches(mcfg, "A", True, tcfg.n_frames - 1, (), folded=False)
    total = dict.fromkeys(ops.launch_counts(), 0)
    steps = []
    for batch in batches[:2]:
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in trainer.train_step(
            batch, beta=tcfg.beta_min, lr=tcfg.learning_rate).items()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        if counts != want:
            raise AssertionError(f"kth batchnorm train: launches {counts}, expected {want}")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"kth batchnorm train: metrics not finite: {m}")
        for k, v in counts.items():
            total[k] += v
        gib = torch.cuda.max_memory_allocated() / 2**30
        steps.append(dict(ms=ms, peak_gib=gib, launches=counts, **m))
        print(f"kth batchnorm train step {len(steps) - 1}: {ms:.1f} ms, peak {gib:.2f} GiB, "
              f"loss {m['loss']:.1f}, launches {counts}")
    moved = [n for n, b in model.named_buffers() if not torch.equal(b, start[n])]
    if moved:
        raise AssertionError(f"kth batchnorm: train steps moved running buffers {moved[:5]}")
    trainer.refresh_stats()
    torch.cuda.synchronize()
    after = buffers()
    moved = {n for n in after if not torch.equal(after[n], start[n])}
    for prefix in ("flow.", "extractor.", "upscaler."):
        if not any(n.startswith(prefix) for n in moved):
            raise AssertionError(f"kth batchnorm: refresh_stats moved no {prefix} buffer")
    print(f"kth batchnorm: train steps moved no running buffer; refresh_stats moved "
          f"{len(moved)} of {len(after)}")
    record["train"] = steps
    record["refresh_moved"] = len(moved)
    model.eval_norm = True
    record["serve"] = {}
    launches = {"kth_bn_train": total, "kth_bn_serve": serve(
        model, mcfg, tcfg, rng, record["serve"], card,
        request_launches(mcfg, (), BAIR_N_COND), BAIR_N_COND,
        label="kth batchnorm request (eval_norm)")}
    rollout_card_vs_cpu(model, rng, record["serve"], relative=True)
    del trainer, model
    torch.cuda.empty_cache()
    train_card_vs_cpu(mcfg, tcfg, rng, record, *BN_GRADS, batch_size=BN_CARD_VS_CPU_BATCH)
    return launches


def reconstruct_launches(mcfg, chain_scales, frames: int) -> dict:
    """Launches of one reconstruct over ``frames`` frames: the h-LSTM once
    per frame but the last; per reconstructed frame the forward log_prob
    (every scale on the module path: L·K folded 1x1s and coupling tails)
    and two reverses (recons_flow given z, recons from the base), each one
    glowchain per chain scale and K coupling tails per other scale."""
    steps = frames - 1
    reverse_coupling = mcfg.K * (mcfg.L - len(chain_scales))
    return dict(actnorm_invconv=steps * mcfg.L * mcfg.K, convlstm_gates=steps,
                coupling_transform=steps * (mcfg.L * mcfg.K + 2 * reverse_coupling),
                glowchain=steps * 2 * len(chain_scales), glowstep=0)


def sample_launches(mcfg, chain_scales, frames: int) -> dict:
    """Launches of one sample request of ``frames`` frames: per frame the
    LSTM once and one reverse flow."""
    return dict(actnorm_invconv=0, convlstm_gates=frames,
                coupling_transform=frames * mcfg.K * (mcfg.L - len(chain_scales)),
                glowchain=frames * len(chain_scales), glowstep=0)


def diagnostics_launches(mcfg, chain_scales, frames: int, n_cond: int) -> dict:
    """Launches of param_analysis and reconstruct_elbo_gap over ``frames``
    frames and probability_future with ``n_cond`` context frames: each
    scans the h-LSTM over its frames but the last; per frame
    param_analysis samples once, reconstruct_elbo_gap takes the forward
    log_prob and two reverses for each of the two latents, and
    probability_future takes the forward log_prob of each future frame
    for each latent."""
    steps = frames - 1
    fwd = mcfg.L * mcfg.K
    rev = mcfg.K * (mcfg.L - len(chain_scales))
    chains = len(chain_scales)
    futures = frames - n_cond
    return dict(
        actnorm_invconv=steps * 2 * fwd + 2 * futures * fwd,
        convlstm_gates=2 * steps + n_cond - 1,
        coupling_transform=steps * rev + steps * 2 * (fwd + 2 * rev) + 2 * futures * fwd,
        glowchain=steps * chains + steps * 2 * 2 * chains, glowstep=0)


def launched(fn):
    """(fn(), the launches it made)."""
    from recurrent_flows_tpu_torch import ops

    before = ops.launch_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in ops.launch_counts().items()}


def counted(label, fn, want):
    """Call ``fn`` and check the launches it made against ``want``."""
    out, counts = launched(fn)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return out


def check_plots(label, workdir, printed: str, n_files: int) -> dict:
    """``fit``'s plots in ``workdir/png_folder``: ``losses.png`` and
    ``samples0.png`` decode with ``read_png`` (and ``n_files`` PNGs are
    there), and ``fit`` printed no plot failure. Returns their shapes."""
    from recurrent_flows_tpu_torch.data.png import read_png

    png = Path(workdir) / "png_folder"
    files = sorted(p.name for p in png.glob("*.png")) if png.is_dir() else []
    if "plotter failed" in printed or len(files) != n_files:
        raise AssertionError(f"{label}: plots {files}, expected {n_files}; printed "
                             f"{[l for l in printed.splitlines() if 'plotter' in l]}")
    shapes = {name: list(read_png(str(png / name)).shape)
              for name in ("losses.png", "samples0.png")}
    print(f"{label}: plots {files} written, {shapes}")
    return shapes


def check_frames(label, out, shape):
    if out.shape != shape:
        raise AssertionError(f"{label}: output shape {out.shape}, expected {shape}")
    if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"{label}: output not finite in [0, 1]")


def sample_max(model, x) -> float:
    """Largest |x| in model space of a 2-frame ``RFN.sample`` seeded by
    frame 0 of x, on fixed noise."""
    from recurrent_flows_tpu_torch.utils import NoiseSource

    noise = NoiseSource(generator=torch.Generator(device=x.device).manual_seed(5))
    return model.sample(x, 2, noise).abs().max().item()


def lifecycle_card_vs_cpu(model, rng) -> dict:
    """``reconstruct``, ``sample`` (2 frames) and ``probability_future``
    (2 context frames) of a model on the card against its CPU copy, with
    the same injected noise, on 2 sequences of 3 frames of moving squares:
    per output {max_abs_err, rel_err (the largest |err|/(1+|ref|) over
    elements), max_abs_ref}; the sample per frame (sample0, sample1)."""
    from recurrent_flows_tpu_torch.utils import NoiseSource

    cpu_model = copy.deepcopy(model).cpu()
    x = torch.tensor(moving_squares(rng, 2, 3, model.cfg.image_size) - 0.5)
    errs = {}
    for name, fn in (("reconstruct", lambda m, xx, n: m.reconstruct(xx, n)),
                     ("sample", lambda m, xx, n: (m.sample(xx, 2, n),)),
                     ("probability_future", lambda m, xx, n: (m.probability_future(xx, 2, n),))):
        rec = RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(11)))
        ref = fn(cpu_model, x, rec)
        got = [g.cpu() for g in fn(model, x.cuda(), NoiseSource(replay=rec.draws))]
        if name == "reconstruct":
            pairs = dict(zip(("recons", "recons_flow"), zip(got, ref)))
        elif name == "sample":
            pairs = {f"sample{i}": (got[0][i], ref[0][i]) for i in range(2)}
        else:
            pairs = {name: (got[0], ref[0])}
        for key, (g, r) in pairs.items():
            errs[key] = dict(zip(("max_abs_err", "rel_err"), rel_err(g, r)),
                             max_abs_ref=r.abs().max().item())
    return errs


def lifecycle(rng, record, card):
    """Phase 11: RFN's lifecycle at rfn_mnist_production, on the card's
    Moving MNIST (see the module docstring). Returns {path: launches}."""
    import shutil

    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.config import rfn_mnist_production
    from recurrent_flows_tpu_torch.data import MovingMNIST
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.serving import Predictor
    from recurrent_flows_tpu_torch.training import Trainer
    from recurrent_flows_tpu_torch.utils import NoiseSource

    mcfg, tcfg = rfn_mnist_production()
    mcfg = with_glow(mcfg, chain_impl="sample")
    tcfg = dataclasses.replace(tcfg, steps_per_epoch=FIT_STEPS)
    chain_scales = range(1, mcfg.L)
    paths = {}

    # the data, made on the card
    data = MovingMNIST(digit_bank="synthetic", digit_size=32, num_digits=2,
                       seq_len=tcfg.n_frames)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = data.sample(gen, tcfg.batch_size)
    shape = (tcfg.batch_size, tcfg.n_frames, mcfg.image_size, mcfg.image_size, 1)
    if not (batch.is_cuda and tuple(batch.shape) == shape and batch.min() >= 0.0
            and batch.max() <= 1.0 and batch.max() > 0.5):
        raise AssertionError(f"MovingMNIST: batch on {batch.device}, shape "
                             f"{tuple(batch.shape)}, range [{batch.min()}, {batch.max()}]")
    host_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        data.sample(gen, tcfg.batch_size)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    prof = profile_call(lambda: data.sample(gen, tcfg.batch_size), statistics.median(host_ms))
    record["moving_mnist"] = dict(host_ms=host_ms, device_busy_ms=prof["device_busy_ms"],
                                  n_kernels=prof["n_kernels"])
    print(f"MovingMNIST: {tcfg.batch_size} sequences of {tcfg.n_frames} frames on the "
          f"card, median {statistics.median(host_ms):.2f} ms, device busy "
          f"{prof['device_busy_ms']:.3f} ms in {prof['n_kernels']} kernels")

    # fit: build, 2 epochs of 2 steps, the checkpoint 'last', status
    workdir = ROOT / "runs" / "chip_smoke_lifecycle"
    shutil.rmtree(workdir, ignore_errors=True)
    model = RFN(mcfg, device="cuda", generator=torch.Generator().manual_seed(0))
    perturb_(model, seed=1)
    trainer = Trainer(model, tcfg, data, str(workdir))
    # the size of a flow sample in model space (data in [-0.5, 0.5]) on the
    # perturbed random weights, after the data-dependent init, after fit
    xm = trainer._to_model_space(data.sample(gen, BATCH))
    magnitude = {"random": sample_max(model, xm)}
    t0 = time.perf_counter()
    trainer.build()
    torch.cuda.synchronize()
    print(f"fit: build with data-dependent init {time.perf_counter() - t0:.2f} s")
    magnitude["after_init"] = sample_max(model, xm)
    want = train_launches(mcfg, "A", True, tcfg.n_frames - 1, ())
    step = trainer.train_step
    trainer.train_step = lambda *a, **k: counted("fit step", lambda: step(*a, **k), want)
    step_counts = []

    def counted_step(*a, **k):
        out, counts = launched(lambda: step(*a, **k))
        if counts != want:
            raise AssertionError(f"fit step: launches {counts}, expected {want}")
        step_counts.append(counts)
        return out

    trainer.train_step = counted_step
    printed = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        trainer.fit(n_epochs=FIT_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    # the steps' launches; the rest are the plots' (plot_rows each epoch)
    paths["mnist_fit"] = add(*step_counts)
    record["fit_plot_launches"] = {k: v - paths["mnist_fit"][k]
                                   for k, v in ops.launch_counts().items()}
    del trainer.train_step
    record["fit_plots"] = check_plots("fit", workdir, printed.getvalue(), 1 + FIT_EPOCHS)
    folder = workdir / "model_folder"
    n_steps = FIT_EPOCHS * FIT_STEPS
    status = (folder / "status.txt").read_text().splitlines()
    metrics = [json.loads(r) for r in (folder / "metrics.jsonl").read_text().splitlines()]
    saved = sorted(p.name for p in (folder / "last").iterdir())
    if not (len(trainer.losses) == n_steps and np.isfinite(trainer.losses).all()
            and len(status) == len(metrics) == FIT_EPOCHS and saved == ["meta.json", "state.pt"]
            and paths["mnist_fit"] == {k: n_steps * v for k, v in want.items()}):
        raise AssertionError(f"fit: losses {trainer.losses}, {len(status)} status lines, "
                             f"{len(metrics)} records, last holds {saved}, "
                             f"launches {paths['mnist_fit']}")
    print(f"fit: {FIT_EPOCHS} epochs of {FIT_STEPS} steps in {fit_s:.1f} s, losses "
          f"{[round(v, 2) for v in trainer.losses]}, launches per step {want}; "
          f"status: {status[-1]}")
    record["fit"] = dict(seconds=fit_s, losses=trainer.losses, status=status,
                         steps_per_s=metrics[-1]["step_stats"].get("steps_per_s"))
    t0 = time.perf_counter()
    rows = trainer.plot_rows()
    torch.cuda.synchronize()
    lengths = {"true": tcfg.n_frames, "sample|frame0": tcfg.n_frames,
               "prediction": tcfg.n_conditions + tcfg.n_predictions,
               "recon": tcfg.n_frames - 1, "recon-bijection": tcfg.n_frames - 1}
    for name, arr in rows:
        if arr.dtype != np.uint8 or arr.shape != (lengths[name],) + shape[:1] + shape[2:]:
            raise AssertionError(f"plot rows: {name} {arr.dtype} {arr.shape}")
    print(f"plot rows (predict, reconstruct, sample of {tcfg.batch_size}): "
          f"{time.perf_counter() - t0:.2f} s, {[n for n, _ in rows]}")

    # load into a fresh trainer: bit for bit, then one more step
    fresh = Trainer(RFN(mcfg, device="cuda", generator=torch.Generator().manual_seed(7)),
                    tcfg, data, str(workdir)).load("last")
    a, b = trainer.model.state_dict(), fresh.model.state_dict()
    sa, sb = trainer.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    unequal = [n for n in a if not torch.equal(a[n], b[n])]
    unequal += [f"adam {i} {k}" for i in sa for k in sa[i]
                if not torch.equal(sa[i][k].cpu(), sb[i][k].cpu())]
    unequal += [attr for attr in ("counter", "epoch_i", "losses", "kl_hist", "recon_hist",
                                  "bits_hist", "best_loss")
                if getattr(trainer, attr) != getattr(fresh, attr)]
    if unequal or len(sa) != len(sb) or not sa:
        raise AssertionError(f"load: differs from the saved trainer in {unequal[:8]}")
    m = {k: float(v) for k, v in fresh.train_step(data.sample(gen, tcfg.batch_size),
                                                  tcfg.beta_min, tcfg.learning_rate).items()}
    if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"load: the step after loading is not finite: {m}")
    magnitude["after_fit"] = sample_max(trainer.model, xm)
    record["sample_max_abs"] = magnitude
    print(f"largest |x| of a 2-frame sample of {BATCH} in model space: "
          + ", ".join(f"{k} {v:.3f}" for k, v in magnitude.items()))
    print(f"load: {len(a)} tensors and {len(sa)} Adam states bit-equal, counter "
          f"{fresh.counter}; the next step's loss {m['loss']:.1f}")
    del trainer, fresh, model
    torch.cuda.empty_cache()

    # serving from the checkpoint
    pred = Predictor.from_checkpoint(str(folder / "last"), n_conditions=N_COND,
                                     n_predictions=N_PRED)
    pred.warmup(batch_size=BATCH)
    frames = lambda t: data.sample(gen, BATCH)[:, :t].cpu().numpy()
    img = (mcfg.image_size, mcfg.image_size, 1)
    endpoints = {
        "predict": (lambda x: pred.predict(x), N_COND,
                    request_launches(mcfg, chain_scales, N_COND), (BATCH, N_PRED) + img),
        "reconstruct": (lambda x: pred.reconstruct(x), LIFE_FRAMES,
                        reconstruct_launches(mcfg, chain_scales, LIFE_FRAMES),
                        (BATCH, LIFE_FRAMES - 1) + img),
        "sample": (lambda x: pred.sample(x[:, 0], LIFE_FRAMES), 1,
                   sample_launches(mcfg, chain_scales, LIFE_FRAMES),
                   (BATCH, LIFE_FRAMES) + img)}
    record["serve"] = {}
    for name, (call, t, want, out_shape) in endpoints.items():
        ops.reset_launch_counts()
        times = []
        for i in range(N_REQUESTS):
            x = frames(t)
            t0 = time.perf_counter()
            out = counted(f"{name} request {i}", lambda: call(x), want)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check_frames(f"{name} request {i}", out, out_shape)
        paths[f"mnist_{name}"] = ops.launch_counts()
        med = statistics.median(times)
        record["serve"][name] = dict(ms=times, median_ms=med, launches_per_request=want)
        print(f"checkpoint {name}: median {med:.1f} ms per request of {BATCH} "
              f"({times}), launches {want}")
    x = frames(LIFE_FRAMES)
    prof = profile_call(lambda: pred.reconstruct(x), record["serve"]["reconstruct"]["median_ms"])
    record["serve"]["reconstruct"]["profile"] = prof
    print_profile("reconstruct request", prof)
    missing = [k for k in ("convlstm_gates", "actnorm_invconv", "coupling_transform",
                           "glowchain") if paths["mnist_reconstruct"][k] == 0]
    if missing:
        raise AssertionError(f"reconstruct never launched {missing}")

    # card against CPU, the same weights and injected noise, each element
    # against 1 + its |ref| (TOL_LIFE_*): recons and the first sampled frame
    # pass the flow once, as the first predicted frame does; recons_flow
    # passes it twice (log_prob, then the reverse), the second sampled frame
    # feeds the first back; probability_future as the train step's loss
    model = pred.model
    tol = dict(recons=TOL_LIFE_ONCE, recons_flow=TOL_LIFE_TWICE,
               sample0=TOL_LIFE_ONCE, sample1=TOL_LIFE_TWICE,
               probability_future=TOL_STEP_LOSS)
    errs = lifecycle_card_vs_cpu(model, rng)
    for key, v in errs.items():
        v["limit"] = tol[key]
    bad = {k: v for k, v in errs.items() if not v["rel_err"] <= v["limit"]}
    print("card vs CPU (max |err|; max |err|/(1+|ref|) and its limit; max |ref|): "
          + ", ".join(f"{k} {v['max_abs_err']:.2e}; {v['rel_err']:.2e} ({v['limit']:.0e}); "
                      f"{v['max_abs_ref']:.1f}" for k, v in errs.items()))
    record["card_vs_cpu"] = errs
    if bad:
        raise AssertionError(f"card and CPU disagree: {bad}")

    # the diagnostics on the card
    xb = pred._to_model_space(frames(LIFE_FRAMES))
    noise = NoiseSource(generator=gen)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pa = model.param_analysis(xb, noise)
    pf = model.probability_future(xb, N_COND, noise)
    gap = model.reconstruct_elbo_gap(xb, noise)
    torch.cuda.synchronize()
    diag_s = time.perf_counter() - t0
    paths["mnist_diagnostics"] = ops.launch_counts()
    want = diagnostics_launches(mcfg, chain_scales, LIFE_FRAMES, N_COND)
    t1 = LIFE_FRAMES - 1
    shapes = {"mu_p": (t1, BATCH, 2, 2, mcfg.z_dim), "std_flow": (t1, BATCH, 2, 2, 64),
              "predictions": (t1, BATCH) + img, "probability_future":
              (BATCH, 2, LIFE_FRAMES - N_COND), "recons": (t1, 2, BATCH) + img,
              "kld": (t1, BATCH), "nll": (2, t1, BATCH)}
    got = dict(mu_p=pa["mu_p"], std_flow=pa["std_flow"], predictions=pa["predictions"],
               probability_future=pf, recons=gap[0], kld=gap[2], nll=gap[3])
    bad = {k: tuple(v.shape) for k, v in got.items()
           if tuple(v.shape) != shapes[k] or not torch.isfinite(v).all()}
    if bad or paths["mnist_diagnostics"] != want:
        raise AssertionError(f"diagnostics: shapes or values {bad}; launches "
                             f"{paths['mnist_diagnostics']}, expected {want}")
    print(f"diagnostics (param_analysis, probability_future, reconstruct_elbo_gap) "
          f"of {BATCH} sequences of {LIFE_FRAMES} frames: {diag_s:.2f} s, launches {want}")
    record["diagnostics_s"] = diag_s
    del pred, model
    torch.cuda.empty_cache()
    return paths


# phase 12: SRNN, VRNN and SVG at their presets (64x64 gray, B=32, T=10).
# The gates at h = 256 on 8x8 maps: the train step's B=32 and the request's
# B=8 (SRNN's lstm_h and lstm_a, VRNN's lstm)
FAMILY_GATES = [(32, 8, 8, 256), (BATCH, 8, 8, 256)]
FAMILY_STEPS = 2
# card vs CPU at B=2 (4 frames; predict: 2 context, 2 predicted; the IW-ELBO
# with K=3), the same weights and replayed noise. The loss pieces and the
# IW-ELBO are sums over 3x64x64 pixels, each within tol·(1+|ref|); the
# predicted frames are probabilities or sigmoids in [0, 1], each element
# within an absolute tol. In this script's first four runs on the card
# (H100 700 W) the sums differed by at most 1.8e-6 of 1+|ref| (SVG's kl)
# and the frames by 7.5e-6: these limits hold them with a margin of 5.5x
# and 13x
TOL_FAMILY_SUM = 1e-5
TOL_FAMILY_FRAME = 1e-4


def check_family_gates(record) -> dict:
    """The gates kernel against its plain version at FAMILY_GATES, within
    TOL_ELEMENTWISE, repeating bit for bit; device times out of L2 (cold_ms,
    the kernel's also warm: warm_ms) beside the plain version's and the
    bound. Returns the worst error and the rows."""
    from recurrent_flows_tpu_torch.ops import convlstm_gates, convlstm_gates_ref, gates_plan

    g = torch.Generator(device="cuda").manual_seed(12)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale
    rows, worst = [], 0.0
    for b, h, w, hc in FAMILY_GATES:
        gates, c = rnd(b, h, w, 4 * hc), rnd(b, h, w, hc)
        peeps = [rnd(1, h, w, hc, scale=0.1) for _ in range(3)]
        name = f"convlstm_gates [{b},{h},{w},{4 * hc}]"
        e = check_elementwise(name, convlstm_gates(gates, c, *peeps),
                              convlstm_gates_ref(gates, c, *peeps), (TOL_ELEMENTWISE,) * 2)
        check_repeats(name, lambda: convlstm_gates(gates, c, *peeps))
        plan = gates_plan(b, h * w, hc)
        n_bytes = nbytes(gates, c, *peeps, c, c)
        # timed cold, as the bound assumes: one copy (14.9 MB at B=32) would
        # stay in L2 from one replayed call to the next
        fresh = lambda: (gates.clone(), c.clone(), *(p.clone() for p in peeps))
        times = gates_times(convlstm_gates, gates, c, peeps)
        row = dict(shape=list(gates.shape), plan=plan._asdict(), err=e,
                   warm_ms=times.pop("ms"), **times,
                   ms=cold_ms(convlstm_gates, fresh, n_bytes),
                   plain_ms=cold_ms(convlstm_gates_ref, fresh, n_bytes),
                   n_bytes=n_bytes, flops=25 * c.numel(), **bound(n_bytes, 25 * c.numel()))
        if row["ms"] < row["bound_ms"]:
            raise AssertionError(f"{name}: {row['ms']:.6f} ms cold, under its bound of "
                                 f"{row['bound_ms']:.6f} ms: the timing is not cold")
        rows.append(row)
        worst = max(worst, e)
        print(f"{name}: plan {plan.blocks} blocks of {plan.threads} threads, err {e:.3e}, "
              f"{row['ms']:.5f} ms cold ({row['warm_ms']:.5f} warm in L2), plain "
              f"{row['plain_ms']:.5f} cold, bound "
              f"{row['bound_ms']:.6f} ({row['bound_by']}), in-place add {row['add_ms']:.5f}, "
              f"host {row['host_us']:.1f} us per eager call")
    record["gates"] = rows
    return dict(max_abs_err=worst, rows=rows)


def family_launches(name: str, path: str, frames: int) -> dict:
    """convlstm_gates launches of one call of ``path`` over ``frames`` frames
    (the only kernel these families run; SVG runs none). A train step: SRNN's
    lstm_h and lstm_a scan the frames-1 transitions once each, outside the
    recomputed per-frame steps; VRNN's lstm runs inside them, so the
    recomputation launches it a second time in the backward. ``predict``
    (``frames`` predicted): the h-LSTM over the N_COND-1 context transitions,
    then once per predicted frame; ``reconstruct``: SRNN's two LSTMs and
    VRNN's one per transition; ``sample``: once per frame."""
    if name == "svg_mnist":
        n = 0
    elif path == "predict":
        n = N_COND - 1 + frames
    elif path == "sample":
        n = frames
    else:
        n = (1 if (name, path) == ("vrnn_mnist", "reconstruct") else 2) * (frames - 1)
    return dict(actnorm_invconv=0, convlstm_gates=n, coupling_transform=0, glowchain=0,
                glowstep=0)


def family_card_vs_cpu(model, x) -> dict:
    """The loss pieces, one ``predict`` (2 context, 2 predicted frames) and
    the IW-ELBO (K=3) of ``model`` on the card against its CPU copy, on
    x [2, 4, ...] (model space) with the same injected noise: per output its
    largest |err| (absolute for the frames, over 1+|ref| for the sums)."""
    from recurrent_flows_tpu_torch.utils import NoiseSource

    cpu_model = copy.deepcopy(model).cpu()
    calls = {"loss": lambda m, xx, n: m.loss(xx, n),
             "predict": lambda m, xx, n: {"frames": m.predict(xx, 2, 2, n)[1]},
             "iw_elbo": lambda m, xx, n: {"iw_elbo": m.elbo_importance_weighting(xx, 3, n)}}
    errs = {}
    for name, fn in calls.items():
        rec = RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(13)))
        with torch.no_grad():
            ref = fn(cpu_model, x.cpu(), rec)
            got = fn(model, x, NoiseSource(replay=rec.draws))
        for key, r in ref.items():
            g = got[key].cpu()
            if not torch.isfinite(g).all():
                raise AssertionError(f"card vs CPU {name} {key}: not finite")
            e, rel = rel_err(g, r)
            frame = key == "frames"
            errs[f"{name}.{key}"] = dict(err=e if frame else rel,
                                         limit=TOL_FAMILY_FRAME if frame else TOL_FAMILY_SUM)
    del cpu_model
    return errs


def family(name, record, data, gen) -> dict:
    """Phase 12 for one preset (see the module docstring). Returns {path:
    launches}."""
    import shutil

    from recurrent_flows_tpu_torch import config, models, ops
    from recurrent_flows_tpu_torch.serving import Predictor
    from recurrent_flows_tpu_torch.training import Trainer

    mcfg, tcfg = getattr(config, name)()
    cls = getattr(models, type(mcfg).__name__[:-len("Config")])
    model = cls(mcfg, device="cuda", generator=torch.Generator().manual_seed(0))
    perturb_(model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    workdir = ROOT / "runs" / f"chip_smoke_{name}"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    trainer = Trainer(model, tcfg, data, str(workdir)).build()
    build_s = time.perf_counter() - t0
    paths, steps = {}, []
    want = family_launches(name, "train", tcfg.n_frames)
    batches = [data.sample(gen, tcfg.batch_size) for _ in range(FAMILY_STEPS + 1)]
    ops.reset_launch_counts()
    for batch in batches[:FAMILY_STEPS]:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = counted(f"{name} step", lambda: trainer.train_step(
            batch, beta=tcfg.beta_min, lr=tcfg.learning_rate), want)
        m = {k: float(v) for k, v in m.items()}
        ms = (time.perf_counter() - t0) * 1e3
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name} step: metrics not finite: {m}")
        steps.append(dict(ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30, **m))
        print(f"{name} step {len(steps) - 1}: {ms:.1f} ms, peak {steps[-1]['peak_gib']:.2f} "
              f"GiB, loss {m['loss']:.1f} = nll {m['nll']:.1f} + beta·kl (kl {m['kl']:.2f}), "
              f"{m['bits']:.4f} bits/dim, launches {want}")
    paths[f"{name}_train"] = ops.launch_counts()
    prof = profile_call(lambda: trainer.train_step(batches[-1], beta=tcfg.beta_min,
                                                   lr=tcfg.learning_rate), steps[-1]["ms"])
    print_profile(f"{name} step", prof)
    rec = dict(parameters=n_params, build_s=build_s, steps=steps, step_profile=prof,
               launches_per_step=want)

    # checkpoint -> Predictor.from_checkpoint, bit for bit
    trainer.checkpoint("last")
    folder = workdir / "model_folder" / "last"
    pred = Predictor.from_checkpoint(str(folder), n_conditions=N_COND, n_predictions=N_PRED)
    a, b = trainer.model.state_dict(), pred.model.state_dict()
    unequal = [n for n in a if not torch.equal(a[n], b[n])]
    if unequal or a.keys() != b.keys() or type(pred.model) is not cls:
        raise AssertionError(f"{name}: the served model differs from the saved one in "
                             f"{unequal[:8]}")
    del trainer, model, a, b
    torch.cuda.empty_cache()

    # serving: predict (median of N_REQUESTS after a warm-up), reconstruct, sample
    pred.warmup(batch_size=BATCH)
    frames = lambda t: data.sample(gen, BATCH)[:, :t].cpu().numpy()
    img = (mcfg.image_size, mcfg.image_size, 1)
    endpoints = {
        "predict": (lambda x: pred.predict(x), N_COND,
                    family_launches(name, "predict", N_PRED), (BATCH, N_PRED) + img),
        "reconstruct": (lambda x: pred.reconstruct(x), LIFE_FRAMES,
                        family_launches(name, "reconstruct", LIFE_FRAMES),
                        (BATCH, LIFE_FRAMES - 1) + img),
        "sample": (lambda x: pred.sample(x[:, 0], LIFE_FRAMES), 1,
                   family_launches(name, "sample", LIFE_FRAMES), (BATCH, LIFE_FRAMES) + img)}
    rec["serve"] = {}
    for endpoint, (call, t, want, out_shape) in endpoints.items():
        ops.reset_launch_counts()
        times = []
        for i in range(N_REQUESTS):
            x = frames(t)
            t0 = time.perf_counter()
            out = counted(f"{name} {endpoint} {i}", lambda: call(x), want)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check_frames(f"{name} {endpoint} {i}", out, out_shape)
        paths[f"{name}_{endpoint}"] = ops.launch_counts()
        med = statistics.median(times)
        rec["serve"][endpoint] = dict(ms=times, median_ms=med, launches_per_request=want)
        print(f"{name} {endpoint}: median {med:.1f} ms per request of {BATCH} ({times}), "
              f"launches {want}")
    x = frames(N_COND)
    prof = profile_call(lambda: pred.predict(x), rec["serve"]["predict"]["median_ms"])
    rec["serve"]["predict"]["profile"] = prof
    print_profile(f"{name} predict request", prof)

    # card against CPU on the served model
    xs = pred._to_model_space(data.sample(gen, 2)[:, :4])
    errs = family_card_vs_cpu(pred.model, xs)
    rec["card_vs_cpu"] = errs
    print(f"{name} card vs CPU (err; limit): "
          + ", ".join(f"{k} {v['err']:.2e} ({v['limit']:.0e})" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v["err"] <= v["limit"]}
    if bad:
        raise AssertionError(f"{name}: card and CPU disagree: {bad}")
    record[name] = rec
    del pred
    torch.cuda.empty_cache()
    return paths


def families(record) -> dict:
    """Phase 12: srnn_mnist, vrnn_mnist and svg_mnist on the card's Moving
    MNIST. Returns {path: launches}."""
    from recurrent_flows_tpu_torch.data import MovingMNIST

    data = MovingMNIST(digit_bank="synthetic", digit_size=32, num_digits=2, seq_len=10)
    gen = torch.Generator(device="cuda").manual_seed(12)
    paths = {}
    for name in ("srnn_mnist", "vrnn_mnist", "svg_mnist"):
        t0 = time.perf_counter()
        paths.update(family(name, record, data, gen))
        print(f"{name} done in {time.perf_counter() - t0:.0f} s")
    return paths


# phase 13: the evaluation suite on the card. The eval CLI runs in this
# process on phase 11's and phase 12's `last` checkpoints; the thesis
# protocol at rfn_mnist_production (5 context + 25 predicted frames, 30
# resamples, FVD over 13 with random3d, temperature 0.7) on one batch of 8,
# the default protocol (5 + 10, 5 resamples, one batch of 8) at srnn_mnist.
EVAL_RFN_ARGS = ["--thesis_protocol", "--n_sequences", "8", "--no-debug_plot",
                 "--fvd_embedder", "random3d", "--device", "cuda"]
EVAL_SRNN_ARGS = ["--n_batches", "1", "--batch_size", "8", "--no-debug_plot",
                  "--fvd_embedder", "random3d", "--device", "cuda"]
EVAL_METHODS = ("get_eval_values", "get_loss", "get_fvd_values", "importance_weighted_elbo",
                "probability_future_bpp", "elbo_gap")
# the keys of the JAX CLI's evaluations.json (recurrent_flows_tpu/cli/
# eval_settings.py and Evaluator.get_eval_values) with --no-debug_plot
EVAL_KEYS = ({"bits_per_dim", "n_sequences", "dataset_bpd", "fvd", "_meta"}
             | {f"{m}_{s}" for m in ("ssim", "psnr", "mse", "lpips")
                for s in ("best", "mean", "best_summary")})
EVAL_KEYS_RFN = EVAL_KEYS | {"probability_future", "elbo_gap"}
EVAL_KEYS_SRNN = EVAL_KEYS | {"iw_elbo_k20"}
# card against CPU through the Evaluator (B=2, 2 resamples, 2 context and 3
# predicted frames, phase 11's fitted model, replayed noise): the metric
# tracks of rollouts within phase 11's tolerance for an output that passes
# the flow more than once, of 1 + |ref|; bits/dim and the diagnostics
# (sums, as the train step's loss) within TOL_STEP_LOSS of 1 + the size of
# the quantity they come from (a std or a difference by its mean's)
TOL_EVAL_TRACK = TOL_LIFE_TWICE
# the metrics and the proxies against the CPU (each element within
# tol·(1+|ref|)): a window of 49 or a few 3x3 convs; the deep embedders
# (AlexNet, I3D: 5 and 58 convs, sums of up to 5,184 terms) 1e-4
TOL_EVAL_METRIC = 1e-5
TOL_EVAL_EMBED = 1e-4


def eval_launches(mcfg, chain_scales, n_cond, n_pred, resamples, frames) -> dict:
    """Launches of each Evaluator method on one batch of RFN at
    ``chain_impl='sample'`` (every forward flow on the module path): the
    loss (no gradient) scans the h-LSTM over frames-1 transitions and runs
    the forward flow per frame; probability_future scans the context and
    runs the forward flow per future frame for each of the two latents;
    elbo_gap (sample=False) scans all frames and runs the forward flow per
    frame for each latent."""
    roll = request_launches(mcfg, chain_scales, n_cond, n_pred)
    loss = train_launches(mcfg, "A", False, frames - 1, ())
    fwd = mcfg.L * mcfg.K
    flows = lambda n, gates: dict(actnorm_invconv=n * fwd, convlstm_gates=gates,
                                  coupling_transform=n * fwd, glowchain=0, glowstep=0)
    return dict(rollout=roll, get_eval_values=add(times(roll, resamples), loss),
                get_loss=times(loss, 3), get_fvd_values=roll,
                probability_future_bpp=flows(2 * n_pred, n_cond - 1),
                elbo_gap=flows(2 * (n_cond + n_pred - 1), n_cond + n_pred - 1))


def srnn_eval_launches(n_pred, resamples, frames) -> dict:
    """Launches of each Evaluator method on one batch of srnn_mnist:
    ``predict`` as phase 12's; the no-grad loss and the IW-ELBO scan lstm_h
    and lstm_a over frames-1 transitions, as the train step does."""
    roll = family_launches("srnn_mnist", "predict", n_pred)
    scan = family_launches("srnn_mnist", "train", frames)
    return dict(rollout=roll, get_eval_values=add(times(roll, resamples), scan),
                get_loss=times(scan, 3), get_fvd_values=roll, importance_weighted_elbo=scan)


def add(*counts) -> dict:
    """The sum of launch-count dicts."""
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def times(counts, n: int) -> dict:
    return {k: n * v for k, v in counts.items()}


class EvalTimers:
    """Wall ms and kernel launches of each Evaluator method, and the wall ms
    of its parts (rollouts, losses, metric tracks, LPIPS, FVD), each read
    after a synchronisation, while in the context."""

    def __init__(self):
        self.methods, self.parts = {}, {}

    def _wrap(self, owner, name, table, counted=False):
        from recurrent_flows_tpu_torch import ops

        inner = getattr(owner, name)

        def timed(*a, **k):
            before = ops.launch_counts() if counted else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*a, **k)
            torch.cuda.synchronize()
            row = table.setdefault(name, dict(ms=0.0, calls=0))
            row["ms"] += (time.perf_counter() - t0) * 1e3
            row["calls"] += 1
            if counted:
                row["launches"] = {k: v - before[k] for k, v in ops.launch_counts().items()}
            return out
        self._saved.append((owner, name, inner))
        setattr(owner, name, timed)

    def __enter__(self):
        from recurrent_flows_tpu_torch.evaluation import evaluator as ev

        self._saved = []
        for name in EVAL_METHODS:
            self._wrap(ev.Evaluator, name, self.methods, counted=True)
        for name in ("_predict", "_loss"):
            self._wrap(ev.Evaluator, name, self.parts)
        for name in ("eval_seq", "lpips_distance", "fvd"):
            self._wrap(ev, name, self.parts)
        return self

    def __exit__(self, *exc):
        for owner, name, inner in reversed(self._saved):
            setattr(owner, name, inner)


def run_eval_cli(path, argv) -> tuple:
    """``cli.eval_settings.main`` in this process on ``path`` (its printed
    summary kept off this script's standard output). Returns (payload,
    evaluations.json as read back, wall s, the EvalTimers)."""
    import contextlib
    import io

    from recurrent_flows_tpu_torch.cli import eval_settings

    t0 = time.perf_counter()
    with EvalTimers() as timers, contextlib.redirect_stdout(io.StringIO()):
        payload = eval_settings.main(["--path", str(path)] + argv)
    wall = time.perf_counter() - t0
    written = json.loads((Path(path) / "eval" / "evaluations.json").read_text())
    return payload, written, wall, timers


def check_evaluations(label, written, keys):
    """The JAX CLI's keys, and every number finite."""
    def numbers(d):
        if isinstance(d, dict):
            return [x for v in d.values() for x in numbers(v)]
        if isinstance(d, list):
            return list(np.ravel(np.asarray(d, dtype=float)))
        return [] if isinstance(d, str) or d is None else [float(d)]

    if set(written) != keys:
        raise AssertionError(f"{label} evaluations.json: keys {sorted(set(written) ^ keys)} "
                             "differ from the JAX CLI's")
    bad = [k for k, v in written.items() if k != "_meta" and not np.isfinite(numbers(v)).all()]
    if bad:
        raise AssertionError(f"{label} evaluations.json: not finite in {bad}")


def event_ms(fn, repeats: int = 5) -> float:
    """Median wall of ``fn`` between two CUDA events, after two warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_eval_metrics(record):
    """The metrics and the embedders on the card against the CPU, at the
    protocol's shapes, each element within its tolerance of 1 + |ref|,
    with device times: SSIM/PSNR/MSE of [8, 25, 64, 64, 1] frames, the LPIPS
    proxy and lpips_alex (random_params(0)) on those 200 frames, random3d
    and I3D (random_params(0)) on 16 clips of [13, 64, 64, 1] (I3D held
    against the CPU on 2 of them)."""
    import importlib

    from recurrent_flows_tpu_torch.evaluation import alexnet_lpips, i3d, lpips, metrics

    fvd_mod = importlib.import_module("recurrent_flows_tpu_torch.evaluation.fvd")
    g = torch.Generator().manual_seed(13)
    true = torch.rand(8, 25, 64, 64, 1, generator=g)
    pred = torch.clamp(true + 0.2 * torch.randn(true.shape, generator=g), 0, 1)
    clips = torch.rand(16, 13, 64, 64, 1, generator=g)
    alex = alexnet_lpips.random_params(0)
    i3d_params = i3d.random_params(0)
    frames = lambda t: (t * 2 - 1).reshape(-1, 64, 64, 1)
    cases = {
        "eval_seq": (lambda a, b: tuple(metrics.eval_seq(a, b).values()), (true, pred),
                     TOL_EVAL_METRIC),
        "lpips_proxy": (lambda a, b: (lpips.lpips_distance(frames(a), frames(b),
                                                           backend="random_features"),),
                        (true, pred), TOL_EVAL_METRIC),
        "lpips_alex": (lambda a, b: (alexnet_lpips.lpips_alex(alex, frames(a), frames(b)),),
                       (true, pred), TOL_EVAL_EMBED),
        "random3d": (lambda v: (fvd_mod._random3d_embed(v),), (clips,), TOL_EVAL_METRIC),
        "i3d": (lambda v: (i3d.i3d_embed(v, i3d_params),), (clips[:2],), TOL_EVAL_EMBED),
    }
    rows = {}
    for name, (fn, args, tol) in cases.items():
        ref = fn(*args)
        got = [o.cpu() for o in fn(*(a.cuda() for a in args))]
        err = check_elementwise(f"{name} card vs CPU", got, ref, (tol,) * len(ref))
        rows[name] = dict(max_abs_err=err, tol=tol)
    timed = {"eval_seq": (cases["eval_seq"][0], (true, pred)),
             "lpips_proxy": (cases["lpips_proxy"][0], (true, pred)),
             "lpips_alex": (cases["lpips_alex"][0], (true, pred)),
             "random3d": (cases["random3d"][0], (clips,)),
             "i3d": (cases["i3d"][0], (clips,))}
    for name, (fn, args) in timed.items():
        dev = [a.cuda() for a in args]
        rows[name]["ms"] = event_ms(lambda: fn(*dev))
        rows[name]["shape"] = list(args[0].shape)
    record["metrics_card_vs_cpu"] = rows
    print("eval metrics and embedders, card vs CPU (max |err|, limit of 1+|ref|; ms on the "
          "card): " + ", ".join(f"{k} {v['max_abs_err']:.2e} ({v['tol']:.0e}; "
                                f"{v['ms']:.2f} ms at {v['shape']})" for k, v in rows.items()))


def eval_card_vs_cpu(model, rng) -> dict:
    """``get_eval_values`` (with LPIPS), ``probability_future_bpp`` and
    ``elbo_gap`` of an Evaluator on the card against one on the CPU over a
    copy of the model: the same batch (2 sequences of 5 frames of moving
    squares), the CPU's draws replayed on the card, per (call, batch,
    resample). Returns {quantity: {err, limit}} (err of 1+|scale|)."""
    from recurrent_flows_tpu_torch.evaluation.evaluator import EvalSettings, Evaluator
    from recurrent_flows_tpu_torch.utils import NoiseSource

    x = torch.tensor(moving_squares(rng, 2, 5, model.cfg.image_size) - 0.5)
    settings = EvalSettings(n_conditions=2, n_predictions=3, resamples=2, n_batches=1,
                            batch_size=2)
    post = lambda a: torch.clamp(a + 0.5, 0.0, 1.0)
    records = {}

    class Fixed:
        def __init__(self, device):
            self.device = device

        def sample(self, generator, batch_size):
            return x.to(self.device)

    def record_noise(call, i, r):
        seed = 1000 * len(records) + 17
        rec = records[(call, i, r)] = RecordedNoise(
            NoiseSource(generator=torch.Generator().manual_seed(seed)))
        return rec

    def replay(call, i, r):
        return NoiseSource(replay=records[(call, i, r)].draws)

    results = {}
    for side, device, noise in (("cpu", "cpu", record_noise), ("card", "cuda", replay)):
        m = copy.deepcopy(model).cpu() if device == "cpu" else model
        ev = Evaluator(m, Fixed(device), settings, postprocess=post, device=device, noise=noise)
        results[side] = dict(eval=ev.get_eval_values(with_lpips=True),
                             probability_future=ev.probability_future_bpp(),
                             elbo_gap=ev.elbo_gap())
    errs = {}

    def hold(key, got, ref, tol, scale=None):
        got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        scale = np.abs(ref) if scale is None else np.abs(np.asarray(scale, np.float64))
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"card vs CPU {key}: shape {got.shape} / {ref.shape} or "
                                 "not finite")
        errs[key] = dict(err=float((np.abs(got - ref) / (1.0 + scale)).max()), limit=tol)

    cpu, card = results["cpu"], results["card"]
    for m in ("ssim", "psnr", "mse", "lpips"):
        for s in ("best", "mean"):
            hold(f"{m}_{s}", card["eval"][f"{m}_{s}"], cpu["eval"][f"{m}_{s}"], TOL_EVAL_TRACK)
    hold("bits_per_dim", card["eval"]["bits_per_dim"], cpu["eval"]["bits_per_dim"],
         TOL_STEP_LOSS)
    pf_c, pf_r = card["probability_future"], cpu["probability_future"]
    for k in ("prior", "posterior"):
        hold(f"bpp_{k}", pf_c[f"bpp_{k}"], pf_r[f"bpp_{k}"], TOL_STEP_LOSS)
        hold(f"bpp_{k}_std", pf_c[f"bpp_{k}_std"], pf_r[f"bpp_{k}_std"], TOL_STEP_LOSS,
             pf_r[f"bpp_{k}"])
    eg_c, eg_r = card["elbo_gap"], cpu["elbo_gap"]
    for k in ("nll_prior", "nll_posterior", "kld"):
        hold(k, eg_c[k], eg_r[k], TOL_STEP_LOSS)
    hold("amortization_gap", eg_c["amortization_gap"], eg_r["amortization_gap"],
         TOL_STEP_LOSS, eg_r["nll_prior"].mean())
    return errs


def evaluation(rng, record) -> dict:
    """Phase 13 (see the module docstring). Returns {path: launches}."""
    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.config import rfn_mnist_production
    from recurrent_flows_tpu_torch.data import MovingMNIST
    from recurrent_flows_tpu_torch.training.checkpoint import load_model_from_checkpoint
    from recurrent_flows_tpu_torch.utils import NoiseSource

    paths = {}
    check_eval_metrics(record)

    # the thesis protocol at rfn_mnist_production, phase 11's checkpoint
    mcfg = with_glow(rfn_mnist_production()[0], chain_impl="sample")
    chain_scales = range(1, mcfg.L)
    n_cond, n_pred, resamples, batch = 5, 25, 30, BATCH
    want = eval_launches(mcfg, chain_scales, n_cond, n_pred, resamples, n_cond + n_pred)
    workdir = ROOT / "runs" / "chip_smoke_lifecycle"
    ops.reset_launch_counts()
    payload, written, wall, timers = run_eval_cli(workdir, EVAL_RFN_ARGS)
    paths["eval_rfn"] = ops.launch_counts()
    check_evaluations("rfn_mnist_production", written, EVAL_KEYS_RFN)
    got = {k: v["launches"] for k, v in timers.methods.items()}
    expected = {k: want[k] for k in got}
    if got != expected or set(got) != set(EVAL_METHODS) - {"importance_weighted_elbo"}:
        raise AssertionError(f"eval rfn_mnist_production: launches {got}, expected {expected}")
    meta = written["_meta"]
    if (meta["n_predictions"], meta["resamples"], written["n_sequences"]) != (
            n_pred, resamples, batch) or written["fvd"]["embedder"] != "random3d":
        raise AssertionError(f"eval rfn_mnist_production: protocol {meta}")
    parts = timers.parts
    gev_ms = timers.methods["get_eval_values"]["ms"]
    rec = dict(wall_s=wall, methods=timers.methods, parts=parts,
               launches_per_rollout=want["rollout"], summary={
                   k: written[k] for k in ("bits_per_dim", "dataset_bpd", "fvd")})
    rec["summary"].update({f"{m}_best": written[f"{m}_best_summary"]
                           for m in ("ssim", "psnr", "mse", "lpips")})
    # get_eval_values runs `resamples` of the rollouts (get_fvd_values one)
    # and one of the losses (get_loss three)
    gev_roll_ms = parts["_predict"]["ms"] * resamples / parts["_predict"]["calls"]
    rec["get_eval_values_shares"] = dict(
        rollouts=gev_roll_ms / gev_ms, metrics=parts["eval_seq"]["ms"] / gev_ms,
        lpips=parts["lpips_distance"]["ms"] / gev_ms,
        loss=parts["_loss"]["ms"] / parts["_loss"]["calls"] / gev_ms)
    print(f"eval CLI, thesis protocol, rfn_mnist_production ({batch} sequences, {n_cond}+"
          f"{n_pred} frames, {resamples} resamples): {wall:.1f} s; "
          + ", ".join(f"{k} {v['ms']:.0f} ms" for k, v in timers.methods.items())
          + f"; launches per 25-frame rollout {want['rollout']}; get_eval_values shares "
          + ", ".join(f"{k} {v:.3f}" for k, v in rec["get_eval_values_shares"].items())
          + f"; bits/dim {written['bits_per_dim']:.4f}, dataset {written['dataset_bpd']:.4f}, "
          f"FVD (random3d, 13 frames) {written['fvd']['fvd']:.3f}, SSIM best "
          f"{written['ssim_best_summary']['mean']:.4f}")

    # one profiled 25-frame rollout of the served model
    model, tcfg, _ = load_model_from_checkpoint(str(workdir / "model_folder" / "last"), 0.7,
                                                device="cuda")
    data = MovingMNIST(digit_bank="synthetic", digit_size=tcfg.digit_size,
                       num_digits=tcfg.num_digits, seq_len=n_cond)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = data.sample(gen, batch) - 0.5
    roll_median = parts["_predict"]["ms"] / parts["_predict"]["calls"]
    prof = profile_call(lambda: counted("profiled rollout", lambda: model.predict(
        x, n_pred, n_cond, NoiseSource(generator=gen)), want["rollout"]), roll_median)
    rec["rollout_profile"] = prof
    print_profile(f"25-frame rollout of {batch}", prof)

    # card against the CPU through the Evaluator
    errs = eval_card_vs_cpu(model, rng)
    rec["card_vs_cpu"] = errs
    print("eval card vs CPU (err of 1+|ref|; limit): "
          + ", ".join(f"{k} {v['err']:.2e} ({v['limit']:.0e})" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v["err"] <= v["limit"]}
    if bad:
        raise AssertionError(f"eval: card and CPU disagree: {bad}")
    record["rfn_mnist_production"] = rec
    del model
    torch.cuda.empty_cache()

    # the default protocol at srnn_mnist, phase 12's checkpoint
    workdir = ROOT / "runs" / "chip_smoke_srnn_mnist"
    want = srnn_eval_launches(10, 5, 15)
    ops.reset_launch_counts()
    payload, written, wall, timers = run_eval_cli(workdir, EVAL_SRNN_ARGS)
    paths["eval_srnn"] = ops.launch_counts()
    check_evaluations("srnn_mnist", written, EVAL_KEYS_SRNN)
    got = {k: v["launches"] for k, v in timers.methods.items()}
    expected = {k: want[k] for k in got}
    if got != expected or set(got) != set(want) - {"rollout"}:
        raise AssertionError(f"eval srnn_mnist: launches {got}, expected {expected}")
    record["srnn_mnist"] = dict(wall_s=wall, methods=timers.methods, parts=timers.parts,
                                iw_elbo_k20=written["iw_elbo_k20"])
    print(f"eval CLI, default protocol, srnn_mnist (8 sequences, 5+10 frames, 5 resamples): "
          f"{wall:.1f} s; " + ", ".join(f"{k} {v['ms']:.0f} ms"
                                        for k, v in timers.methods.items())
          + f"; gates {paths['eval_srnn']['convlstm_gates']}; IW-ELBO (K=20) "
          f"{written['iw_elbo_k20']:.2f}, bits/dim {written['bits_per_dim']:.4f}")
    return paths


# phase 14: the training CLIs (``cli.main_*``, in this process) at their
# defaults under runs/chip_smoke_cli/: RFN is K=15, L=5, h=256, z=5,
# with_skip, the 8-8-pool-16... extractor, batch-norm feature nets, B=32,
# T=10, chain_impl 'off' (no CLI flag sets it): a step runs the module path
# at every scale, and so does the rollout of the eval CLI on its checkpoint
CLI_DIR = ROOT / "runs" / "chip_smoke_cli"
CLI_EPOCH = ["--n_epochs", "1", "--steps_per_epoch", "1"]
# the shapes and KTH steps on 4 frames (their data paths; the BAIR steps keep
# the defaults, whose 2x2x192 scale the folded 1x1's tiles take)
CLI_SHORT = ["--n_frames", "4"]
CLI_EVAL_ARGS = ["--n_batches", "1", "--batch_size", "8", "--resamples", "2",
                 "--no-debug_plot", "--fvd_embedder", "random3d", "--device", "cuda"]
# the PNG trees the phase writes (64x64 frames, gray for KTH, RGB for BAIR)
CLI_PNG_VIDEOS, CLI_PNG_FRAMES = 4, 12


class CliTimers:
    """While in the context: each ``Trainer.train_step`` is synchronised and
    timed, with its peak memory and its launches; each batch of the PNG
    loaders and of the frame cache's ring is timed on the host;
    ``Trainer.load`` keeps a copy of the state it loaded."""

    def __enter__(self):
        from recurrent_flows_tpu_torch import ops
        from recurrent_flows_tpu_torch.data import KTH, PushDataset
        from recurrent_flows_tpu_torch.data.framecache import FrameCache
        from recurrent_flows_tpu_torch.training import Trainer

        self.steps, self.batch_ms, self.loaded = [], [], None
        self._saved = [(Trainer, "train_step"), (Trainer, "load"), (KTH, "sample_numpy"),
                       (PushDataset, "sample_numpy"), (FrameCache, "sample_numpy")]
        self._saved = [(owner, name, getattr(owner, name)) for owner, name in self._saved]
        step, load, kth, push, ring = (inner for _, _, inner in self._saved)

        def timed_step(tr, *a, **k):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = step(tr, *a, **k)
            m = {key: float(v) for key, v in out.items()}
            torch.cuda.synchronize()
            self.steps.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches={key: v - before[key] for key, v in ops.launch_counts().items()}, **m))
            return out

        def kept_load(tr, name="last"):
            out = load(tr, name)
            self.loaded = dict(
                model={key: v.clone() for key, v in tr.model.state_dict().items()},
                adam={i: {key: v.clone() for key, v in s.items()}
                      for i, s in tr.optimizer.state_dict()["state"].items()},
                counter=tr.counter)
            return out

        def host_timed(inner):
            def sample_numpy(loader, *a, **k):
                t0 = time.perf_counter()
                out = inner(loader, *a, **k)
                self.batch_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return sample_numpy

        Trainer.train_step, Trainer.load = timed_step, kept_load
        KTH.sample_numpy, PushDataset.sample_numpy = host_timed(kth), host_timed(push)
        FrameCache.sample_numpy = host_timed(ring)
        return self

    def __exit__(self, *exc):
        for owner, name, inner in self._saved:
            setattr(owner, name, inner)


def run_cli(label, module, argv, want_step, record):
    """``module.main(argv)`` with the launch counts set to 0 before it and
    read after it, every step's launches held to ``want_step``, its printed
    lines kept, its plots checked (``check_plots``: no plot failure, the
    PNGs decode). Returns (the trainer, the run's launches, the timers)."""
    import contextlib
    import io

    from recurrent_flows_tpu_torch import ops

    printed = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with CliTimers() as timers, contextlib.redirect_stdout(printed):
        tr = module.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    bad = [s["launches"] for s in timers.steps if s["launches"] != want_step]
    if bad or not timers.steps or not np.isfinite(tr.losses).all():
        raise AssertionError(f"{label}: step launches {bad[:1]}, expected {want_step}; "
                             f"{len(timers.steps)} steps, losses {tr.losses}")
    lines = printed.getvalue().splitlines()
    plots = check_plots(label, argv[argv.index("--path") + 1], printed.getvalue(),
                        1 + tr.plot_counter)
    rec = dict(argv=argv, wall_s=wall, steps=timers.steps, launches_per_step=want_step,
               launches=launches, printed=lines, plots=plots, data=type(tr.data).__name__)
    if timers.batch_ms:
        rec["loader_batch_ms"] = timers.batch_ms
    record[label] = rec
    last = timers.steps[-1]
    print(f"{label}: {wall:.1f} s, {len(timers.steps)} steps, last {last['ms']:.1f} ms, peak "
          f"{last['peak_gib']:.2f} GiB, loss {last['loss']:.1f}, launches per step "
          f"{want_step}" + (f", loader {statistics.median(timers.batch_ms):.1f} ms per batch"
                            if timers.batch_ms else "") + f"; printed {lines}")
    return tr, launches, timers


def write_png_tree(choice, root, rng, size: int):
    """A KTH (gray) or BAIR (RGB) tree of moving squares, size x size PNGs,
    in the layout each loader reads: CLI_PNG_VIDEOS training videos and one
    test video (KTH persons 1-4 and 21; BAIR trajectories under train/ and
    test/), each frame's rows filtered with Average and Paeth in turn (PNG
    filters 3 and 4, which real encoders write and which cost the decoder
    the most)."""
    from recurrent_flows_tpu_torch.data.png import write_png

    ch = 1 if choice == "kth" else 3
    videos = moving_squares(rng, CLI_PNG_VIDEOS + 1, CLI_PNG_FRAMES, size, ch)
    for v, frames in enumerate(videos):
        test = v == CLI_PNG_VIDEOS
        d = (root / "processed" / "boxing" / f"person{21 if test else v + 1:02d}_boxing_d1"
             if choice == "kth"
             else root / ("test" if test else "train") / "traj_0_to_255" / str(v))
        d.mkdir(parents=True)
        for i, f in enumerate(frames):
            img = np.round(f * 255).astype(np.uint8)
            write_png(str(d / (f"image-{i:03d}.png" if choice == "kth" else f"{i}.png")),
                      img[..., 0] if ch == 1 else img, filters=(3, 4))


# (H = W, C) of x at the five flow scales of main_rfn --choose_data bair at
# its defaults (L=5, x_channels 3)
BAIR_CLI_SCALES = [(32 >> l, 12 << l) for l in range(5)]


def check_cli_kernels(model, record) -> dict:
    """The gates, the coupling and the folded 1x1 at the shapes the CLI's
    RFN gives them (the gates at h = 256 on 2x2, new; the flow's five
    scales at B=32 forward, the coupling also at B=8 in reverse; the folded
    1x1 also at the five of its BAIR step, ``BAIR_CLI_SCALES``), and the
    glowchain kernel at K=15 on the checkpoint's own stacked parameters at
    the scales its gate takes at B=8 (1-4; the with_skip conditions widen
    cond to 64-384), each against its plain version within the tolerances
    of phase 3, with device times beside bounds. Returns per kernel the
    worst error and the rows."""
    from recurrent_flows_tpu_torch.flows.glow import kernel_fits
    from recurrent_flows_tpu_torch.ops import (
        actnorm_invconv, actnorm_invconv_ref, convlstm_gates, convlstm_gates_ref,
        coupling_transform, coupling_transform_ref, glowchain, glowchain_ref)

    g = torch.Generator(device="cuda").manual_seed(14)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale
    out = {}

    def add(name, row):
        t = out.setdefault(name, dict(max_abs_err=0.0, rows=[]))
        t["max_abs_err"] = max(t["max_abs_err"], row["err"])
        t["rows"].append(row)

    for b in (32, BATCH):
        gates, c = rnd(b, 2, 2, 1024), rnd(b, 2, 2, 256)
        peeps = [rnd(1, 2, 2, 256, scale=0.1) for _ in range(3)]
        e = check_elementwise(f"convlstm_gates [{b},2,2,1024]", convlstm_gates(gates, c, *peeps),
                              convlstm_gates_ref(gates, c, *peeps), (TOL_ELEMENTWISE,) * 2)
        check_repeats(f"convlstm_gates [{b},2,2,1024]", lambda: convlstm_gates(gates, c, *peeps))
        n_bytes = nbytes(gates, c, *peeps, c, c)
        add("convlstm_gates", dict(shape=list(gates.shape), err=e,
                                   ms=small_ms(lambda: convlstm_gates(gates, c, *peeps)),
                                   plain_ms=small_ms(lambda: convlstm_gates_ref(gates, c, *peeps)),
                                   **bound(n_bytes, 25 * c.numel())))
    scales = [(32 >> l, 4 << l) for l in range(5)]
    for shape, rev, (z2, shift, s) in coupling_cases(
            rnd, [(32, hw, c // 2, False) for hw, c in scales]
            + [(BATCH, hw, c // 2, True) for hw, c in scales]):
        e = check_elementwise(f"coupling_transform {shape} reverse={rev}",
                              coupling_transform(z2, shift, s, rev),
                              coupling_transform_ref(z2, shift, s, rev),
                              (TOL_ELEMENTWISE, TOL_COUPLING_LD))
        add("coupling_transform", dict(
            shape=shape, reverse=rev, err=e,
            ms=small_ms(lambda: coupling_transform(z2, shift, s, rev)),
            plain_ms=small_ms(lambda: coupling_transform_ref(z2, shift, s, rev)),
            **bound(nbytes(z2, shift, s, z2) + 4 * shape[0], 4 * z2.numel())))
    # the folded 1x1 at the gray scales, then at the five of main_rfn
    # --choose_data bair (x_channels 3: 32x32x12 .. 2x2x192, the last in the
    # tile design's widest regime)
    for hw, c in scales + BAIR_CLI_SCALES:
        x = rnd(32 * hw * hw, c)
        bias, logs = rnd(c, scale=0.3), rnd(c, scale=0.3)
        w = torch.linalg.qr(rnd(c, c))[0].contiguous()
        name = f"actnorm_invconv [{x.shape[0]}, {c}]"
        n = actnorm_invconv.launches
        e = check_elementwise(name, (actnorm_invconv(x, bias, logs, w),),
                              (actnorm_invconv_ref(x, bias, logs, w),), (TOL_INVCONV,))
        if actnorm_invconv.launches != n + 1:
            raise AssertionError(f"{name}: {actnorm_invconv.launches - n} launches in a call")
        check_repeats(name, lambda: (actnorm_invconv(x, bias, logs, w),))
        times = ainv_times(actnorm_invconv, x, bias, logs, w)
        add("actnorm_invconv", dict(
            shape=list(x.shape), err=e, ms=times["ms"], library_ms=times["library_ms"],
            plain_ms=small_ms(lambda: actnorm_invconv_ref(x, bias, logs, w)),
            **bound(nbytes(x, bias, logs, w, x), 2 * x.numel() * c + 2 * x.numel())))
    flow = model.flow
    with torch.no_grad():
        for l, (hw, c, cc) in enumerate(flow.scale_shapes):
            if not kernel_fits(model.cfg.glow, BATCH, hw, hw, c, cc):
                continue
            p, _ = flow.chain_params(l, reverse=True)
            p = type(p)(*(t.detach().contiguous() for t in p))
            x, cond = rnd(BATCH, hw, hw, c), rnd(BATCH, hw, hw, cc)
            name = f"glowchain K={model.cfg.K} [{BATCH},{hw},{hw},{c}] cond {cc}"
            got = glowchain(x, cond, p, "realnvp", True)
            e = check_elementwise(name, got, glowchain_ref(x, cond, p, "realnvp", True),
                                  (TOL_CHAIN, TOL_CHAIN))
            check_repeats(name, lambda: glowchain(x, cond, p, "realnvp", True))
            add("glowchain", dict(
                shape=[BATCH, hw, hw, c], cond=cc, K=model.cfg.K, reverse=True, err=e,
                ms=cuda_ms(lambda: glowchain(x, cond, p, "realnvp", True), iters=5),
                plain_ms=cuda_ms(lambda: glowchain_ref(x, cond, p, "realnvp", True), iters=5),
                **bound(nbytes(x, cond, *p, x) + 4 * BATCH,
                        model.cfg.K * glowstep_flops(x, cond, model.cfg.glow.n_units_affine))))
    for name, t in out.items():
        print(f"{name} at the CLI's shapes: max |err| {t['max_abs_err']:.3e}; "
              + ", ".join(f"{r['shape']}{' cond ' + str(r['cond']) if 'cond' in r else ''}"
                          f"{' rev' if r.get('reverse') else ''} {r['ms']:.5f} ms (plain "
                          f"{r['plain_ms']:.5f}, bound {r['bound_ms']:.6f} {r['bound_by']})"
                          for r in t["rows"]))
    if len(out.get("glowchain", {}).get("rows", [])) != 4:
        raise AssertionError("glowchain was not checked at the four scales it fits")
    record["kernels"] = out
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multigpu_vs_plain(record):
    """``--multigpu`` in a one-process NCCL group (the torchrun environment
    set by hand) against the same CLI run without it: the CLI's own
    ``setup_training`` (build with the data-dependent init) and one
    ``train_epoch`` of one step each; the loss and every parameter and
    buffer equal bit for bit. Returns (the plain trainer, launches of the
    data-parallel run)."""
    import os

    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.cli import common, main_rfn
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.parallel import initialize

    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    runs = {}
    # cuDNN's default backward algorithms may sum with atomics: two runs of
    # the plain step can differ in the last bits, whatever the group does
    cudnn = torch.backends.cudnn
    saved_cudnn, cudnn.deterministic = cudnn.deterministic, True
    for name in ("multigpu", "plain"):
        argv = CLI_EPOCH + ["--path", str(CLI_DIR / name)] + (
            ["--multigpu"] if name == "multigpu" else [])
        args = main_rfn.build_parser().parse_args(argv)
        cfg = main_rfn.config_from_args(args)
        make = lambda device: RFN(cfg, device=device,
                                  generator=torch.Generator().manual_seed(args.seed))
        saved = {k: os.environ.get(k) for k in env}
        dp = None
        try:
            if args.multigpu:
                os.environ.update(env)
                dp = initialize(args.device)
                if dp is None or dp.world != 1 or torch.distributed.get_backend() != "nccl":
                    raise AssertionError(f"multigpu: no one-process NCCL group ({dp})")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            tr = common.setup_training(make, args, dp)
            tr.train_epoch(1)
            torch.cuda.synchronize()
            runs[name] = dict(trainer=tr, s=time.perf_counter() - t0,
                              launches=ops.launch_counts())
        finally:
            if dp is not None:
                dp.close()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    cudnn.deterministic = saved_cudnn
    a, b = (runs[n]["trainer"] for n in ("multigpu", "plain"))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    unequal = [n for n in sa if not torch.equal(sa[n], sb[n])]
    if unequal or a.losses != b.losses or a.counter != 1:
        raise AssertionError(f"multigpu: differs from the plain run in {unequal[:8]}, losses "
                             f"{a.losses} / {b.losses}")
    record["multigpu"] = dict(losses=a.losses, tensors=len(sa), seconds={
        n: r["s"] for n, r in runs.items()}, launches=runs["multigpu"]["launches"])
    print(f"multigpu (one-process NCCL group) vs plain: build and one step, loss {a.losses}, "
          f"{len(sa)} tensors bit-equal; {runs['multigpu']['s']:.1f} s vs "
          f"{runs['plain']['s']:.1f} s")
    del a, runs
    return b, record["multigpu"]["launches"]


def training_clis(rng, record) -> tuple:
    """Phase 14 (see the module docstring). Returns ({path: launches}, the
    kernel checks at the CLI's shapes)."""
    import shutil

    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.cli import (build_framecache, main_rfn, main_srnn, main_svg,
                                               main_vrnn)
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.serving import Predictor
    from recurrent_flows_tpu_torch.training.checkpoint import load_model_from_checkpoint
    from recurrent_flows_tpu_torch.utils import float32_precision

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    paths = {}
    defaults = main_rfn.build_parser().parse_args([])
    mcfg = main_rfn.config_from_args(defaults)
    frames, img = defaults.n_frames, mcfg.image_size
    want = train_launches(mcfg, "A", True, frames - 1, ())

    # main_rfn at its defaults, then --load_model
    rfn_dir = CLI_DIR / "rfn"
    first, paths["cli_rfn"], _ = run_cli("cli_rfn", main_rfn, CLI_EPOCH + [
        "--path", str(rfn_dir)], want, record)
    status = (rfn_dir / "model_folder" / "status.txt").read_text().splitlines()
    meta = json.loads((rfn_dir / "model_folder" / "last" / "meta.json").read_text())
    if (first.counter, meta["counter"]) != (1, 1) or not status[0].startswith("data_source "):
        raise AssertionError(f"cli_rfn: counter {first.counter}, saved {meta['counter']}, "
                             f"status {status}")
    n_params = sum(p.numel() for p in first.model.parameters())
    saved_model = {k: v.clone() for k, v in first.model.state_dict().items()}
    saved_adam = first.optimizer.state_dict()["state"]
    del first
    torch.cuda.empty_cache()
    resumed, paths["cli_rfn_load"], timers = run_cli(
        "cli_rfn_load", main_rfn, CLI_EPOCH + ["--path", str(rfn_dir), "--load_model"],
        want, record)
    got = timers.loaded
    unequal = [k for k in saved_model if not torch.equal(saved_model[k], got["model"][k])]
    unequal += [f"adam {i} {k}" for i in saved_adam for k in saved_adam[i]
                if not torch.equal(saved_adam[i][k].cpu(), got["adam"][i][k].cpu())]
    if unequal or got["counter"] != 1 or resumed.counter != 2 or resumed.epoch_i != 2:
        raise AssertionError(f"--load_model: loaded state differs in {unequal[:8]}; counter "
                             f"{got['counter']} -> {resumed.counter}")
    print(f"--load_model: {len(saved_model)} tensors and {len(saved_adam)} Adam states "
          f"bit-equal, counter 1 -> {resumed.counter}; {n_params} parameters")
    record["cli_rfn"]["parameters"] = n_params
    del resumed, saved_model, saved_adam, timers
    torch.cuda.empty_cache()

    # the eval CLI on that checkpoint: chain_impl 'off', so no glowchain
    ops.reset_launch_counts()
    _, written, wall, timers = run_eval_cli(rfn_dir, CLI_EVAL_ARGS)
    paths["cli_eval"] = ops.launch_counts()
    check_evaluations("cli eval", written, EVAL_KEYS_RFN)
    # the eval CLI's defaults: 5 context and 10 predicted frames
    want_eval = eval_launches(mcfg, (), 5, 10, 2, max(frames, 15))
    got_eval = {k: v["launches"] for k, v in timers.methods.items()}
    if got_eval != {k: want_eval[k] for k in got_eval} or not got_eval:
        raise AssertionError(f"cli eval: launches {got_eval}, expected {want_eval}")
    record["cli_eval"] = dict(wall_s=wall, methods=timers.methods,
                              launches_per_rollout=want_eval["rollout"])
    print(f"eval CLI on the CLI's checkpoint (8 sequences, 5+10 frames, 2 resamples): "
          f"{wall:.1f} s; launches per rollout {want_eval['rollout']}; "
          + ", ".join(f"{k} {v['ms']:.0f} ms" for k, v in timers.methods.items()))

    # glowchain at K=15: the kernel on the checkpoint's parameters, then a
    # served request of the checkpoint with chain_impl='sample'
    model, tcfg, _ = load_model_from_checkpoint(str(rfn_dir / "model_folder" / "last"),
                                                device="cuda")
    with float32_precision():
        checks = check_cli_kernels(model, record.setdefault("cli_shapes", {}))
    chained = RFN(with_glow(model.cfg, chain_impl="sample"), device="cuda")
    chained.load_state_dict(model.state_dict())
    del model
    chain_scales = [l for l in range(mcfg.L) if chained.flow.chain_eligible(l, BATCH)]
    pred = Predictor(chained, tcfg, n_conditions=N_COND, n_predictions=N_PRED)
    pred.warmup(batch_size=BATCH)
    want_req = request_launches(mcfg, chain_scales, N_COND, N_PRED)
    ops.reset_launch_counts()
    times_ms = []
    for i in range(N_REQUESTS):
        ctx = moving_squares(rng, BATCH, N_COND, img)
        t0 = time.perf_counter()
        out = counted(f"chained request {i}", lambda: pred.predict(ctx), want_req)
        torch.cuda.synchronize()
        times_ms.append((time.perf_counter() - t0) * 1e3)
        check_frames(f"chained request {i}", out, (BATCH, N_PRED, img, img, 1))
    paths["cli_chain_request"] = ops.launch_counts()
    record["cli_chain_request"] = dict(ms=times_ms, chain_scales=chain_scales,
                                       launches_per_request=want_req)
    print(f"the CLI's checkpoint served with chain_impl='sample' (scales {chain_scales}): "
          f"median {statistics.median(times_ms):.1f} ms per request of {BATCH}, launches "
          f"{want_req}")
    del pred, chained
    torch.cuda.empty_cache()

    # the other data sources, one step each: KTH and BAIR first through the
    # PNG loaders, then through the frame cache's blobs, which
    # cli.build_framecache writes from the same trees
    one = ["--n_epochs", "1", "--steps_per_epoch", "1"]
    want_short = train_launches(mcfg, "A", True, int(CLI_SHORT[1]) - 1, ())
    _, paths["cli_shapes"], _ = run_cli("cli_shapes", main_rfn, one + CLI_SHORT + [
        "--choose_data", "shapes", "--path", str(CLI_DIR / "shapes")], want_short, record)
    for choice in ("kth", "bair"):
        root = CLI_DIR / f"{choice}_data"
        write_png_tree(choice, root, rng, img)
        short, want_c = (CLI_SHORT, want_short) if choice == "kth" else ([], want)
        argv = one + short + ["--choose_data", choice, "--data_root", str(root)]
        _, paths[f"cli_{choice}_png"], _ = run_cli(f"cli_{choice}_png", main_rfn, argv + [
            "--path", str(CLI_DIR / f"{choice}_png")], want_c, record)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            blobs = build_framecache.main(["--dataset", choice, "--data_root", str(root)])
        build_s = time.perf_counter() - t0
        _, paths[f"cli_{choice}"], _ = run_cli(f"cli_{choice}", main_rfn, argv + [
            "--path", str(CLI_DIR / choice)], want_c, record)
        kinds = (record[f"cli_{choice}_png"]["data"], record[f"cli_{choice}"]["data"])
        if kinds != ({"kth": "KTH", "bair": "PushDataset"}[choice], "FrameCache"):
            raise AssertionError(f"cli_{choice}: the steps read {kinds}, expected the PNG "
                                 "loader, then the frame cache")
        record[f"cli_{choice}"]["blobs"] = dict(build_s=build_s, bytes={
            Path(b).name: Path(b).stat().st_size for b in blobs})
        print(f"{choice}: blobs {record[f'cli_{choice}']['blobs']['bytes']} built in "
              f"{build_s:.2f} s from filter-3/4 PNGs; loader ms per batch: PNG "
              f"{statistics.median(record[f'cli_{choice}_png']['loader_batch_ms']):.2f}, "
              f"ring {statistics.median(record[f'cli_{choice}']['loader_batch_ms']):.2f}")
    torch.cuda.empty_cache()

    # the other families at their defaults
    for name, module in (("srnn", main_srnn), ("vrnn", main_vrnn), ("svg", main_svg)):
        per_step = family_launches(f"{name}_mnist", "train", frames)
        tr, paths[f"cli_{name}"], _ = run_cli(f"cli_{name}", module, CLI_EPOCH + [
            "--path", str(CLI_DIR / name)], per_step, record)
        if name == "srnn":
            profiled = tr
        else:
            del tr
        torch.cuda.empty_cache()

    # Trainer.train_epoch(1, profile_dir=...) on the SRNN CLI's trainer
    prof_dir = CLI_DIR / "profile"
    profiled.train_epoch(1, profile_dir=str(prof_dir))
    files = sorted(prof_dir.glob("*.pt.trace.json"))
    events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    gates = [e for e in kernels if "gates_kernel" in e.get("name", "")]
    if not kernels or not gates:
        raise AssertionError(f"trace: files {files}, {len(kernels)} kernel events, "
                             f"{len(gates)} of the gates")
    record["trace"] = dict(file=files[0].name, bytes=files[0].stat().st_size,
                           events=len(events), kernel_events=len(kernels),
                           gates_events=len(gates))
    print(f"train_epoch(1, profile_dir): {files[0].name}, {files[0].stat().st_size} bytes, "
          f"{len(events)} events, {len(kernels)} CUDA kernels ({len(gates)} gates)")
    del profiled
    torch.cuda.empty_cache()

    # --multigpu in a one-process NCCL group against the plain run
    plain, paths["cli_multigpu"] = multigpu_vs_plain(record)
    del plain
    torch.cuda.empty_cache()
    never = {path: [k for k in kinds if paths[path][k] == 0] for path, kinds in (
        ("cli_rfn", ("actnorm_invconv", "convlstm_gates", "coupling_transform")),
        ("cli_eval", ("convlstm_gates", "coupling_transform")),
        ("cli_chain_request", ("glowchain",)),
        ("cli_srnn", ("convlstm_gates",)), ("cli_vrnn", ("convlstm_gates",)),
        ("cli_multigpu", ("actnorm_invconv", "convlstm_gates", "coupling_transform")))}
    never = {k: v for k, v in never.items() if v}
    if never:
        raise AssertionError(f"phase 14 paths that never launched their kernels: {never}")
    return paths, checks


# phase 15: the serving export. Phase 11's rfn_mnist_production checkpoint
# (chain_impl='sample') through the export CLI, phase 12's srnn_mnist one
# through Predictor.export, each at B=8 with 5 context + 10 predicted frames
EXPORT_DIR = ROOT / "runs" / "chip_smoke_export"
EXPORT_SEEDS = (7, 8, 9)


def export_phase(record) -> dict:
    """Phase 15: export, load and serve (see the module docstring). Each
    artifact answers one request per seed of EXPORT_SEEDS with exact
    launches (timed), then each again beside ``Predictor(seed=seed).predict``
    on the same checkpoint and context, whose launches must be the same and
    whose frames must be the same bit for bit (deterministic cuDNN for this
    comparison). Returns {path: launches of the timed exported requests}."""
    import shutil

    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.cli import export_serving
    from recurrent_flows_tpu_torch.data import MovingMNIST
    from recurrent_flows_tpu_torch.serving import Predictor, load_exported
    from recurrent_flows_tpu_torch.training.checkpoint import load_model_from_checkpoint

    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    EXPORT_DIR.mkdir(parents=True)
    data = MovingMNIST(digit_bank="synthetic", digit_size=32, num_digits=2, seq_len=N_COND)
    gen = torch.Generator(device="cuda").manual_seed(15)
    rfn_ckpt = ROOT / "runs" / "chip_smoke_lifecycle" / "model_folder" / "last"
    srnn_ckpt = ROOT / "runs" / "chip_smoke_srnn_mnist" / "model_folder" / "last"
    paths = {}
    for label, ckpt in (("export_rfn", rfn_ckpt), ("export_srnn", srnn_ckpt)):
        out_path = EXPORT_DIR / f"{label}.pt2"
        model, tcfg, _ = load_model_from_checkpoint(str(ckpt), device="cuda")
        mcfg = model.cfg
        if label == "export_rfn":
            if mcfg.glow.chain_impl != "sample":
                raise AssertionError(f"{label}: the checkpoint has chain_impl "
                                     f"{mcfg.glow.chain_impl!r}, not 'sample'")
            want = request_launches(mcfg, range(1, mcfg.L), N_COND)
        else:
            want = family_launches("srnn_mnist", "predict", N_PRED)
        t0 = time.perf_counter()
        if label == "export_rfn":
            with contextlib.redirect_stdout(io.StringIO()):
                blob = export_serving.main([
                    "--checkpoint", str(ckpt), "--out", str(out_path), "--batch_size",
                    str(BATCH), "--n_conditions", str(N_COND), "--n_predictions", str(N_PRED)])
        else:
            blob = Predictor(model, tcfg, n_conditions=N_COND, n_predictions=N_PRED).export(
                str(out_path), batch_size=BATCH)
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve = load_exported(str(out_path))
        load_s = time.perf_counter() - t0
        if blob != out_path.read_bytes():
            raise AssertionError(f"{label}: the returned bytes are not the file's")
        nodes = [n for n in serve.program.graph.nodes if n.op == "call_function"]
        rft_nodes = sorted({str(n.target) for n in nodes if str(n.target).startswith("rft.")})
        ctxs = [data.sample(gen, BATCH).cpu().numpy() for _ in EXPORT_SEEDS]
        serve(ctxs[0], 0)  # warm-up: the first call of a loaded program
        torch.cuda.synchronize()
        got, times = [], []
        ops.reset_launch_counts()
        for i, (seed, ctx) in enumerate(zip(EXPORT_SEEDS, ctxs)):
            t0 = time.perf_counter()
            frames, counts = launched(lambda: serve(ctx, seed))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if counts != want:
                raise AssertionError(f"{label} request {i}: launches {counts}, expected {want}")
            got.append(frames)
        paths[label] = ops.launch_counts()
        got = [f.cpu().numpy() for f in got]
        for i, frames in enumerate(got):
            check_frames(f"{label} request {i}", frames, (BATCH, N_PRED) + ctxs[i].shape[2:])
        # the eager requests beside them, timed the same way
        eager_ms = []
        for i, (seed, ctx) in enumerate(zip(EXPORT_SEEDS, ctxs)):
            pred = Predictor(model, tcfg, n_conditions=N_COND, n_predictions=N_PRED, seed=seed)
            t0 = time.perf_counter()
            counted(f"{label} eager request {i}", lambda: pred.predict(ctx), want)
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        # each request again beside the eager one, Predictor(seed=seed).predict
        # (its first request), with deterministic cuDNN algorithms: by default
        # a transposed conv (SRNN's decoder) may sum with atomics, and two eager
        # requests differ in the last bits
        cudnn = torch.backends.cudnn
        saved_cudnn, cudnn.deterministic = cudnn.deterministic, True
        errs, equal = [], []
        try:
            for i, (seed, ctx) in enumerate(zip(EXPORT_SEEDS, ctxs)):
                served = serve(ctx, seed).cpu().numpy()
                pred = Predictor(model, tcfg, n_conditions=N_COND, n_predictions=N_PRED,
                                 seed=seed)
                ref, counts = launched(lambda: pred.predict(ctx))
                if counts != want:
                    raise AssertionError(f"{label}: the eager request {i} launched {counts}, "
                                         f"expected {want}")
                equal.append(bool(np.array_equal(served, ref)))
                errs.append(float(np.abs(served - ref).max()))
        finally:
            cudnn.deterministic = saved_cudnn
        rec = dict(export_s=export_s, load_s=load_s, artifact_bytes=len(blob), ms=times,
                   median_ms=statistics.median(times), eager_ms=eager_ms,
                   eager_median_ms=statistics.median(eager_ms), launches_per_request=want,
                   rft_nodes=rft_nodes, graph_nodes=len(nodes), bit_equal=equal,
                   max_abs_err=errs, draws=len(serve.meta["draws"]))
        record[label] = rec
        print(f"{label}: exported in {export_s:.1f} s ({len(blob)} bytes, {len(nodes)} graph "
              f"nodes, {rft_nodes}), loaded in {load_s:.1f} s; {len(EXPORT_SEEDS)} requests of "
              f"{BATCH}: median {rec['median_ms']:.1f} ms ({[round(t, 1) for t in times]}; "
              f"eager {rec['eager_median_ms']:.1f}, {[round(t, 1) for t in eager_ms]}), "
              f"launches {want} as the eager request's; bit-equal to "
              f"Predictor(seed).predict: {equal} (max |err| {max(errs):.3e})")
        if not all(equal):
            raise AssertionError(f"{label}: the exported requests differ from the eager "
                                 f"ones: max |err| {errs}")
        del model, serve, pred
        torch.cuda.empty_cache()
    return paths


# --- phase 16: the standalone models ------------------------------------------

STANDALONE_DIR = ROOT / "runs" / "chip_smoke_standalone"
# GlowImage at BASELINE config 3 with validate_training.py's widths (64x64
# gray, L=3, K=8, 128 units, conditions of 8 channels), Moving MNIST of B=16
# sequences of 6 frames: 96 frames per step, 16 images per sample request
GLOW_IMG, GLOW_B, GLOW_T, GLOW_COND, GLOW_STEPS_A = 64, 16, 6, 8, 3
# cGlow at the notebook's L and K (SURVEY.md:167), the default widths (256
# and 512 units), conditions of 32 channels: 32x32 RGB, B=16, the box 8
CGLOW_IMG, CGLOW_B, CGLOW_COND, CGLOW_STEPS, CGLOW_IMAGES = 32, 16, 32, 3, 48
# (B, H = W, C, cond, U, K, reverse) of glowchain on the standalone models'
# paths: each scale a plan takes, sampled (reverse, B=16) and trained
# (forward: GlowImage's 96 frames, cGlow's 16 images)
STANDALONE_CHAINS = [(b, hw, c, cc, u, k, rev)
                     for hw, c, cc, u, k, b_train in ((16, 8, 8, 128, 8, 96),
                                                      (8, 16, 8, 128, 8, 96),
                                                      (16, 12, 32, 256, 4, 16),
                                                      (8, 24, 32, 256, 4, 16))
                     for b, rev in ((16, True), (b_train, False))]
# x [B·H·W, C] of the folded 1x1 (every module-path step's forward):
# GlowImage's three scales at 96 frames, cGlow's two at B=16
STANDALONE_AINV = [(96 * 1024, 4), (96 * 256, 8), (96 * 64, 16), (16 * 256, 12),
                   (16 * 64, 24)]
# (B, H = W, C/2, reverse) of the coupling tail: GlowImage's scale 0 sampled
# (the one scale without a plan), then its three scales and cGlow's two trained
STANDALONE_COUPLING = [(16, 32, 2, True), (96, 32, 2, False), (96, 16, 4, False),
                       (96, 8, 8, False), (16, 16, 6, False), (16, 8, 12, False)]
# card vs CPU of the standalone models: the nll within TOL_STEP_LOSS·(1+|ref|);
# the gradients of the base prior's output conv and of the learned base
# condition (a direct term) and of the first coupling net's first conv and
# scale 0's learned condition (through the flow's stream) as phase 7's; a
# sample elementwise within phase 5's tolerance of a first predicted frame
GLOW_GRADS = (("flow.prior_out.conv.kernel", "base", "flow.split0.conv.conv.kernel"),
              ("cond_0", "flow.scale0_step0.affine.net0.conv.kernel"))
CGLOW_GRADS = (("flow.prior_out.conv.kernel", "flow.split0.conv.conv.kernel"),
               ("enc0.kernel", "flow.scale0_step0.affine.net0.conv.kernel"))
# the two-moons learning check of test_two_moons_training.py, at the issue's
# widths: 6 couplings of 64 units, 512 points per step, 400 Adam steps
MOONS_STEPS, MOONS_N = 400, 512


def check_standalone_shapes(record):
    """Phase 16's kernels against their plain versions at the shapes the
    standalone models give them, with phase 3's tolerances, a bit-for-bit
    repeat and device times beside their bounds. Returns per kernel the
    worst error and the times summed over its shapes."""
    from recurrent_flows_tpu_torch.ops import (actnorm_invconv, actnorm_invconv_ref,
                                               coupling_transform, coupling_transform_ref,
                                               glowchain, glowchain_ref)

    g = torch.Generator(device="cuda").manual_seed(16)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    out = {}

    def add(name, row):
        t = out.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                      library_ms=None, n_bytes=0, flops=0))
        t["max_abs_err"] = max(t["max_abs_err"], row["err"])
        for k in ("ms", "plain_ms", "n_bytes", "flops"):
            t[k] += row[k]
        if row.get("library_ms") is not None:
            t["library_ms"] = (t["library_ms"] or 0.0) + row["library_ms"]
        row.update(bound(row["n_bytes"], row["flops"]))
        record.setdefault(name, []).append(row)
        print(f"{name} {row['shape']}{' reverse' if row.get('reverse') else ''}: err "
              f"{row['err']:.3e}, {row['ms']:.5f} ms, plain {row['plain_ms']:.5f}"
              + (f", library {row['library_ms']:.5f}" if row.get("library_ms") else "")
              + f", bound {row['bound_ms']:.6f} ({row['bound_by']})")

    for rows, c in STANDALONE_AINV:
        x, bias, logs = rnd(rows, c), rnd(c, scale=0.3), rnd(c, scale=0.3)
        w = torch.linalg.qr(rnd(c, c))[0].contiguous()
        e = check_elementwise(f"actnorm_invconv [{rows}, {c}]",
                              (actnorm_invconv(x, bias, logs, w),),
                              (actnorm_invconv_ref(x, bias, logs, w),), (TOL_INVCONV,))
        check_repeats(f"actnorm_invconv [{rows}, {c}]",
                      lambda: (actnorm_invconv(x, bias, logs, w),))
        add("actnorm_invconv", dict(
            shape=[rows, c], err=e, **ainv_times(actnorm_invconv, x, bias, logs, w),
            plain_ms=small_ms(lambda: actnorm_invconv_ref(x, bias, logs, w)),
            n_bytes=nbytes(x, bias, logs, w, x), flops=2 * x.numel() * c + 2 * x.numel()))
    for shape, rev, (z2, shift, s) in coupling_cases(rnd, STANDALONE_COUPLING):
        e = max(check_elementwise(f"coupling_transform {shape} reverse={r}",
                                  coupling_transform(z2, shift, s, r),
                                  coupling_transform_ref(z2, shift, s, r),
                                  (TOL_ELEMENTWISE, TOL_COUPLING_LD)) for r in (False, True))
        check_repeats(f"coupling_transform {shape}",
                      lambda: coupling_transform(z2, shift, s, rev))
        add("coupling_transform", dict(
            shape=shape, reverse=rev, err=e,
            **coupling_times(coupling_transform, z2, shift, s, rev),
            plain_ms=small_ms(lambda: coupling_transform_ref(z2, shift, s, rev)),
            n_bytes=nbytes(z2, shift, s, z2) + 4 * shape[0], flops=4 * z2.numel()))
    for b, hw, c, cc, u, k, rev in STANDALONE_CHAINS:
        ps = glow_params(rnd, k, c, cc, u)
        x, cond = rnd(b, hw, hw, c), rnd(b, hw, hw, cc)
        shape = [b, hw, hw, c]
        got = glowchain(x, cond, ps, "realnvp", rev)
        torch.cuda.synchronize()
        e = check_elementwise(f"glowchain {shape} cond {cc} K={k} reverse={rev}", got,
                              glowchain_ref(x, cond, ps, "realnvp", rev),
                              (TOL_CHAIN, TOL_CHAIN_LD))
        check_repeats(f"glowchain {shape} reverse={rev}",
                      lambda: glowchain(x, cond, ps, "realnvp", rev))
        add("glowchain", dict(
            shape=shape, cond=cc, u=u, k=k, reverse=rev, err=e,
            ms=cuda_ms(lambda: glowchain(x, cond, ps, "realnvp", rev), iters=5),
            plain_ms=cuda_ms(lambda: glowchain_ref(x, cond, ps, "realnvp", rev), iters=5),
            n_bytes=nbytes(x, cond, *ps, x) + 4 * b, flops=k * glowstep_flops(x, cond, u)))
    for t in out.values():
        t.update(bound(t.pop("n_bytes"), t.pop("flops")))
    return out


def no_kernels(**counts) -> dict:
    """A launch count of every kernel: 0 unless given."""
    return {**dict.fromkeys(SOURCES, 0), **counts}


def grads_card_vs_cpu(label, cpu, gpu, direct, stream) -> dict:
    """The named gradients of two copies of a model after the same
    backward, card against CPU, within phase 7's tolerances of the largest
    |entry|."""
    tols = {**dict.fromkeys(direct, TOL_STEP_GRAD_DIRECT),
            **dict.fromkeys(stream, TOL_STEP_GRAD_STREAM)}
    g_cpu, g_gpu = dict(cpu.named_parameters()), dict(gpu.named_parameters())
    errs = {}
    for n, tol in tols.items():
        ref = g_cpu[n].grad
        scale = ref.abs().max().item()
        errs[n] = (g_gpu[n].grad.cpu() - ref).abs().max().item() / scale
        if not (scale > 0 and errs[n] <= tol):
            raise AssertionError(f"{label}: gradient of {n} disagrees, {errs[n]:.2e} of "
                                 f"max |g| {scale:.2e} (> {tol})")
    print(f"{label} card vs CPU gradients, err of max |g|: "
          + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()))
    return errs


def nll_card_vs_cpu(label, cpu_nll, gpu_nll) -> float:
    err = ((gpu_nll.detach().cpu() - cpu_nll.detach()).abs()
           / (1 + cpu_nll.detach().abs())).max().item()
    if not err <= TOL_STEP_LOSS:
        raise AssertionError(f"{label}: nll card vs CPU {err:.2e} of 1+|ref|")
    return err


def sample_card_vs_cpu(label, cpu_fn, gpu_fn) -> float:
    """One sample on the CPU with recorded draws and on the card with them
    replayed; the largest |err| within phase 5's first-frame tolerance."""
    from recurrent_flows_tpu_torch.utils import NoiseSource

    rec = RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(7)))
    with torch.no_grad():
        ref = cpu_fn(rec)
        got = gpu_fn(NoiseSource(replay=rec.draws)).cpu()
    err = (got - ref).abs().max().item()
    if not (torch.isfinite(got).all() and err <= TOL_FIRST_FRAME):
        raise AssertionError(f"{label}: sample card vs CPU max |err| {err:.3e}")
    return err


def glow_image_phase(record) -> dict:
    """GlowImage on Moving MNIST made on the card: ``Trainer.build`` (DDI),
    steps of A (``chain_impl='off'``) and one of C (``'all'``), then
    ``sample(16)`` with ``chain_impl='sample'`` (a warm-up and 3
    requests), exact launches; then one small step and a sample, card
    against CPU."""
    from recurrent_flows_tpu_torch.config import GlowConfig, TrainConfig
    from recurrent_flows_tpu_torch.data import MovingMNIST
    from recurrent_flows_tpu_torch.flows.glow import kernel_fits
    from recurrent_flows_tpu_torch.models import GlowImage
    from recurrent_flows_tpu_torch.training import Trainer
    from recurrent_flows_tpu_torch.utils import NoiseSource, float32_precision

    cfg = GlowConfig(L=3, K=8, n_units_affine=128, n_units_prior=128)
    tcfg = TrainConfig(batch_size=GLOW_B, n_frames=GLOW_T, learning_rate=2e-4)

    def model_for(chain_impl, state=None):
        m = GlowImage(1, GLOW_IMG, dataclasses.replace(cfg, chain_impl=chain_impl),
                      cond_channels=GLOW_COND, base_channels=GLOW_COND, device="cuda",
                      generator=torch.Generator().manual_seed(0))
        if state is None:
            perturb_(m, seed=1)
        else:
            m.load_state_dict(state)
        return m

    data = MovingMNIST(digit_bank="synthetic", digit_size=GLOW_IMG // 2, num_digits=1,
                       seq_len=GLOW_T, image_size=GLOW_IMG, device="cuda")
    model = model_for("off")
    chain_scales = [l for l, (hw, c, cc) in enumerate(model.flow.scale_shapes)
                    if kernel_fits(cfg, GLOW_B, hw, hw, c, cc)]
    frames = GLOW_B * GLOW_T
    train_scales = [l for l, (hw, c, cc) in enumerate(model.flow.scale_shapes)
                    if kernel_fits(cfg, frames, hw, hw, c, cc)]
    if chain_scales != [1, 2] or train_scales != [1, 2]:
        raise AssertionError(f"GlowImage: glowchain takes scales {chain_scales} at B=16 "
                             f"and {train_scales} at 96 frames, expected [1, 2]")
    t0 = time.perf_counter()
    trainer = Trainer(model, tcfg, data, device="cuda").build()
    torch.cuda.synchronize()
    rec = dict(build_s=time.perf_counter() - t0, steps={})
    kl = cfg.L * cfg.K
    paths = {}
    for name, impl, n_steps, want in (
            ("A", "off", GLOW_STEPS_A, no_kernels(actnorm_invconv=kl, coupling_transform=kl)),
            ("C", "all", 1, no_kernels(actnorm_invconv=cfg.K, coupling_transform=cfg.K,
                                       glowchain=2))):
        if impl != "off":
            trainer.model = model_for(impl, model.state_dict())
            trainer.optimizer = trainer._adam()
        total, steps = dict.fromkeys(SOURCES, 0), []
        for i in range(n_steps):
            batch = data.sample(trainer.generator, GLOW_B)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m, counts = launched(lambda: {k: float(v) for k, v in trainer.train_step(
                batch, 1.0, tcfg.learning_rate).items()})
            ms = (time.perf_counter() - t0) * 1e3
            if counts != want or not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"GlowImage step {name}: launches {counts}, expected "
                                     f"{want}; metrics {m}")
            for k, v in counts.items():
                total[k] += v
            gib = torch.cuda.max_memory_allocated() / 2**30
            steps.append(dict(ms=ms, peak_gib=gib, **m))
            print(f"GlowImage step {name} {i}: {ms:.1f} ms, peak {gib:.2f} GiB, nll "
                  f"{m['nll']:.1f}, {m['bits']:.4f} bits/dim, launches {counts}")
        rec["steps"][name] = steps
        paths[f"glow_image_train_{name}"] = total
    sampler = model_for("sample", trainer.model.state_dict())
    want = no_kernels(coupling_transform=cfg.K, glowchain=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        sampler.sample(GLOW_B, NoiseSource(generator=gen))  # warm-up
        total, ms_list = dict.fromkeys(SOURCES, 0), []
        for i in range(N_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, counts = launched(lambda: sampler.sample(GLOW_B, NoiseSource(generator=gen)))
            torch.cuda.synchronize()
            ms_list.append((time.perf_counter() - t0) * 1e3)
            if counts != want or x.shape != (GLOW_B, GLOW_IMG, GLOW_IMG, 1) \
                    or not torch.isfinite(x).all():
                raise AssertionError(f"GlowImage sample {i}: launches {counts}, expected "
                                     f"{want}; shape {tuple(x.shape)}")
            for k, v in counts.items():
                total[k] += v
    paths["glow_image_sample"] = total
    rec["sample_ms"] = ms_list
    print(f"GlowImage sample({GLOW_B}): {', '.join(f'{t:.1f}' for t in ms_list)} ms, "
          f"launches {want} each; max |x| {x.abs().max().item():.3f}")

    # card vs CPU: one step's nll and named gradients on 2x2 frames, a sample of 2
    gpu = model_for("off", trainer.model.state_dict())
    cpu = copy.deepcopy(gpu).cpu()
    x = data.sample(torch.Generator(device="cuda").manual_seed(4), 2)[:, :2] - 0.5
    noise = RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(5)))
    with float32_precision():
        nll_cpu = cpu(x.cpu(), noise)
        nll_gpu = gpu(x, NoiseSource(replay=noise.draws))
        nll_cpu.mean().backward()
        nll_gpu.mean().backward()
        rec["card_vs_cpu"] = dict(
            nll=nll_card_vs_cpu("GlowImage", nll_cpu, nll_gpu),
            grads=grads_card_vs_cpu("GlowImage", cpu, gpu, *GLOW_GRADS),
            sample=sample_card_vs_cpu("GlowImage", lambda n: cpu.sample(2, n),
                                      lambda n: gpu.sample(2, n)))
    print(f"GlowImage card vs CPU: {rec['card_vs_cpu']}")
    record["glow_image"] = rec
    return paths


def cglow_phase(record) -> dict:
    """cGlow on a PNG tree of procedural colour images the phase writes,
    through ``prepare_celeba`` -> ``get_celeba`` ->
    ``get_joint_conditioned_data(box=8)`` (context the boxed image, target
    the image): the data-dependent init, Adam steps and samples with exact
    launches, then card against CPU."""
    import shutil

    from recurrent_flows_tpu_torch.config import GlowConfig
    from recurrent_flows_tpu_torch.data import (get_celeba, get_joint_conditioned_data,
                                                prepare_celeba)
    from recurrent_flows_tpu_torch.data.png import write_png
    from recurrent_flows_tpu_torch.models import ConditionalGlowImage
    from recurrent_flows_tpu_torch.utils import NoiseSource, float32_precision

    raw = STANDALONE_DIR / "celeba_raw"
    shutil.rmtree(STANDALONE_DIR, ignore_errors=True)
    raw.mkdir(parents=True)
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[:54, :44] / 44.0
    for i in range(CGLOW_IMAGES):  # non-square like img_align_celeba: smooth colour fields
        f = rng.uniform(1, 4, 3)
        img = 0.5 + 0.5 * np.sin(f * (yy[..., None] + 0.7 * xx[..., None])
                                 + rng.uniform(0, 6, 3))
        write_png(str(raw / f"{i:06d}.png"), np.rint(img * 255).astype(np.uint8))
    t0 = time.perf_counter()
    n = prepare_celeba(str(raw), str(STANDALONE_DIR / "data" / "celeba_32.pkl"),
                       size=CGLOW_IMG, device="cuda")
    images = get_celeba(str(STANDALONE_DIR / "data"))
    boxed, inner = get_joint_conditioned_data(images, box=8)
    rec = dict(prepare_s=time.perf_counter() - t0, n_images=n)
    if images.shape != (CGLOW_IMAGES, CGLOW_IMG, CGLOW_IMG, 3) or inner.shape[1:] != (8, 8, 3):
        raise AssertionError(f"cGlow data: {images.shape}, {inner.shape}")
    ctx_all = torch.tensor(boxed, device="cuda") - 0.5
    x_all = torch.tensor(images, device="cuda") - 0.5

    cfg = GlowConfig(L=2, K=4)

    def model_for(chain_impl, state=None):
        m = ConditionalGlowImage(3, CGLOW_IMG, dataclasses.replace(cfg, chain_impl=chain_impl),
                                 cond_channels=CGLOW_COND, device="cuda",
                                 generator=torch.Generator().manual_seed(0))
        if state is not None:
            m.load_state_dict(state)
        return m

    model = model_for("off")
    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad(), float32_precision():
        model.ddi(x_all[:CGLOW_B], ctx_all[:CGLOW_B], NoiseSource(generator=gen))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    kl = cfg.L * cfg.K
    want = no_kernels(actnorm_invconv=kl, coupling_transform=kl)
    total, losses, step_ms = dict.fromkeys(SOURCES, 0), [], []
    for i in range(CGLOW_STEPS):
        sl = slice(i * CGLOW_B, (i + 1) * CGLOW_B)
        t0 = time.perf_counter()

        def step():
            opt.zero_grad(set_to_none=True)
            with float32_precision():
                loss = model.log_prob(x_all[sl], ctx_all[sl], NoiseSource(generator=gen)).mean()
                loss.backward()
            opt.step()
            return loss.item()
        loss, counts = launched(step)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if counts != want or not np.isfinite(loss):
            raise AssertionError(f"cGlow step {i}: launches {counts}, expected {want}; "
                                 f"loss {loss}")
        for k, v in counts.items():
            total[k] += v
        losses.append(loss)
    paths = {"cglow_train": total}
    sampler = model_for("sample", model.state_dict())
    want_s = no_kernels(glowchain=cfg.L)
    total, sample_ms = dict.fromkeys(SOURCES, 0), []
    with torch.no_grad():
        for i in range(N_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, counts = launched(lambda: sampler.sample(ctx_all[:CGLOW_B],
                                                        NoiseSource(generator=gen)))
            torch.cuda.synchronize()
            sample_ms.append((time.perf_counter() - t0) * 1e3)
            if counts != want_s or s.shape != (CGLOW_B, CGLOW_IMG, CGLOW_IMG, 3) \
                    or not torch.isfinite(s).all():
                raise AssertionError(f"cGlow sample {i}: launches {counts}, expected "
                                     f"{want_s}; shape {tuple(s.shape)}")
            for k, v in counts.items():
                total[k] += v
    paths["cglow_sample"] = total
    rec.update(losses=losses, step_ms=step_ms, sample_ms=sample_ms)
    print(f"cGlow: {n} images prepared in {rec['prepare_s']:.2f} s; steps "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} ms (launches {want}), nll {losses}; "
          f"samples {', '.join(f'{t:.1f}' for t in sample_ms)} ms (launches {want_s})")

    gpu = model_for("off", model.state_dict())
    cpu = copy.deepcopy(gpu).cpu()
    x, ctx = x_all[:2], ctx_all[:2]
    noise = RecordedNoise(NoiseSource(generator=torch.Generator().manual_seed(5)))
    with float32_precision():
        nll_cpu = cpu.log_prob(x.cpu(), ctx.cpu(), noise)
        nll_gpu = gpu.log_prob(x, ctx, NoiseSource(replay=noise.draws))
        nll_cpu.mean().backward()
        nll_gpu.mean().backward()
        rec["card_vs_cpu"] = dict(
            nll=nll_card_vs_cpu("cGlow", nll_cpu, nll_gpu),
            grads=grads_card_vs_cpu("cGlow", cpu, gpu, *CGLOW_GRADS),
            sample=sample_card_vs_cpu("cGlow", lambda n: cpu.sample(ctx.cpu(), n),
                                      lambda n: gpu.sample(ctx, n)))
    print(f"cGlow card vs CPU: {rec['card_vs_cpu']}")
    record["cglow"] = rec
    return paths


def toy_models_phase(record):
    """VRNN-1D on sinusoids (30 Adam steps, the loss must fall; a
    ``predict``), RealNVP-2D on two-moons (400 steps, both thresholds of
    ``test_two_moons_training.py``), one step each of the conditional
    RealNVP on rotating moons and ``AutoregFlow2D``. No kernel of the port
    runs here: these are small dense programs."""
    from recurrent_flows_tpu_torch.data import (RotatingTwoMoonsConditionalSampler,
                                                SinusWithNoise, two_moons)
    from recurrent_flows_tpu_torch.flows import AutoregFlow2D, RealNVP2D
    from recurrent_flows_tpu_torch.models import VRNN1D
    from recurrent_flows_tpu_torch.utils import NoiseSource, float32_precision

    gen = torch.Generator(device="cuda").manual_seed(8)
    noise = NoiseSource(generator=gen)
    rec = {}

    def adam_steps(model, loss_fn, steps, lr):
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            with float32_precision():
                loss = loss_fn()
                loss.backward()
            opt.step()
            losses.append(loss.detach())
        losses = [float(v) for v in losses]
        return losses, (time.perf_counter() - t0) * 1e3 / steps

    vrnn = VRNN1D(device="cuda", generator=torch.Generator().manual_seed(0))
    data = SinusWithNoise(seq_len=100, device="cuda")

    def vrnn_loss():
        out = vrnn.loss(data.sample(gen, 32), noise)
        return out["nll"] + out["kl_free_bits"]
    (losses, ms), counts = launched(lambda: adam_steps(vrnn, vrnn_loss, 30, 3e-3))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"VRNN-1D: the loss did not fall: {losses[0]} -> {losses[-1]}")
    with torch.no_grad():
        true_x, preds = vrnn.predict(data.sample(gen, 32), 5, 4, noise)
    if preds.shape != (5, 32, 1) or true_x.shape != (4, 32, 1) or not torch.isfinite(preds).all():
        raise AssertionError(f"VRNN-1D predict: {tuple(preds.shape)}")
    rec["vrnn1d"] = dict(first_loss=losses[0], last_loss=losses[-1], ms_per_step=ms)
    print(f"VRNN-1D (h 64, z 8, feat 32; sinusoids B=32, T=100): 30 steps, loss "
          f"{losses[0]:.1f} -> {losses[-1]:.1f}, {ms:.1f} ms/step; predict(5, 4) "
          f"{tuple(preds.shape)}")

    flow = RealNVP2D(n_couplings=6, hidden=64, device="cuda",
                     generator=torch.Generator().manual_seed(1))
    moons_nll = lambda: -flow.log_prob(two_moons(noise, MOONS_N, device="cuda")).mean()  # noqa: E731
    (losses, ms), c2 = launched(lambda: adam_steps(flow, moons_nll, MOONS_STEPS, 2e-3))
    with torch.no_grad():
        samples = flow.sample(MOONS_N, noise)
        ref = two_moons(noise, 2048, device="cuda")
        dist = torch.cdist(samples, ref).min(1).values.mean().item()
    if not (losses[-1] < losses[0] - 0.5 and dist < 0.25):
        raise AssertionError(f"RealNVP-2D: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
                             f"(must fall by > 0.5), sample distance {dist:.3f} (< 0.25)")
    rec["realnvp2d"] = dict(first_loss=losses[0], last_loss=losses[-1], ms_per_step=ms,
                            sample_mean_distance=dist)
    print(f"RealNVP-2D (6 couplings, 64 units; two-moons, {MOONS_N} a step): "
          f"{MOONS_STEPS} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}, {ms:.2f} "
          f"ms/step; samples' mean distance to the moons {dist:.4f}")

    cond = RealNVP2D(n_couplings=6, hidden=64, context_dim=1, device="cuda")
    moons = RotatingTwoMoonsConditionalSampler(device="cuda")
    x, theta = next(moons.loader(noise, MOONS_N, 1))
    (cl, _), c3 = launched(lambda: adam_steps(cond, lambda: -cond.log_prob(x, theta).mean(),
                                              1, 2e-3))
    auto = AutoregFlow2D(device="cuda")
    (al, _), c4 = launched(lambda: adam_steps(auto, lambda: -auto.log_prob(x).mean(), 1, 2e-3))
    if not np.isfinite(cl + al).all() or any(v for c in (counts, c2, c3, c4)
                                             for v in c.values()):
        raise AssertionError(f"conditional RealNVP {cl}, AutoregFlow2D {al}; launches "
                             f"{[counts, c2, c3, c4]}")
    rec["conditional_realnvp_loss"], rec["autoreg_loss"] = cl[0], al[0]
    print(f"conditional RealNVP on rotating moons: one step, loss {cl[0]:.3f}; "
          f"AutoregFlow2D: one step, loss {al[0]:.3f}")
    record["toy_models"] = rec


def rfn_vgg_ops_phase(record, rng) -> dict:
    """``rfn_mnist_production`` with the VGG ops: the extractor's first
    'pool' replaced by 'squeeze', the upscaler's first 'upsample' by
    'deconv' and its second by 'squeeze'. ``Trainer.build``, one step of A
    and one request (``chain_impl='sample'``), exact launches."""
    from recurrent_flows_tpu_torch.config import rfn_mnist_production
    from recurrent_flows_tpu_torch.models import RFN
    from recurrent_flows_tpu_torch.serving import Predictor
    from recurrent_flows_tpu_torch.training import Trainer

    mcfg, tcfg = rfn_mnist_production()
    ext, up = list(mcfg.extractor_structure), list(mcfg.upscaler_structure)
    ext[0] = tuple("squeeze" if op == "pool" else op for op in ext[0])
    up[1] = tuple("deconv" if op == "upsample" else op for op in up[1])
    up[2] = tuple("squeeze" if op == "upsample" else op for op in up[2])
    mcfg = dataclasses.replace(mcfg, extractor_structure=tuple(ext),
                               upscaler_structure=tuple(up))
    model = RFN(mcfg, device="cuda", generator=torch.Generator().manual_seed(0))
    perturb_(model, seed=1)
    batch = moving_squares(rng, tcfg.batch_size, tcfg.n_frames, mcfg.image_size)
    t0 = time.perf_counter()
    trainer = Trainer(model, tcfg, [batch], device="cuda").build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    want = train_launches(mcfg, "A", True, tcfg.n_frames - 1, [])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = counted("RFN with the VGG ops, step A", lambda: {k: float(v) for k, v in
                trainer.train_step(batch, tcfg.beta_min, tcfg.learning_rate).items()}, want)
    step_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"RFN with the VGG ops: metrics {m}")
    paths = {"rfn_vgg_train": want}
    served = RFN(with_glow(mcfg, chain_impl="sample"), device="cuda")
    served.load_state_dict(model.state_dict())
    pred = Predictor(served, tcfg, n_conditions=N_COND, n_predictions=N_PRED, seed=0,
                     device="cuda")
    want_r = request_launches(mcfg, range(1, mcfg.L), N_COND)
    ctx = moving_squares(rng, BATCH, N_COND, mcfg.image_size)
    pred.predict(ctx)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = counted("RFN with the VGG ops, request", lambda: pred.predict(ctx), want_r)
    request_ms = (time.perf_counter() - t0) * 1e3
    check_frames("RFN with the VGG ops, request", out,
                 (BATCH, N_PRED, mcfg.image_size, mcfg.image_size, 1))
    paths["rfn_vgg_request"] = want_r
    record["rfn_vgg_ops"] = dict(
        extractor=mcfg.extractor_structure, upscaler=mcfg.upscaler_structure,
        build_s=build_s, step_ms=step_ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        request_ms=request_ms, metrics=m)
    print(f"RFN with the VGG ops: build {build_s:.2f} s, step A {step_ms:.1f} ms (launches "
          f"{want}), request {request_ms:.1f} ms (launches {want_r})")
    return paths


def validate_glow(record):
    """``scripts/torch_validate_training.py --model glow --image_size 64``
    for 40 steps, in this process (``run_one``): its verdict is recorded
    and neither ``improved`` nor a finite loss is asserted. The JAX script
    diverges here as well: the data-dependent init sees the learned
    conditions at their zero init, so the actnorms of the nets that read
    only a condition (the base prior's, the splits') take logs =
    log(1/1e-6), and once Adam moves a condition their outputs explode
    (both packages on the CPU, 32x32: bits per dimension ~3 for three
    steps, then ~1e23)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_validate_training", ROOT / "scripts" / "torch_validate_training.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = mod.build_parser().parse_args(["--model", "glow", "--image_size", "64",
                                          "--steps", "40",
                                          "--out", str(STANDALONE_DIR / "validate")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        verdict = mod.run_one("glow", args)
    losses_png = STANDALONE_DIR / "validate" / "glow" / "png_folder" / "losses.png"
    if "plotter failed" in out.getvalue() or not losses_png.exists():
        raise AssertionError(f"torch_validate_training glow: {out.getvalue()[-500:]}")
    record["validate_glow"] = verdict
    print(f"torch_validate_training --model glow --image_size 64, 40 steps: {verdict}")


def standalone(rng, record) -> tuple:
    """Phase 16 (see the module docstring). Returns (launches per path,
    the kernels at the standalone models' shapes)."""
    from recurrent_flows_tpu_torch.utils import float32_precision

    t0 = time.perf_counter()
    with float32_precision():
        shapes = check_standalone_shapes(record.setdefault("kernels", {}))
    print(f"phase 16 kernels done in {time.perf_counter() - t0:.0f} s")
    paths = glow_image_phase(record)
    paths.update(cglow_phase(record))
    toy_models_phase(record)
    paths.update(rfn_vgg_ops_phase(record, rng))
    validate_glow(record)
    torch.cuda.empty_cache()
    return paths, shapes


SOURCES = {
    "coupling_transform": ("cuda", "recurrent_flows_tpu_torch/csrc/coupling.cu",
                           "recurrent_flows_tpu/ops/pallas/fused.py:75"),
    "actnorm_invconv": ("cuda", "recurrent_flows_tpu_torch/csrc/actnorm_invconv.cu",
                        "recurrent_flows_tpu/ops/pallas/fused.py:166"),
    "convlstm_gates": ("cuda", "recurrent_flows_tpu_torch/csrc/convlstm_gates.cu",
                       "recurrent_flows_tpu/ops/pallas/fused.py:257"),
    "glowstep": ("cuda", "recurrent_flows_tpu_torch/csrc/glowstep.cu",
                 "recurrent_flows_tpu/ops/pallas/glowstep.py:164"),
    "glowchain": ("cuda", "recurrent_flows_tpu_torch/csrc/glowchain.cu",
                  "recurrent_flows_tpu/ops/pallas/glowchain.py:84"),
}


# --- phase 17: the spatial grid ------------------------------------------------
# Two processes share the card over gloo on a 1x2 (data x model) grid
# (``parallel.make_mesh``), each holding half the rows of every frame:
# rfn_mnist_production's steps A, B and C at B=30, T=10 against the
# one-process step from the same weights and draws, both without
# recomputation (it would repeat a third of the exchanges, each 2-4 ms on
# a shared card; tests/test_torch_mesh.py runs the grid with it), with exact halo,
# gather and launch counts per rank, then one srnn_mnist step. The bar:
# loss, kl and nll within 1e-5 relative (tests/test_torch_mesh.py's);
# each gradient element within rtol 5e-5 plus its tensor's noise floor,
# and each updated parameter within rtol 5e-5, atol 1e-6 where its
# gradient is above that floor (below it, rounding noise held by the
# gradient, as tests/test_torch_distributed.py holds its G_FLOOR). The
# floor is GRID_T_FLOOR of the tensor's largest gradient entry, and never
# below GRID_G_FLOOR of the model's largest (the CPU tests' G_FLOOR: conv
# biases in front of a batch norm have gradients that are zero in exact
# arithmetic). On the card the sharded step runs every conv at other
# shapes, so cuDNN picks other forward algorithms, and the float32
# difference grows through the ill-conditioned backward as it does across
# devices: phase 6 holds the card against the CPU at 3e-2 of a stream
# tensor's largest entry (TOL_STEP_GRAD_STREAM). Measured by this phase on
# an NVIDIA H100 80GB HBM3 at 700 W: up to 2.98e-2 of a tensor's largest
# entry (extractor.b4_1.kernel, step B) and 1.2e-3 of the model's; so the
# floor is 5e-2.
GRID_DIR = ROOT / "runs" / "chip_smoke_grid"
GRID_SEEDS = (170, 171)  # the warm-up step's noise, the timed step's
GRID_G_FLOOR, GRID_T_FLOOR = 1e-5, 5e-2
GRID_RTOL_METRICS, GRID_RTOL, GRID_ATOL = 1e-5, 5e-5, 1e-6


def grid_exchanges(mcfg, config: str, frames: int, kernel_scales, remat: bool = True) -> dict:
    """Halo exchanges and row gathers of one rank's RFN train step over
    ``frames`` + 1 frames on a 1x2 grid where every map keeps at least one
    row per rank (rfn_mnist_production: 64x64 down to its 2x2 latent).
    Every 3x3 conv exchanges halo rows: the extractor's (once over all
    frames), the h-LSTM's gate conv per frame, and per frame the prior's and
    encoder's convs and parameter conv, the upscaler's convs and the flow's
    (per module-path GlowStep the coupling's two 3x3; per split two; the base
    prior's three); a kernel scale runs none but gathers its rows: per
    GlowStep x and the condition (B), per scale (C). With recomputation the
    per-frame steps run their forward twice. The backward exchanges once per
    forward exchange of a tensor that needs a gradient: not the frames' own
    (the extractor's first conv, and the gathered z of a kernel scale 0)."""
    ext = sum(1 for block in mcfg.extractor_structure for op in block if op != "pool")
    up = sum(1 for block in mcfg.upscaler_structure for op in block if isinstance(op, int))
    nets = len(mcfg.prior_structure) + len(mcfg.encoder_structure) + 2
    n_kernel = len(kernel_scales) if config in ("B", "C") else 0
    flow = 2 * mcfg.K * (mcfg.L - n_kernel) + 2 * (mcfg.L - 1) + 3
    per_frame = nets + up + flow
    gathers = {"A": 0, "B": 2 * mcfg.K * n_kernel, "C": 2 * n_kernel}[config]
    passes = 2 if remat else 1
    return dict(halo=ext + frames + passes * frames * per_frame,
                halo_grad=ext - 1 + frames + frames * per_frame,
                gather=passes * frames * gathers,
                gather_grad=frames * (gathers - (n_kernel and 0 in kernel_scales)))


def srnn_grid_exchanges(frames: int, remat: bool = True) -> dict:
    """The same for srnn_mnist (64x64, PhiX to 8x8, smoothing) on 1x2:
    PhiX's four convs once over all frames, the two LSTMs' gate convs per
    frame, and per frame PhiZ's conv three times (the posterior's, the
    prior's and the decoder's latent maps), the two Gaussian heads' stride-2
    convs, the decoder's three transposed and two 3x3 convs and the
    likelihood's conv; each head gathers its 4x4 map before its dense
    layers."""
    passes = 2 if remat else 1
    per_frame, gathers = 3 + 2 + 5 + 1, 2
    return dict(halo=4 + 2 * frames + passes * frames * per_frame,
                halo_grad=3 + 2 * frames + frames * per_frame,
                gather=passes * frames * gathers, gather_grad=frames * gathers)


def check_grid_kernels(record) -> dict:
    """The three pointwise kernels at the local shapes a rank of the 1x2
    grid gives them (half the rows of rfn_mnist_production's B=30 step:
    the gates on [30, 1, 2, 800], the coupling and the folded 1x1 on each
    flow scale's [30, hw/2, hw, c]), each against its plain version within
    phase 3's tolerances, with a bit-for-bit repeat. Returns per kernel the
    worst error and the rows."""
    from recurrent_flows_tpu_torch.ops import (
        actnorm_invconv, actnorm_invconv_ref, convlstm_gates, convlstm_gates_ref,
        coupling_transform, coupling_transform_ref)

    g = torch.Generator(device="cuda").manual_seed(17)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    out = {}

    def add(name, shape, err):
        t = out.setdefault(name, dict(max_abs_err=0.0, rows=[]))
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["rows"].append(dict(shape=shape, err=err))

    b = TRAIN_BATCH
    gates, c = rnd(b, 1, 2, 800), rnd(b, 1, 2, 200)
    peeps = [rnd(1, 1, 2, 200, scale=0.1) for _ in range(3)]
    add("convlstm_gates", [b, 1, 2, 800], check_elementwise(
        "convlstm_gates [30,1,2,800]", convlstm_gates(gates, c, *peeps),
        convlstm_gates_ref(gates, c, *peeps), (TOL_ELEMENTWISE,) * 2))
    check_repeats("convlstm_gates [30,1,2,800]", lambda: convlstm_gates(gates, c, *peeps))
    for l in range(5):
        hw, ch = 32 >> l, 4 << l
        x, net = rnd(b, hw // 2, hw, ch), rnd(b, hw // 2, hw, ch, scale=0.5)
        z2, shift, s = x[..., ch // 2:], net[..., 0::2], torch.tanh(net[..., 1::2])
        for rev in (False, True):
            name = f"coupling_transform [{b},{hw // 2},{hw},{ch // 2}] reverse={rev}"
            add("coupling_transform", [b, hw // 2, hw, ch // 2], check_elementwise(
                name, coupling_transform(z2, shift, s, rev),
                coupling_transform_ref(z2, shift, s, rev), (TOL_ELEMENTWISE, TOL_COUPLING_LD)))
            check_repeats(name, lambda: coupling_transform(z2, shift, s, rev))
        flat = x.reshape(-1, ch)
        bias, logs = rnd(ch, scale=0.3), rnd(ch, scale=0.3)
        w = torch.linalg.qr(rnd(ch, ch))[0].contiguous()
        name = f"actnorm_invconv [{flat.shape[0]}, {ch}]"
        add("actnorm_invconv", list(flat.shape), check_elementwise(
            name, (actnorm_invconv(flat, bias, logs, w),),
            (actnorm_invconv_ref(flat, bias, logs, w),), (TOL_INVCONV,)))
        check_repeats(name, lambda: actnorm_invconv(flat, bias, logs, w))
    for name, t in out.items():
        print(f"{name} at the grid's local shapes: max |err| {t['max_abs_err']:.3e} over "
              f"{len(t['rows'])} shapes")
    record["kernels"] = out
    return out


def _grid_models():
    """(name, model config) of phase 17's RFN steps."""
    from recurrent_flows_tpu_torch.config import rfn_mnist_production

    mcfg, _ = rfn_mnist_production()
    return dict(A=mcfg, B=with_glow(mcfg, coupling_impl="fused"),
                C=with_glow(mcfg, chain_impl="all"))


def _grid_step(trainer, state, batch, seed, mesh=None):
    """One train step from ``state`` with a fresh Adam and the noise of
    ``seed``: (metrics, ms, launches, the step's gradients, parameters)."""
    from recurrent_flows_tpu_torch import ops
    from recurrent_flows_tpu_torch.utils import NoiseSource

    trainer.model.load_state_dict(state)
    trainer.optimizer = trainer._adam()
    noise = NoiseSource(generator=torch.Generator(device="cuda").manual_seed(seed))
    if mesh is not None:
        mesh.reset_counts()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = trainer.train_step(batch, beta=1e-4, lr=1e-4, noise=noise)
    m = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    model = trainer.model
    return dict(metrics=m, ms=ms, launches=ops.launch_counts(),
                grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()
                       if p.grad is not None},
                params={n: p.detach().cpu() for n, p in model.named_parameters()})


def grid_rank(rank: int, world: int, port: int) -> None:
    """One rank of phase 17 (``python3 chip_smoke.py --grid-rank R W PORT``):
    joins a gloo group with the other rank on the same card, makes the 1x2
    grid, and per case of ``GRID_DIR/case.pt`` builds the model from the
    saved state, takes the warm-up and the timed step and writes
    ``GRID_DIR/<case>_rank<R>.pt`` (both steps' metrics, ms, launches,
    exchanges and host seconds in them; the timed step's gradients and
    parameters; the devices every parameter, gradient and module output
    lay on)."""
    from datetime import timedelta

    import torch.distributed as dist

    from recurrent_flows_tpu_torch import models
    from recurrent_flows_tpu_torch.parallel import make_mesh
    from recurrent_flows_tpu_torch.training import Trainer

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=300))
    mesh = make_mesh(n_model=world, device="cuda:0")
    case = torch.load(GRID_DIR / "case.pt", weights_only=False)
    for name, c in case.items():
        model = getattr(models, c["family"])(c["config"], device="cuda", remat=False,
                                             generator=torch.Generator(device="cuda"))
        devices = set()

        def note(module, inputs, output):
            for t in (output if isinstance(output, (tuple, list)) else (output,)):
                if isinstance(t, torch.Tensor):
                    devices.add(t.device.type)

        hooks = [m.register_forward_hook(note) for m in model.modules()]
        tr = Trainer(model, c["tcfg"], [], device="cuda", dp=mesh).build(run_ddi=False)
        steps = []
        for batch, seed in zip(c["batches"], GRID_SEEDS):
            local = mesh.local(torch.as_tensor(batch, device="cuda"))
            s = _grid_step(tr, c["state"], local, seed, mesh)
            s.update(counts=dict(mesh.counts), exchange_ms=mesh.exchange_s * 1e3)
            steps.append(s)
        for h in hooks:
            h.remove()
        devices |= {p.device.type for p in model.parameters()}
        devices |= {p.grad.device.type for p in model.parameters() if p.grad is not None}
        timed = steps[-1]
        for s in steps[:-1]:
            del s["grads"], s["params"]
        if rank:  # rank 0's tensors are compared in full; this rank's must equal them
            for key in ("grads", "params"):
                timed[key + "_sums"] = {n: (float(t.double().sum()), float(t.double().square().sum()))
                                        for n, t in timed.pop(key).items()}
        torch.save(dict(steps=steps, devices=sorted(devices)), GRID_DIR / f"{name}_rank{rank}.pt")
        del tr, model
        torch.cuda.empty_cache()
        print(f"rank {rank} {name}: timed step {timed['ms']:.1f} ms, {timed['counts']}")
    dist.destroy_process_group()


def _grid_check(label, got, ref, errors) -> dict:
    """The bar (see above) of one rank's timed step against the
    one-process step's; appends what fails to ``errors``. Returns the
    largest relative metric error, the largest gradient difference
    against its tensor's largest entry and against the model's (with the
    tensors), and the parameter elements held by value and by gradient."""
    out = dict(metric_rel_err=0.0, held=0, noise=0, grad_tensor=(0.0, ""),
               grad_model=(0.0, ""))
    for k in ("loss", "kl", "nll"):
        r = abs(got["metrics"][k] - ref["metrics"][k]) / abs(ref["metrics"][k])
        out["metric_rel_err"] = max(out["metric_rel_err"], r)
        if r > GRID_RTOL_METRICS:
            errors.append(f"{label} {k} {got['metrics'][k]} vs {ref['metrics'][k]}")
    if set(got["grads"]) != set(ref["grads"]):
        errors.append(f"{label}: gradients of other parameters")
        return out
    g_max = max(float(g.abs().max()) for g in ref["grads"].values())
    for n, g in ref["grads"].items():
        t_max = float(g.abs().max())
        floor = max(GRID_T_FLOOR * t_max, GRID_G_FLOOR * g_max)
        diff = (got["grads"][n] - g).abs()
        d = float(diff.max())
        out["grad_tensor"] = max(out["grad_tensor"], (d / max(t_max, 1e-30), n))
        out["grad_model"] = max(out["grad_model"], (d / g_max, n))
        if not torch.all(diff <= GRID_RTOL * g.abs() + floor):
            errors.append(f"{label} d{n}: max |diff| {d:.3e}, its largest {t_max:.3e}")
        determined = g.abs() > floor
        p, q = got["params"][n][determined], ref["params"][n][determined]
        out["held"] += int(determined.sum())
        out["noise"] += int((~determined).sum())
        if not torch.all((p - q).abs() <= GRID_ATOL + GRID_RTOL * q.abs()):
            errors.append(f"{label} {n}: max |diff| {float((p - q).abs().max()):.3e}")
    return out


def spatial_grid(record, card: str) -> dict:
    """Phase 17 (see the module docstring). Returns {path: launches of both
    ranks' timed steps}."""
    import os
    import sys

    from recurrent_flows_tpu_torch.config import rfn_mnist_production, srnn_mnist
    from recurrent_flows_tpu_torch.flows.glow import kernel_fits
    from recurrent_flows_tpu_torch.models import RFN, SRNN
    from recurrent_flows_tpu_torch.training import Trainer

    t_phase = time.perf_counter()
    GRID_DIR.mkdir(parents=True, exist_ok=True)
    record["kernel_checks"] = {}
    shapes = check_grid_kernels(record["kernel_checks"])
    rng = np.random.default_rng(17)
    kernel_scales = range(1, 5)
    frames = TRAIN_FRAMES - 1
    case, refs, want = {}, {}, {}
    _, tcfg = rfn_mnist_production()
    for name, cfg in _grid_models().items():
        model = RFN(cfg, device="cuda", remat=False,
                    generator=torch.Generator(device="cuda").manual_seed(0))
        perturb_(model, seed=1)
        batches = [moving_squares(rng, TRAIN_BATCH, TRAIN_FRAMES, 64) for _ in GRID_SEEDS]
        tr = Trainer(model, tcfg, batches).build(run_ddi=False)
        if name != "A":
            eligible = {l for l, (hw, c, cc) in enumerate(model.flow.scale_shapes)
                        if kernel_fits(cfg.glow, TRAIN_BATCH, hw, hw, c, cc)}
            if eligible != set(kernel_scales):
                raise AssertionError(f"grid {name}: kernel scales {sorted(eligible)}")
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        steps = [_grid_step(tr, state, torch.as_tensor(b, device="cuda"), s)
                 for b, s in zip(batches, GRID_SEEDS)]
        want[name] = dict(launches=train_launches(cfg, name, False, frames, kernel_scales),
                          exchanges=grid_exchanges(cfg, name, frames, kernel_scales, False))
        case[name] = dict(family="RFN", config=cfg, tcfg=tcfg, batches=batches,
                          state={k: v.cpu() for k, v in state.items()})
        refs[name] = steps
        del tr, model
        torch.cuda.empty_cache()
    mcfg, tcfg = srnn_mnist()
    model = SRNN(mcfg, device="cuda", remat=False,
                 generator=torch.Generator(device="cuda").manual_seed(0))
    perturb_(model, seed=1)
    batches = [(rng.random((tcfg.batch_size, tcfg.n_frames, 64, 64, 1)) > 0.8).astype(np.float32)
               for _ in GRID_SEEDS]
    tr = Trainer(model, tcfg, batches).build()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    refs["srnn"] = [_grid_step(tr, state, torch.as_tensor(b, device="cuda"), s)
                    for b, s in zip(batches, GRID_SEEDS)]
    want["srnn"] = dict(launches=family_launches("srnn_mnist", "train", tcfg.n_frames),
                        exchanges=srnn_grid_exchanges(tcfg.n_frames - 1, False))
    case["srnn"] = dict(family="SRNN", config=mcfg, tcfg=tcfg, batches=batches,
                        state={k: v.cpu() for k, v in state.items()})
    del tr, model
    torch.cuda.empty_cache()
    torch.save(case, GRID_DIR / "case.pt")
    del case

    t_ranks = time.perf_counter()
    port = free_port()
    logs = [open(GRID_DIR / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--grid-rank",
                               str(r), "2", str(port)], cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT, env=dict(os.environ))
             for r in range(2)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks_s = time.perf_counter() - t_ranks
    if any(codes):
        tails = [(GRID_DIR / f"rank{r}.log").read_text()[-3000:] for r in range(2)]
        raise AssertionError(f"grid ranks exited with {codes}:\n" + "\n".join(tails))

    errors, paths = [], {}
    record["steps"] = {}
    for name, ref in refs.items():
        ranks = [torch.load(GRID_DIR / f"{name}_rank{r}.pt", weights_only=False)
                 for r in range(2)]
        rows = []
        for r, got in enumerate(ranks):
            if got["devices"] != ["cuda"]:
                errors.append(f"{name} rank {r}: tensors on {got['devices']}")
            for i, (s, s_ref) in enumerate(zip(got["steps"], ref)):
                ex = {k: s["counts"][k] for k in ("halo", "halo_grad", "gather", "gather_grad")}
                if ex != want[name]["exchanges"]:
                    errors.append(f"{name} rank {r} step {i}: exchanges {ex}, expected "
                                  f"{want[name]['exchanges']}")
                if s["launches"] != want[name]["launches"] or s_ref["launches"] != s["launches"]:
                    errors.append(f"{name} rank {r} step {i}: launches {s['launches']}, "
                                  f"one process {s_ref['launches']}, expected "
                                  f"{want[name]['launches']}")
                for k in ("loss", "kl", "nll"):
                    if abs(s["metrics"][k] - s_ref["metrics"][k]) > (
                            GRID_RTOL_METRICS * abs(s_ref["metrics"][k])):
                        errors.append(f"{name} rank {r} step {i} {k}: {s['metrics'][k]} vs "
                                      f"{s_ref['metrics'][k]}")
            timed = got["steps"][-1]
            if r == 0:
                held = _grid_check(f"{name} rank 0", timed, ref[-1], errors)
                sums = {key: {n: (float(t.double().sum()), float(t.double().square().sum()))
                              for n, t in timed[key].items()} for key in ("grads", "params")}
            else:  # the gradients are reduced before Adam: every rank holds rank 0's
                for key in ("grads", "params"):
                    mine = timed[key + "_sums"]
                    if mine.keys() != sums[key].keys() or any(
                            abs(a - b) > 1e-12 * abs(b) for n in mine
                            for a, b in zip(mine[n], sums[key][n])):
                        errors.append(f"{name} rank {r}: {key} differ from rank 0's")
            rows.append(dict(rank=r, ms=timed["ms"], exchange_ms=timed["exchange_ms"],
                             counts=timed["counts"], metrics=timed["metrics"], **held))
        paths[f"grid_train_{name}"] = {k: sum(g["steps"][-1]["launches"][k] for g in ranks)
                                       for k in SOURCES}
        record["steps"][name] = dict(one_process_ms=ref[-1]["ms"],
                                     one_process_metrics=ref[-1]["metrics"], ranks=rows)
        print(f"grid 1x2 {name}: {rows[0]['ms']:.1f} / {rows[1]['ms']:.1f} ms a step sharded "
              f"(ranks 0/1) vs {ref[-1]['ms']:.1f} ms in one process; "
              f"{rows[0]['counts']['halo']} halos + {rows[0]['counts']['halo_grad']} back, "
              f"{rows[0]['counts']['gather']} gathers per rank, "
              f"{rows[0]['exchange_ms']:.1f} / {rows[1]['exchange_ms']:.1f} host ms in "
              f"exchanges; loss {rows[0]['metrics']['loss']:.4f} vs "
              f"{ref[-1]['metrics']['loss']:.4f} (worst metric rel err "
              f"{max(x['metric_rel_err'] for x in rows):.2e}); largest gradient diff "
              f"{rows[0]['grad_tensor'][0]:.2e} of its tensor's largest "
              f"({rows[0]['grad_tensor'][1]}), {rows[0]['grad_model'][0]:.2e} of the "
              f"model's ({rows[0]['grad_model'][1]}); {rows[0]['held']} parameter "
              f"elements held by value, {rows[0]['noise']} by gradient; on {card}")
    if errors:
        raise AssertionError("phase 17: " + "; ".join(errors[:12]))

    # the two-moons example on the card
    import importlib.util

    from recurrent_flows_tpu_torch.data.png import read_png

    spec = importlib.util.spec_from_file_location("torch_two_moons",
                                                  ROOT / "examples" / "torch_two_moons.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = example.main(["--steps", "300", "--out", str(GRID_DIR / "two_moons")])
    moons_s = time.perf_counter() - t0
    falls = {k: (float(np.mean(v[:20])), float(np.mean(v[-20:])))
             for k, v in out["losses"].items()}
    figures = [read_png(f).shape for f in out["files"]]
    if any(b >= a for a, b in falls.values()) or len(figures) != 4:
        raise AssertionError(f"two moons: losses {falls}, figures {figures}")
    record["two_moons"] = dict(seconds=moons_s, losses_first_last20=falls, figures=figures)
    print(f"two moons on the card: {moons_s:.1f} s for 3 x 300 steps, nll (first 20 -> last 20) "
          + ", ".join(f"{k} {a:.3f} -> {b:.3f}" for k, (a, b) in falls.items()))
    record.update(ranks_s=ranks_s, phase_s=time.perf_counter() - t_phase)
    print(f"phase 17: {record['phase_s']:.0f} s, the two ranks {ranks_s:.0f} s of it")
    return paths, shapes


PHASES_LOG = ROOT / "chiprun_out" / "chip_smoke_phases.log"


def progress(line: str) -> None:
    """Print a phase's end, and append it to ``PHASES_LOG``: the record of
    where a run's time went that a run cut off at its time limit still has."""
    print(line, flush=True)
    PHASES_LOG.parent.mkdir(exist_ok=True)
    with PHASES_LOG.open("a") as f:
        f.write(line + "\n")


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
    PHASES_LOG.unlink(missing_ok=True)
    print(f"card: {card}")
    record = dict(card=card, device=torch.cuda.get_device_name(0),
                  torch=torch.__version__, cuda=torch.version.cuda,
                  glowchain_checks=[], glowchain_ms=[], glowchain_train_ms=[],
                  glowstep_checks=[], glowstep_ms=[], actnorm_invconv=[],
                  coupling_transform=[], convlstm_gates=[], launch_plans=[],
                  served_batch_checks=[])

    # phase 2: build
    t0 = time.perf_counter()
    built = build_all()
    record["build_s"] = {name: secs for name, (_, secs) in built.items()}
    progress(f"build: {record['build_s']} s, {time.perf_counter() - t0:.1f} s in all")

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
        check_opchecks(record)
    progress(f"phase 3 done at {time.perf_counter() - t_start:.0f} s")

    rng = np.random.default_rng(0)
    paths = {"mnist_serve": serve(model, mcfg, tcfg, rng, record, card,
                                  request_launches(mcfg, range(1, mcfg.L), N_COND), N_COND)}
    rollout_card_vs_cpu(model, rng, record)
    del model
    torch.cuda.empty_cache()
    progress(f"serving done at {time.perf_counter() - t_start:.0f} s")
    paths["mnist_train"] = train(mcfg, tcfg, rng, record, card, range(1, mcfg.L))
    progress(f"training done at {time.perf_counter() - t_start:.0f} s")
    train_card_vs_cpu(mcfg, tcfg, rng, record, *MNIST_GRADS)

    # the kernels at the shapes of rfn_bair and rfn_kth, then both models
    record["new_shapes"] = {}
    with float32_precision():
        new = check_new_shapes(record["new_shapes"])
    progress(f"new shapes done at {time.perf_counter() - t_start:.0f} s")
    record["bair"] = {}
    paths.update(bair(rng, record["bair"], card))
    progress(f"rfn_bair done at {time.perf_counter() - t_start:.0f} s")
    record["kth_batchnorm"] = {}
    paths.update(kth_batchnorm(rng, record["kth_batchnorm"], card))
    progress(f"rfn_kth batchnorm variant done at {time.perf_counter() - t_start:.0f} s")
    record["lifecycle"] = {}
    paths.update(lifecycle(rng, record["lifecycle"], card))
    progress(f"lifecycle done at {time.perf_counter() - t_start:.0f} s")
    record["families"] = {}
    with float32_precision():
        fam_gates = check_family_gates(record["families"])
    paths.update(families(record["families"]))
    progress(f"families done at {time.perf_counter() - t_start:.0f} s")
    record["evaluation"] = {}
    t0 = time.perf_counter()
    paths.update(evaluation(rng, record["evaluation"]))
    record["evaluation"]["phase_s"] = time.perf_counter() - t0
    progress(f"evaluation done at {time.perf_counter() - t_start:.0f} s "
          f"(phase 13: {record['evaluation']['phase_s']:.0f} s)")
    record["training_clis"] = {}
    t0 = time.perf_counter()
    cli_paths, cli_checks = training_clis(rng, record["training_clis"])
    paths.update(cli_paths)
    record["training_clis"]["phase_s"] = time.perf_counter() - t0
    progress(f"training CLIs done at {time.perf_counter() - t_start:.0f} s "
          f"(phase 14: {record['training_clis']['phase_s']:.0f} s)")
    record["export"] = {}
    t0 = time.perf_counter()
    paths.update(export_phase(record["export"]))
    record["export"]["phase_s"] = time.perf_counter() - t0
    progress(f"export done at {time.perf_counter() - t_start:.0f} s "
          f"(phase 15: {record['export']['phase_s']:.0f} s)")
    record["standalone"] = {}
    t0 = time.perf_counter()
    standalone_paths, standalone_shapes = standalone(rng, record["standalone"])
    paths.update(standalone_paths)
    record["standalone"]["phase_s"] = time.perf_counter() - t0
    progress(f"standalone models done at {time.perf_counter() - t_start:.0f} s "
          f"(phase 16: {record['standalone']['phase_s']:.0f} s)")
    record["grid"] = {}
    grid_paths, grid_shapes = spatial_grid(record["grid"], card)
    paths.update(grid_paths)
    progress(f"spatial grid done at {time.perf_counter() - t_start:.0f} s "
          f"(phase 17: {record['grid']['phase_s']:.0f} s)")

    launches = {name: sum(p[name] for p in paths.values()) for name in SOURCES}
    never = [name for name in SOURCES if launches[name] == 0]
    on_bair = [name for name in SOURCES
               if paths["bair_serve"][name] + paths["bair_train"][name] == 0]
    on_families = [path for path in ("srnn_mnist_train", "srnn_mnist_predict",
                                     "vrnn_mnist_train", "vrnn_mnist_predict")
                   if paths[path]["convlstm_gates"] == 0]
    on_eval = [name for name in ("actnorm_invconv", "convlstm_gates", "coupling_transform",
                                 "glowchain") if paths["eval_rfn"][name] == 0]
    on_eval += ["convlstm_gates (srnn)"] * (paths["eval_srnn"]["convlstm_gates"] == 0)
    on_export = [f"{path} {name}" for path, names in (
        ("export_rfn", ("convlstm_gates", "coupling_transform", "glowchain")),
        ("export_srnn", ("convlstm_gates",))) for name in names if paths[path][name] == 0]
    on_standalone = [f"{path} {name}" for path, names in (
        ("glow_image_train_A", ("actnorm_invconv", "coupling_transform")),
        ("cglow_train", ("actnorm_invconv", "coupling_transform")),
        ("glow_image_train_C", ("glowchain",)), ("glow_image_sample", ("glowchain",)),
        ("cglow_sample", ("glowchain",)),
        ("rfn_vgg_train", ("actnorm_invconv", "convlstm_gates", "coupling_transform")),
        ("rfn_vgg_request", ("convlstm_gates", "coupling_transform", "glowchain")),
        ("grid_train_A", ("actnorm_invconv", "convlstm_gates", "coupling_transform")),
        ("grid_train_B", ("glowstep",)), ("grid_train_C", ("glowchain",)),
        ("grid_train_srnn", ("convlstm_gates",)))
        for name in names if paths[path][name] == 0]
    if never or on_bair or on_families or on_eval or on_export or on_standalone:
        raise AssertionError(f"kernels the main paths never launched: {never}; "
                             f"that rfn_bair never launched: {on_bair}; family paths "
                             f"without the gates: {on_families}; that evaluation never "
                             f"launched: {on_eval}; that the export never launched: "
                             f"{on_export}; that the standalone models or the grid never "
                             f"launched: "
                             f"{on_standalone}")
    max_err = {name: max(kernels[name]["max_abs_err"], new[name]["max_abs_err"])
               for name in SOURCES}
    max_err["convlstm_gates"] = max(max_err["convlstm_gates"], fam_gates["max_abs_err"])
    for name, t in (list(cli_checks.items()) + list(standalone_shapes.items())
                    + list(grid_shapes.items())):
        max_err[name] = max(max_err[name], t["max_abs_err"])
    line = {"kernels": [
        dict(name=name, route=route, source=source, replaces=replaces,
             launches=launches[name],
             launches_by_path={path: p[name] for path, p in paths.items()},
             **{**kernels[name], "max_abs_err": max_err[name]},
             bair_kth_shapes=new[name],
             **({"srnn_vrnn_shapes": fam_gates["rows"]} if name == "convlstm_gates" else {}),
             **({"cli_shapes": cli_checks[name]["rows"]} if name in cli_checks else {}),
             **({"glow_image_shapes": standalone_shapes[name]}
                if name in standalone_shapes else {}),
             **({"grid_shapes": grid_shapes[name]["rows"]} if name in grid_shapes else {}))
        for name, (route, source, replaces) in SOURCES.items()],
        "launch_floor_ms": record["launch_floor_ms"]}
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
    import sys

    if sys.argv[1:2] == ["--grid-rank"]:  # one rank of phase 17, started by it
        grid_rank(*(int(a) for a in sys.argv[2:5]))
    else:
        main()

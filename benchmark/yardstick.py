"""The arithmetic the per-layer metrics read with: the card's peaks, the
roofline bound, the GlowStep's operations, the kinds of device kernel,
the union of kernel intervals, the host's launch calls, the idle gaps,
and the profiled part of a run (``profile``).

The peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W:
67 TFLOP/s in float32 outside the tensor cores (the port runs float32 with
TF32 off) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# device kernels by name: the port's own, then cuDNN convolutions with
# their layout transposes, then cuBLAS products and triangular solves
KERNEL_KINDS = (("glowchain", ("glowchain",)),
                ("glowstep", ("glowstep",)),
                ("actnorm_invconv", ("actnorm_invconv", "ainv_kernel")),
                ("coupling_transform", ("coupling_kernel",)),
                ("convlstm_gates", ("gates_kernel",)),
                ("conv", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "winograd", "nchw",
                          "nhwc")),
                ("gemm", ("gemm", "gemv", "trsm")))

# host calls that put work on the device's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the float32 operations over the peak rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def glowstep_flops(b: int, h: int, w: int, c: int, cc: int, u: int) -> int:
    """float32 operations of one GlowStep on x [b, h, w, c] with cc
    condition channels and u hidden units: the 1x1 and the coupling net's
    3x3, 1x1 and 3x3 convolutions."""
    ca = c // 2 + cc
    return 2 * b * h * w * (c * c + 9 * ca * u + u * u + 9 * u * c)


def glowchain_bytes(b: int, h: int, w: int, c: int, cc: int, u: int, k: int) -> int:
    """Bytes a K-step chain must move: x read, y written, the condition
    read, and each step's weights read once (1x1, three convs, their
    biases and actnorms, the clamp)."""
    ca = c // 2 + cc
    per_step = c * c + 9 * ca * u + u * u + 9 * u * c + 4 * u + 4 * c
    return 4 * (2 * b * h * w * c + b * h * w * cc + k * per_step)


def union_s(spans) -> float:
    """Seconds covered by the union of [start_ns, end_ns) intervals."""
    busy, end = 0, None
    for s, e in sorted((s, e) for s, e, *_ in spans):
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def idle_gaps(spans, host_ops, limit: int = 10) -> list:
    """The longest gaps between device operations, each named by the host
    operation that launched the work ending it (the last one started
    before the gap's end): [[name, seconds], ...]."""
    spans = sorted(spans)
    starts = [s for s, _, _ in host_ops]
    gaps, end = [], None
    for s, e, _ in spans:
        if end is not None and s > end:
            i = bisect.bisect_right(starts, s) - 1
            gaps.append((s - end, host_ops[i][2] if i >= 0 else "?"))
        end = e if end is None else max(end, e)
    by_name = {}
    for dt, name in gaps:
        by_name[name] = by_name.get(name, 0) + dt
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:limit]
    return [[name, dt / 1e9] for name, dt in top]


@dataclasses.dataclass
class Reading:
    """The profiled part of a run: device operations, host launches, its
    wall time and units, and what the window measured."""

    device_ops: list  # (start_ns, end_ns, name)
    host_ops: list  # (start_ns, end_ns, name) of the host's aten operations
    launches: int
    wall_s: float
    units: int
    peak_bytes: int
    window: object
    cell: object
    flops_per_unit: float | None = None

    def busy_s(self) -> float:
        return union_s(self.device_ops)

    def kind_s(self, kind: str) -> float:
        return union_s([op for op in self.device_ops if kernel_kind(op[2]) == kind])

    def matching(self, key: str) -> list:
        return [op for op in self.device_ops if key in op[2].lower()]

    def breakdown(self) -> dict:
        by_name = {}
        for s, e, name in self.device_ops:
            by_name[name] = by_name.get(name, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return dict(device_ops=[[n[:200], dt / 1e9] for n, dt in top],
                    idle_gaps=idle_gaps(self.device_ops, self.host_ops))


def mfu(window, flops_per_unit) -> float | None:
    """Model FLOPs of the window's units over the window's time at the
    float32 peak, in %."""
    if not flops_per_unit or window.seconds <= 0:
        return None
    return 100.0 * flops_per_unit * window.attempted / (window.seconds * PEAK_F32_FLOPS)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The most memory the allocator has held since the last reset."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def profile(fn, units: int, window, cell, device) -> Reading:
    """Run ``fn()`` ``units`` times under ``torch.profiler`` (host and
    device), and read the trace without exporting it."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        sync(device)
        wall = time.perf_counter() - t0
    device_ops, host_ops, launches = [], [], 0
    for ev in prof.profiler.kineto_results.events():
        name, dev = ev.name(), str(ev.device_type())
        if dev.endswith("CUDA"):
            device_ops.append((ev.start_ns(), ev.end_ns(), name))
        elif name in LAUNCH_CALLS:
            launches += 1
        elif name.startswith("aten::"):
            host_ops.append((ev.start_ns(), ev.end_ns(), name))
    host_ops.sort()
    return Reading(device_ops=device_ops, host_ops=host_ops, launches=launches, wall_s=wall,
                   units=units, peak_bytes=peak_bytes(device), window=window, cell=cell)

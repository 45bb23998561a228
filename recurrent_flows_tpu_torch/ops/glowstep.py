"""One whole GlowStep in one launch: the CUDA C++ kernel
``csrc/glowstep.cu`` beside its plain PyTorch version.

Replaces ``recurrent_flows_tpu/ops/pallas/glowstep.py::_glowstep_pallas``
(``glowstep.py:164``, behind ``glowstep_fused``). The source notes in
``csrc/glowstep.cu`` and ``csrc/glowstep_body.cuh`` say what bounds it on
the H100 and what its design does about that. :func:`launch_plan` is the
one place that decides the launch geometry of this kernel and of the
chain kernel (batch tile, cluster size, register tiles, the weight ring,
the layout of shared memory); the C entry points take its integers.

Parameters arrive as one step's :class:`GlowStepParams`, as
``flows.glow.prep_glowstep_params`` builds them. The wrapper dispatches by
device: a CPU tensor takes :func:`glowstep_ref` (autograd differentiates
it directly), a CUDA tensor launches the kernel or raises. It counts its
launches in ``glowstep.launches``. Like the TPU kernel's VJP, the gradient
on the card re-runs the plain version on the saved inputs
(:class:`ReplayGrad`); there is no backward kernel yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

CLAMP_TYPES = {"none": 0, "glow": 1, "softclamp": 2, "realnvp": 3}
MAX_SMEM_BYTES = 232448  # one H100 block's opt-in dynamic shared memory
THREADS = 256  # per block (kThreads in csrc/glowstep_body.cuh)
STAGE_TARGET = 9216  # floats of one stage of the weight ring, about
MAX_TILE_ROWS = 256  # rows of one cluster's batch tile, at most
HA_GLOBAL_ROWS = 64  # from this many rows the first hidden map goes through L2


class LaunchPlan(NamedTuple):
    """The launch geometry of the two GlowStep kernels, all ints, in the
    order of ``struct Plan`` in ``csrc/glowstep_body.cuh``. Offsets
    (``o_*``) and sizes are in floats; every offset is a multiple of 4."""

    batch_tile: int  # whole samples per cluster
    clusters: int  # ceil(B / batch_tile); the last tile may be ragged
    cluster_blocks: int  # blocks per cluster: the hidden channels' split
    im: int  # 4x4 register tiles per thread (1 or 2)
    stages: int  # buffers of the weight ring
    stage_floats: int
    group_peers: int  # peers whose slices of ha are gathered together
    kc_b: int  # or, with ha in global memory: its columns per chunk
    kc_a: int  # rows of wa per chunk (a multiple of 4)
    sub_a: int  # chunks per tap of the first conv
    taps_a: int  # or, where a tap is one chunk: taps per chunk (9, 3 or 1)
    taps_c: int  # taps of the last conv per chunk (9, 3 or 1)
    s_in: int  # row stride of the coupling input [z1 | cond]
    s_h: int  # row stride of a block's slice of a hidden map
    s_g: int  # row stride of the gathered slices
    vec: int  # bit 0: 16-byte copies of wa and wb; bit 1: of wc
    ha_global: int  # 1: the first hidden map reaches the peers through L2
    o_xs: int
    o_tmp: int
    o_in: int
    o_zero: int
    o_ha: int
    o_hb: int
    o_stg: int
    o_part: int
    o_shs: int
    o_ss: int
    o_lds: int
    o_red: int
    o_ring: int
    smem_floats: int
    smem_bytes: int


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _row_stride(n: int) -> int:
    """Row stride (floats) of an [rows, n] map in shared memory: a multiple
    of 4 for 16-byte loads, and 4 mod 8, so that the 16-byte loads of eight
    neighbouring rows fall into different banks."""
    s = _r4(n)
    return s if s % 8 == 4 else s + 4


def _tiles(rows: int, n: int, im: int) -> int:
    """4x4 register tiles of an [rows, n] product, ``im`` per thread."""
    return _cdiv(rows, 4 * im) * max(1, _cdiv(n, 4))


def _layout(b, hw, c, cc, u, bt, nb, im=None, ha_global=0, stages=None):
    """The plan for a batch tile of ``bt`` samples on ``nb`` blocks, or the
    reason there is none: (LaunchPlan, None) or (None, message)."""
    rows, ca, c2, cp = bt * hw, c // 2 + cc, c // 2, _r4(c)
    nu = _cdiv(u, nb)
    npu = _r4(nu)
    if max(npu, cp) > THREADS:
        return None, (f"has rows of {max(npu, cp)} weights, more than the "
                      f"{THREADS} a block's threads copy at once")
    im = next((i for i in ((im,) if im else (1, 2))
               if _tiles(rows, max(nu, c), i) <= THREADS), None)
    if im is None:
        return None, (f"has {rows} rows by {max(nu, c)} columns, more than "
                      f"{THREADS} threads take in 8x4 register tiles")
    sub_a = _cdiv(_r4(ca) * npu, STAGE_TARGET)
    kc_a = _r4(_cdiv(_r4(ca), sub_a))
    sub_a = _cdiv(ca, kc_a)
    red = 0
    for n in (nu, c):
        tiles = _tiles(rows, n, im)
        if THREADS // tiles > 1:
            red = max(red, (THREADS // tiles) * tiles * 16 * im)
    vec = (1 if u % (4 * nb) == 0 else 0) | (2 if c % 4 == 0 else 0)
    if ha_global and not vec & 1:
        return None, ("cannot send the hidden map through L2: its 16-byte "
                      f"copies need {u} hidden channels to be a multiple of "
                      f"{4 * nb}")
    least = None
    # in this order (large chunks gained more than a deep ring on the H100):
    # as many columns of ha per chunk of the 1x1 as fit (whole slices of
    # peers, or with ha in global memory also a half and a quarter of one);
    # as many taps of the first and of the last conv per chunk as fit; three
    # stages before two
    widths = [g * nu for g in range(nb, 0, -1)]
    if ha_global:
        widths += [w for w in (nu // 2, nu // 4) if w and w % 4 == 0]
    candidates = [(n_stages, kc_b, taps_a, taps_c)
                  for kc_b in widths
                  for taps_a in (9, 3, 1) if taps_a == 1 or (
                      sub_a == 1 and taps_a * kc_a * npu <= STAGE_TARGET)
                  for taps_c in (9, 3, 1) if taps_c == 1 or (
                      taps_c * _r4(nu) * cp <= STAGE_TARGET)
                  for n_stages in (3, 2, 4)]
    s_in, s_h = _row_stride(ca), _row_stride(nu)
    for n_stages, kc_b, taps_a, taps_c in candidates:
        if stages not in (None, n_stages):
            continue
        s_g = _row_stride(kc_b)
        # a chunk of the 1x1: kc_b rows of wb, and with ha in global memory
        # the same columns of ha behind them
        chunk_b = _r4(kc_b) * npu + (rows * s_g if ha_global else 0)
        stage = max(taps_a * kc_a * npu, chunk_b, taps_c * _r4(nu) * cp)
        sizes = (rows * c, rows * c, rows * s_in,
                 max(kc_a, _r4(kc_b), _r4(nu)),  # the row of zeros
                 0 if ha_global else rows * s_h, rows * s_h,
                 0 if ha_global else rows * s_g, rows * cp,
                 rows * c2, rows * c2, rows * c2, red, n_stages * stage)
        offsets, total = [], 0
        for size in sizes:
            offsets.append(total)
            total += _r4(size)
        least = min(least or 4 * total, 4 * total)
        if 4 * total <= MAX_SMEM_BYTES:
            return LaunchPlan(bt, _cdiv(b, bt), nb, im, n_stages, stage,
                              0 if ha_global else kc_b // nu,
                              kc_b if ha_global else 0,
                              kc_a, sub_a, taps_a, taps_c, s_in, s_h, s_g, vec,
                              int(ha_global), *offsets, total,
                              4 * total), None
    return None, (f"needs {least} B of shared memory per block "
                  f"(> {MAX_SMEM_BYTES})")


def launch_plan(b: int, h: int, w: int, c: int, cc: int, u: int, *,
                batch_tile: int | None = None,
                cluster_blocks: int | None = None,
                im: int | None = None,
                ha_global: bool | None = None,
                stages: int | None = None) -> LaunchPlan:
    """The launch geometry of ``glowstep`` / ``glowchain`` on x [b,h,w,c]
    with cc cond channels and u hidden channels. A pure function of the
    shapes.

    A cluster of 8 blocks takes ``batch_tile`` whole samples. By default
    there are at most 16 tiles (16 clusters of 8 blocks fill 128 of the 132
    SMs) of at most ``MAX_TILE_ROWS`` rows; a tile that does not fit the
    shared memory is shrunk sample by sample. A batch of 2 to 8 samples on
    maps of fewer than 64 positions is taken two samples at a time by
    clusters of 16 blocks: as fast on the H100 as one sample per 8 blocks
    (4 such clusters do find their 16 SMs), with half the weight traffic.
    The first hidden map reaches
    the peers through distributed shared memory for tiles of fewer than
    ``HA_GLOBAL_ROWS`` rows and through L2 from there on (measured on the
    H100: at 64 and 256 rows the all-to-all over the cluster's network is
    the slower of the two). ``batch_tile``, ``cluster_blocks`` (up to 16;
    no shape of the flow ran faster on 16), ``im``, ``ha_global`` and
    ``stages`` fix a choice, for measurements. Raises
    ``ValueError`` where not even one sample fits.
    """
    if min(b, h, w, cc, u) < 1 or c < 2 or c % 2:
        raise ValueError(f"launch_plan: bad shape {(b, h, w, c, cc, u)}")
    hw = h * w
    if cluster_blocks is not None and not 1 <= cluster_blocks <= 16:
        raise ValueError("launch_plan: a cluster has 1 to 16 blocks")
    bt = batch_tile or min(b, max(1, MAX_TILE_ROWS // hw), _cdiv(b, 16))
    pairs = (batch_tile is None and cluster_blocks is None and hw < 64
             and 2 <= b <= 8)
    if pairs:
        bt = 2
    while True:
        nb = cluster_blocks or (16 if pairs and bt == 2 else 8)
        if not cluster_blocks and (_tiles(bt * hw, max(_cdiv(u, 8), c), 2) > THREADS
                                   >= _tiles(bt * hw, max(_cdiv(u, 16), c), 2)):
            nb = 16  # very wide hidden maps: slices of half the width
        via_l2 = (bt * hw >= HA_GLOBAL_ROWS and u % (4 * nb) == 0
                  if ha_global is None else ha_global)
        plan, why = _layout(b, hw, c, cc, u, bt, nb, im, via_l2, stages)
        if plan is not None:
            return plan
        if batch_tile or bt == 1:
            raise ValueError(f"glowstep kernels: a tile of {bt} sample(s) of "
                             f"{h}x{w}x{c} with {cc} cond and {u} hidden "
                             f"channels on {nb} blocks {why}")
        bt -= 1


def plan_chunks(plan: LaunchPlan, hw: int, c: int, cc: int, u: int) -> list[tuple]:
    """One step's chunks of the weight stream of a cluster's widest block,
    in the order ``copy_chunk`` (``csrc/glowstep_body.cuh``) issues them:
    (array, first tap, taps, first row, rows, floats of a stage it fills).
    ``hw`` is H*W."""
    nb, ca, cp = plan.cluster_blocks, c // 2 + cc, _r4(c)
    nu = _cdiv(u, nb)
    npu = _r4(nu)
    chunks = []
    if plan.taps_a > 1:
        chunks += [("wa", tap, plan.taps_a, 0, ca, plan.taps_a * _r4(ca) * npu)
                   for tap in range(0, 9, plan.taps_a)]
    else:
        for tap in range(9):
            for k0 in range(0, plan.sub_a * plan.kc_a, plan.kc_a):
                rows = min(plan.kc_a, ca - k0)
                chunks.append(("wa", tap, 1, k0, rows, _r4(rows) * npu))
    if plan.ha_global:
        ha = plan.batch_tile * hw * plan.s_g  # the same columns of ha
        chunks += [("wb", 0, 1, ua, min(plan.kc_b, u - ua), _r4(plan.kc_b) * npu + ha)
                   for ua in range(0, u, plan.kc_b)]
    else:
        for p0 in range(0, nb, plan.group_peers):
            ua, ub = u * p0 // nb, u * min(nb, p0 + plan.group_peers) // nb
            chunks.append(("wb", 0, 1, ua, ub - ua, _r4(ub - ua) * npu))
    chunks += [("wc", tap, plan.taps_c, 0, nu, plan.taps_c * _r4(nu) * cp)
               for tap in range(0, 9, plan.taps_c)]
    return chunks


def plan_samples(plan: LaunchPlan, b: int) -> list[range]:
    """The samples each cluster of ``plan`` stores, for a batch of b."""
    return [range(i * plan.batch_tile, min(b, (i + 1) * plan.batch_tile))
            for i in range(plan.clusters)]


class GlowStepParams(NamedTuple):
    """Kernel-ready parameters of one GlowStep (the JAX package's
    ``ops/pallas/glowstep.py::GlowStepParams``): ``w1x1`` is Wᵀ forward
    and (W⁻¹)ᵀ reverse; ``wc``/``bias_c`` carry the Conv2dZeros gain and
    the 'cross' pre-permutation (first C/2 outputs = shift)."""

    an_bias: torch.Tensor  # [C]
    an_logs: torch.Tensor  # [C]
    w1x1: torch.Tensor  # [C, C]
    wa: torch.Tensor  # [9, CA, U], CA = C/2 + Cc
    ana_bias: torch.Tensor  # [U]
    ana_logs: torch.Tensor  # [U]
    wb: torch.Tensor  # [U, U]
    anb_bias: torch.Tensor  # [U]
    anb_logs: torch.Tensor  # [U]
    wc: torch.Tensor  # [9, U, C]
    bias_c: torch.Tensor  # [C]
    clamp_scale: torch.Tensor  # [C/2]
    clamp_shift: torch.Tensor  # [C/2]


def clamp(log_scale, clamp_type: str, scale, shift):
    """The coupling's four clamps of the raw log-scale."""
    if clamp_type == "glow":
        return torch.log(torch.sigmoid(log_scale + 2.0))
    if clamp_type == "softclamp":
        return 2.5 * 0.636 * torch.atan(log_scale / 2.5)
    if clamp_type == "realnvp":
        return scale * torch.tanh(log_scale) + shift
    if clamp_type == "none":
        return log_scale
    raise ValueError(f"unknown clamp type: {clamp_type}")


def _coupling_net(z1, cond, p: GlowStepParams, clamp_type: str):
    """(z1, cond) -> (shift, s), as nine shifted matmuls per 3x3 conv."""
    bt, h, w, _ = z1.shape
    rows = bt * h * w
    u = p.wb.shape[0]
    c = p.an_bias.shape[-1]
    hp = F.pad(torch.cat([z1, cond], -1), (0, 0, 1, 1, 1, 1))
    acc = 0.0
    for dy in range(3):
        for dx in range(3):
            sl = hp[:, dy:dy + h, dx:dx + w, :].reshape(rows, -1)
            acc = acc + sl @ p.wa[dy * 3 + dx]
    ha = torch.relu((acc + p.ana_bias) * torch.exp(p.ana_logs))
    hb = torch.relu((ha @ p.wb + p.anb_bias) * torch.exp(p.anb_logs))
    hbp = F.pad(hb.reshape(bt, h, w, u), (0, 0, 1, 1, 1, 1))
    acc2 = p.bias_c
    for dy in range(3):
        for dx in range(3):
            sl = hbp[:, dy:dy + h, dx:dx + w, :].reshape(rows, u)
            acc2 = acc2 + sl @ p.wc[dy * 3 + dx]
    shift = acc2[:, : c // 2]
    s = clamp(acc2[:, c // 2:], clamp_type, p.clamp_scale, p.clamp_shift)
    return shift.reshape(bt, h, w, c // 2), s.reshape(bt, h, w, c // 2)


def glowstep_ref(x, cond, p: GlowStepParams, clamp_type: str, reverse: bool):
    """Plain version: one GlowStep on kernel-ready params,
    (y, coupling logdet [B])."""
    bt, h, w, c = x.shape
    rows = bt * h * w
    if not reverse:
        y = (x + p.an_bias) * torch.exp(p.an_logs)
        y = (y.reshape(rows, c) @ p.w1x1).reshape(bt, h, w, c)
        z1, z2 = y[..., : c // 2], y[..., c // 2:]
        shift, s = _coupling_net(z1, cond, p, clamp_type)
        out = torch.cat([z1, (z2 + shift) * torch.exp(s)], -1)
        return out, s.reshape(bt, -1).sum(-1)
    z1, z2 = x[..., : c // 2], x[..., c // 2:]
    shift, s = _coupling_net(z1, cond, p, clamp_type)
    y = torch.cat([z1, z2 * torch.exp(-s) - shift], -1)
    y = (y.reshape(rows, c) @ p.w1x1).reshape(bt, h, w, c)
    return y * torch.exp(-p.an_logs) - p.an_bias, s.reshape(bt, -1).sum(-1)


class ReplayGrad(torch.autograd.Function):
    """``launch(x, cond, params, clamp_type, reverse)`` forward; backward
    through ``ref`` of the same signature, re-run under autograd on the
    saved inputs (what the TPU kernels' ``jax.vjp`` of their jnp reference
    does)."""

    @staticmethod
    def forward(ctx, launch, ref, clamp_type, reverse, x, cond, *leaves):
        ctx.save_for_backward(x, cond, *leaves)
        ctx.ref, ctx.clamp_type, ctx.reverse = ref, clamp_type, reverse
        return launch(x, cond, GlowStepParams(*leaves), clamp_type, reverse)

    @staticmethod
    def backward(ctx, g_y, g_ld):
        needs = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.ref(ins[0], ins[1], GlowStepParams(*ins[2:]),
                          ctx.clamp_type, ctx.reverse)
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, (g_y, g_ld),
                                           allow_unused=True))
        return (None,) * 4 + tuple(next(got) if n else None for n in needs)


def check_inputs(name: str, x, cond, ps: GlowStepParams, stacked: bool):
    """Validate shapes, types, devices and contiguity of a step's (or, with
    ``stacked``, a [K, ...] chain's) inputs; True when they lie on a card."""
    if x.dim() != 4 or cond.dim() != 4 or x.shape[:3] != cond.shape[:3]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and cond "
                         f"{tuple(cond.shape)} must be NHWC of one B,H,W")
    c = x.shape[-1]
    if c % 2:
        raise ValueError(f"{name}: channel count must be even")
    u, cc = ps.wb.shape[-1], cond.shape[-1]
    lead = (ps.wa.shape[0],) if stacked else ()
    want = GlowStepParams(
        an_bias=(c,), an_logs=(c,), w1x1=(c, c), wa=(9, c // 2 + cc, u),
        ana_bias=(u,), ana_logs=(u,), wb=(u, u), anb_bias=(u,), anb_logs=(u,),
        wc=(9, u, c), bias_c=(c,), clamp_scale=(c // 2,), clamp_shift=(c // 2,))
    for field, t, shape in zip(GlowStepParams._fields, ps, want):
        if tuple(t.shape) != lead + shape:
            raise ValueError(f"{name}: {field} has shape {tuple(t.shape)}, "
                             f"expected {lead + shape}")
    for t in (x, cond, *ps):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cuda"


def load_library(name: str, n_int_args: int):
    """The built ``csrc/<name>.cu`` with its C functions typed."""
    from ._build import load

    lib = load(name)
    if not getattr(lib, "_typed", False):
        n_plan = getattr(lib, f"{name}_plan_ints")
        n_plan.argtypes, n_plan.restype = [], ctypes.c_int
        if n_plan() != len(LaunchPlan._fields):
            raise RuntimeError(f"{name}: the library's Plan has {n_plan()} "
                               f"ints, LaunchPlan {len(LaunchPlan._fields)}")
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.POINTER(ctypes.c_int)]
                           + [ctypes.c_int] * n_int_args + [ctypes.c_void_p])
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _plan_ints(*shape):
    """(plan, the plan as the C array the launch takes), per shape."""
    plan = launch_plan(*shape)
    return plan, (ctypes.c_int * len(plan))(*plan)


def launch_kernel(name: str, x, cond, ps: GlowStepParams, ints: tuple):
    """Allocate the outputs and launch ``<name>_launch`` on the current
    stream with the shape's launch plan: (y, ld). ``ints`` are the int
    arguments after B,H,W,C,Cc,U."""
    lib = load_library(name, 6 + len(ints))
    b, h, w, c = x.shape
    cc, u = cond.shape[-1], ps.wb.shape[-1]
    plan, plan_ints = _plan_ints(b, h, w, c, cc, u)
    y = torch.empty_like(x)
    ld = torch.empty((b,), device=x.device, dtype=torch.float32)
    scratch = torch.empty((plan.clusters, plan.batch_tile * h * w, u),
                          device=x.device) if plan.ha_global else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(
            x.data_ptr(), cond.data_ptr(), *(t.data_ptr() for t in ps),
            y.data_ptr(), ld.data_ptr(),
            None if scratch is None else scratch.data_ptr(), plan_ints,
            b, h, w, c, cc, u, *ints, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())
    return y, ld


def _launch(x, cond, p, clamp_type, reverse):
    out = launch_kernel("glowstep", x, cond, p,
                        (CLAMP_TYPES[clamp_type], int(reverse)))
    glowstep.launches += 1
    return out


def glowstep(x, cond, p: GlowStepParams, clamp_type: str, reverse: bool):
    """One whole GlowStep: (y, coupling logdet [B]), NHWC f32."""
    if clamp_type not in CLAMP_TYPES:
        raise ValueError(f"unknown clamp type: {clamp_type}")
    if not check_inputs("glowstep", x, cond, p, stacked=False):
        return glowstep_ref(x, cond, p, clamp_type, reverse)
    return ReplayGrad.apply(_launch, glowstep_ref, clamp_type, reverse,
                            x, cond, *p)


glowstep.launches = 0

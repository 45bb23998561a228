"""One whole GlowStep in one launch: the CUDA C++ kernel
``csrc/glowstep.cu`` beside its plain PyTorch version.

Replaces ``recurrent_flows_tpu/ops/pallas/glowstep.py::_glowstep_pallas``
(``glowstep.py:164``, behind ``glowstep_fused``). The source note in
``csrc/glowstep.cu`` says what bounds it on the H100 and what its design
does about that.

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
from typing import NamedTuple

import torch
import torch.nn.functional as F

CLAMP_TYPES = {"none": 0, "glow": 1, "softclamp": 2, "realnvp": 3}
MAX_SMEM_BYTES = 232448  # one H100 block's opt-in dynamic shared memory


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
    """The built ``csrc/<name>.cu`` with its three C functions typed."""
    from ._build import load

    lib = load(name)
    if not getattr(lib, "_typed", False):
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * n_int_args
                           + [ctypes.c_void_p])
        launch.restype = ctypes.c_int
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_size_t
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def launch_kernel(name: str, x, cond, ps: GlowStepParams, ints: tuple):
    """Allocate outputs and scratch and launch ``<name>_launch`` on the
    current stream: (y, ld). ``ints`` are the int arguments after B,H,W,C,Cc,U."""
    lib = load_library(name, 6 + len(ints))
    b, h, w, c = x.shape
    cc, u = cond.shape[-1], ps.wb.shape[-1]
    smem = getattr(lib, f"{name}_smem_bytes")(h, w, c, cc)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: {h}x{w}x{c} with {cc} cond channels "
                         f"needs {smem} B of shared memory (> {MAX_SMEM_BYTES})")
    y = torch.empty_like(x)
    ld = torch.empty((b,), device=x.device, dtype=torch.float32)
    scratch = torch.empty((b, 2, h * w, u), device=x.device,
                          dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(
            x.data_ptr(), cond.data_ptr(), *(t.data_ptr() for t in ps),
            y.data_ptr(), ld.data_ptr(), scratch.data_ptr(),
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

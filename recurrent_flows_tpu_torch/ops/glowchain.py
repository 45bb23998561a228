"""K GlowSteps of one flow scale in one launch: the CUDA C++ kernel
``csrc/glowchain.cu`` beside its plain PyTorch version.

Replaces ``recurrent_flows_tpu/ops/pallas/glowchain.py::_glowchain_pallas``
(``glowchain.py:83``). The source note in ``csrc/glowchain.cu`` says what
bounds it on the H100 and what its design does about that.

Parameters arrive as a :class:`GlowStepParams` whose every leaf is stacked
``[K, ...]`` in execution order (reversed for the inverse), as
``flows.glow.prep_glowstep_params`` builds them. The wrapper dispatches by
device: a CPU tensor takes :func:`glowchain_ref`, a CUDA tensor launches
the kernel or raises. It counts its launches in ``glowchain.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

CLAMP_TYPES = {"none": 0, "glow": 1, "softclamp": 2, "realnvp": 3}


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


def glowstep_ref(x, cond, p: GlowStepParams, *, clamp_type: str,
                 reverse: bool):
    """One GlowStep on kernel-ready params: (y, coupling logdet [B])."""
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


def glowchain_ref(x, cond, ps: GlowStepParams, clamp_type: str,
                  reverse: bool):
    """Plain version: ``glowstep_ref`` looped over the K stacked steps.
    Returns (y, summed coupling logdet [B])."""
    ld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for k in range(ps.wa.shape[0]):
        x, ldk = glowstep_ref(x, cond, GlowStepParams(*(a[k] for a in ps)),
                              clamp_type=clamp_type, reverse=reverse)
        ld = ld + ldk
    return x, ld


def _lib():
    from ._build import load

    lib = load("glowchain")
    if not getattr(lib, "_typed", False):
        lib.glowchain_launch.argtypes = ([ctypes.c_void_p] * 18
                                         + [ctypes.c_int] * 9
                                         + [ctypes.c_void_p])
        lib.glowchain_launch.restype = ctypes.c_int
        lib.glowchain_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.glowchain_smem_bytes.restype = ctypes.c_size_t
        lib.glowchain_error_string.argtypes = [ctypes.c_int]
        lib.glowchain_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


MAX_SMEM_BYTES = 232448  # one H100 block's opt-in dynamic shared memory


def _check(x, cond, ps: GlowStepParams):
    if x.dim() != 4 or cond.dim() != 4 or x.shape[:3] != cond.shape[:3]:
        raise ValueError(f"glowchain: x {tuple(x.shape)} and cond "
                         f"{tuple(cond.shape)} must be NHWC of one B,H,W")
    b, h, w, c = x.shape
    if c % 2:
        raise ValueError("glowchain: channel count must be even")
    k, u, cc = ps.wa.shape[0], ps.wb.shape[-1], cond.shape[-1]
    want = GlowStepParams(
        an_bias=(k, c), an_logs=(k, c), w1x1=(k, c, c),
        wa=(k, 9, c // 2 + cc, u), ana_bias=(k, u), ana_logs=(k, u),
        wb=(k, u, u), anb_bias=(k, u), anb_logs=(k, u), wc=(k, 9, u, c),
        bias_c=(k, c), clamp_scale=(k, c // 2), clamp_shift=(k, c // 2))
    for name, t, shape in zip(GlowStepParams._fields, ps, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"glowchain: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for t in (x, cond, *ps):
        if t.dtype != torch.float32:
            raise TypeError(f"glowchain: expected float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"glowchain: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("glowchain: tensors must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"glowchain: unsupported device {x.device}")
    return x.device.type == "cuda"


def glowchain(x, cond, ps: GlowStepParams, clamp_type: str, reverse: bool):
    """Whole-scale K-step chain: (y, dyn_logdet[B]), NHWC f32."""
    if clamp_type not in CLAMP_TYPES:
        raise ValueError(f"unknown clamp type: {clamp_type}")
    if not _check(x, cond, ps):
        return glowchain_ref(x, cond, ps, clamp_type, reverse)
    lib = _lib()
    b, h, w, c = x.shape
    cc, u, k = cond.shape[-1], ps.wb.shape[-1], ps.wa.shape[0]
    smem = lib.glowchain_smem_bytes(h, w, c, cc)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"glowchain: {h}x{w}x{c} with {cc} cond channels "
                         f"needs {smem} B of shared memory (> {MAX_SMEM_BYTES})")
    y = torch.empty_like(x)
    ld = torch.empty((b,), device=x.device, dtype=torch.float32)
    scratch = torch.empty((b, 2, h * w, u), device=x.device,
                          dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.glowchain_launch(
            x.data_ptr(), cond.data_ptr(), *(t.data_ptr() for t in ps),
            y.data_ptr(), ld.data_ptr(), scratch.data_ptr(),
            b, h, w, c, cc, u, k, CLAMP_TYPES[clamp_type], int(reverse),
            stream)
    if err:
        raise RuntimeError("glowchain launch failed: "
                           + lib.glowchain_error_string(err).decode())
    glowchain.launches += 1
    return y, ld


glowchain.launches = 0

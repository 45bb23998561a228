"""The coupling tail and the ConvLSTM gates (Triton) and the folded
actnorm + 1x1 (CUDA C++), each beside its plain PyTorch version.

Replaces ``recurrent_flows_tpu/ops/pallas/fused.py``:

* ``coupling_transform`` replaces ``_coupling_pallas`` (``fused.py:75``):
  forward ``(z2 + shift)·e^s``, reverse ``z2·e^{-s} - shift``, plus the
  per-sample logdet ``Σ s``. On the H100 it is bound by bytes (three
  reads, one write, a handful of flops per element) and, at the slice's
  shapes ([B,32,32,2]), by launch latency. The kernel reads each element
  once and reduces the logdet in the same pass: one program per sample
  loops over its elements and sums in a fixed order, so the logdet is
  the same bit for bit from run to run (no float atomics).
* ``convlstm_gates`` replaces ``_gates_pallas`` (``fused.py:257``): the
  peephole ConvLSTM update from the fused gate-conv output. One
  elementwise pass with no reduction and no reuse, bound by bytes
  (5·hc in, 2·hc out per position, peepholes broadcast over B); Triton's
  masked block loads read each input once and write each output once.

* ``actnorm_invconv`` replaces ``_actnorm_invconv_pallas``
  (``fused.py:166``): ``((x + b)·e^logs)·Wᵀ`` over rows, the step actnorm
  folded into the invertible 1x1. Its kernel is CUDA C++ because it
  computes a matrix product in its own body; the source note in
  ``csrc/actnorm_invconv.cu`` says what bounds it and what its design does.

Dispatch is by device: a CPU tensor takes the plain version (autograd
differentiates it directly), a CUDA tensor launches the kernel or raises;
nothing falls back. Each wrapper counts its launches in
``<wrapper>.launches``. Triton is imported, and every kernel is compiled,
on the first launch only. On the card each kernel is the forward of a
``torch.autograd.Function`` whose backward is plain PyTorch, as the TPU
kernels' VJPs are plain jnp: the closed forms for the coupling and the
folded 1x1, the plain version re-run under autograd for the gates.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def coupling_transform_ref(z2, shift, s, reverse: bool = False):
    """Plain version: (z2', logdet[B])."""
    if not reverse:
        out = (z2 + shift) * torch.exp(s)
    else:
        out = z2 * torch.exp(-s) - shift
    return out, s.reshape(s.shape[0], -1).sum(-1)


def convlstm_gates_ref(gates, c, w_ci, w_cf, w_co):
    """Plain version: gates [B,H,W,4hc] in order (i,f,o,g) -> (h', c')."""
    cc_i, cc_f, cc_o, cc_g = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(cc_i + w_ci * c)
    f = torch.sigmoid(cc_f + w_cf * c)
    g = torch.tanh(cc_g)
    c_next = f * c + i * g
    o = torch.sigmoid(cc_o + w_co * c_next)
    return o * torch.tanh(c_next), c_next


def actnorm_invconv_ref(x, bias, logs, w):
    """Plain version: ((x + bias)·e^logs) @ wᵀ over the last axis."""
    return ((x + bias) * torch.exp(logs)) @ w.T


# ---------------------------------------------------------------------------
# Triton kernels (plain functions here; jitted on first launch, when
# ``triton``/``tl`` become module globals — see _kernels())
# ---------------------------------------------------------------------------


def _coupling_kernel(z2_ptr, shift_ptr, s_ptr, out_ptr, ld_ptr, n,
                     REVERSE: tl.constexpr, BLOCK: tl.constexpr):
    b = tl.program_id(0)
    base = b.to(tl.int64) * n
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for start in range(0, n, BLOCK):
        offs = start + tl.arange(0, BLOCK)
        m = offs < n
        z2 = tl.load(z2_ptr + base + offs, mask=m, other=0.0)
        sh = tl.load(shift_ptr + base + offs, mask=m, other=0.0)
        s = tl.load(s_ptr + base + offs, mask=m, other=0.0)
        if REVERSE:
            out = z2 * tl.exp(-s) - sh
        else:
            out = (z2 + sh) * tl.exp(s)
        tl.store(out_ptr + base + offs, out, mask=m)
        acc += s
    tl.store(ld_ptr + b, tl.sum(acc, axis=0))


def _gates_kernel(g_ptr, c_ptr, wci_ptr, wcf_ptr, wco_ptr, h_ptr, cn_ptr,
                  n, hc, hw_hc, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    pos = offs // hc
    ch = offs - pos * hc
    gb = pos * (4 * hc) + ch
    g_i = tl.load(g_ptr + gb, mask=m, other=0.0)
    g_f = tl.load(g_ptr + gb + hc, mask=m, other=0.0)
    g_o = tl.load(g_ptr + gb + 2 * hc, mask=m, other=0.0)
    g_g = tl.load(g_ptr + gb + 3 * hc, mask=m, other=0.0)
    c = tl.load(c_ptr + offs, mask=m, other=0.0)
    po = offs % hw_hc  # peepholes [1,H,W,hc] broadcast over the batch
    w_ci = tl.load(wci_ptr + po, mask=m, other=0.0)
    w_cf = tl.load(wcf_ptr + po, mask=m, other=0.0)
    w_co = tl.load(wco_ptr + po, mask=m, other=0.0)
    i = 1.0 / (1.0 + tl.exp(-(g_i + w_ci * c)))
    f = 1.0 / (1.0 + tl.exp(-(g_f + w_cf * c)))
    # tanh(v) = sign(v)·(1 - e^{-2|v|}) / (1 + e^{-2|v|}), overflow-free
    e = tl.exp(-2.0 * tl.abs(g_g))
    g = tl.where(g_g >= 0, 1.0, -1.0) * (1.0 - e) / (1.0 + e)
    c_next = f * c + i * g
    o = 1.0 / (1.0 + tl.exp(-(g_o + w_co * c_next)))
    e = tl.exp(-2.0 * tl.abs(c_next))
    t = tl.where(c_next >= 0, 1.0, -1.0) * (1.0 - e) / (1.0 + e)
    tl.store(h_ptr + offs, o * t, mask=m)
    tl.store(cn_ptr + offs, c_next, mask=m)


@functools.cache
def _kernels():
    """Import Triton and jit the kernels (first launch only)."""
    global triton, tl
    import triton
    import triton.language as tl

    return triton.jit(_coupling_kernel), triton.jit(_gates_kernel)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name, tensors, shapes):
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _coupling_launch(z2, shift, s, reverse):
    kern, _ = _kernels()
    b = z2.shape[0]
    n = z2.numel() // b
    out = torch.empty_like(z2)
    ld = torch.empty((b,), device=z2.device, dtype=torch.float32)
    with torch.cuda.device(z2.device):
        kern[(b,)](z2, shift, s, out, ld, n, REVERSE=bool(reverse),
                   BLOCK=1024, num_warps=4)
    coupling_transform.launches += 1
    return out, ld


class _Coupling(torch.autograd.Function):
    """Kernel forward; the closed-form backward of the TPU kernel's VJP."""

    @staticmethod
    def forward(ctx, z2, shift, s, reverse):
        ctx.save_for_backward(z2, shift, s)
        ctx.reverse = reverse
        return _coupling_launch(z2, shift, s, reverse)

    @staticmethod
    def backward(ctx, g_out, g_ld):
        z2, shift, s = ctx.saved_tensors
        gl = g_ld.reshape((-1,) + (1,) * (s.dim() - 1))
        if not ctx.reverse:
            dz2 = g_out * torch.exp(s)
            return dz2, dz2, dz2 * (z2 + shift) + gl, None
        dz2 = g_out * torch.exp(-s)
        return dz2, -g_out, -dz2 * z2 + gl, None


def coupling_transform(z2, shift, s, reverse: bool = False):
    """(z2', logdet[B]) for the affine coupling tail, NHWC f32."""
    if not _check("coupling_transform", (z2, shift, s), (z2.shape,) * 3):
        return coupling_transform_ref(z2, shift, s, reverse)
    return _Coupling.apply(z2, shift, s, bool(reverse))


coupling_transform.launches = 0


def _gates_launch(gates, c, w_ci, w_cf, w_co):
    _, kern = _kernels()
    _, h, w, hc = c.shape
    h_next = torch.empty_like(c)
    c_next = torch.empty_like(c)
    n = c.numel()
    block = 1024
    with torch.cuda.device(c.device):
        kern[(-(-n // block),)](gates, c, w_ci, w_cf, w_co, h_next,
                                       c_next, n, hc, h * w * hc,
                                       BLOCK=block, num_warps=4)
    convlstm_gates.launches += 1
    return h_next, c_next


class _Gates(torch.autograd.Function):
    """Kernel forward; backward through the plain version, re-run under
    autograd on the saved inputs."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        return _gates_launch(*inputs)

    @staticmethod
    def backward(ctx, g_h, g_c):
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            out = convlstm_gates_ref(*ins)
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, (g_h, g_c),
                                           allow_unused=True))
        return tuple(next(got) if n else None for n in needs)


def convlstm_gates(gates, c, w_ci, w_cf, w_co):
    """Peephole gate nonlinearity + state update -> (h_next, c_next)."""
    b, h, w, hc4 = gates.shape
    if hc4 % 4:
        raise ValueError("convlstm_gates: gate channels must be 4·hc")
    hc = hc4 // 4
    peep = (1, h, w, hc)
    if not _check("convlstm_gates", (gates, c, w_ci, w_cf, w_co),
                  (gates.shape, (b, h, w, hc), peep, peep, peep)):
        return convlstm_gates_ref(gates, c, w_ci, w_cf, w_co)
    return _Gates.apply(gates, c, w_ci, w_cf, w_co)


convlstm_gates.launches = 0


MAX_INVCONV_CHANNELS = 64  # W [C, C+1] and a row tile fit the default 48 KB of shared memory


def _ainv_lib():
    from ._build import load

    lib = load("actnorm_invconv")
    if not getattr(lib, "_typed", False):
        lib.actnorm_invconv_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.actnorm_invconv_launch.restype = ctypes.c_int
        lib.actnorm_invconv_error_string.argtypes = [ctypes.c_int]
        lib.actnorm_invconv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _ainv_launch(x, bias, logs, w):
    lib = _ainv_lib()
    c = x.shape[-1]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.actnorm_invconv_launch(
            x.data_ptr(), bias.data_ptr(), logs.data_ptr(), w.data_ptr(),
            y.data_ptr(), x.numel() // c, c,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("actnorm_invconv launch failed: "
                           + lib.actnorm_invconv_error_string(err).decode())
    actnorm_invconv.launches += 1
    return y


class _ActnormInvconv(torch.autograd.Function):
    """Kernel forward; the closed-form backward of the TPU kernel's VJP."""

    @staticmethod
    def forward(ctx, x, bias, logs, w):
        ctx.save_for_backward(x, bias, logs, w)
        return _ainv_launch(x, bias, logs, w)

    @staticmethod
    def backward(ctx, g):
        x, bias, logs, w = ctx.saved_tensors
        c = x.shape[-1]
        scale = torch.exp(logs)
        y = ((x + bias) * scale).reshape(-1, c)  # pre-matmul activations
        g = g.reshape(-1, c)
        gs = (g @ w) * scale
        return (gs.reshape(x.shape), gs.sum(0), (gs * (x + bias).reshape(-1, c)).sum(0),
                g.T @ y)


def actnorm_invconv(x, bias, logs, w):
    """y = ((x + bias)·e^logs) @ wᵀ over the last axis of x [..., C], f32:
    the step actnorm folded into the 1x1 (no logdet; the caller has it
    from ``logs`` and ``w`` alone)."""
    c = x.shape[-1]
    on_card = _check("actnorm_invconv", (x, bias, logs, w),
                     (x.shape, (c,), (c,), (c, c)))
    if not on_card:
        return actnorm_invconv_ref(x, bias, logs, w)
    if c > MAX_INVCONV_CHANNELS:
        raise ValueError(f"actnorm_invconv: {c} channels, the kernel takes "
                         f"at most {MAX_INVCONV_CHANNELS}")
    return _ActnormInvconv.apply(x, bias, logs, w)


actnorm_invconv.launches = 0

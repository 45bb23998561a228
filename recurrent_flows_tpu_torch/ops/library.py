"""The five kernels as ``torch.library`` operators in the ``rft`` namespace.

    torch.ops.rft.coupling_transform(z2, shift, s, reverse) -> (z2', ld)
    torch.ops.rft.actnorm_invconv(x, bias, logs, w) -> y
    torch.ops.rft.convlstm_gates(gates, c, w_ci, w_cf, w_co) -> (h', c')
    torch.ops.rft.glowstep(x, cond, <13 params>, clamp_type, reverse) -> (y, ld)
    torch.ops.rft.glowchain(x, cond, <13 stacked params>, clamp_type, reverse) -> (y, ld)

Each operator has a CUDA implementation (the kernel's launch, which counts
the launch on its public wrapper: ``ops.coupling_transform.launches``, ...),
a CPU implementation (the plain version), a fake one (shapes and strides of
the outputs, for tracing) and a registered autograd formula: the closed-form
backwards of the coupling and of the folded 1x1, and for the gates and the
two GlowStep kernels the plain version re-run under autograd on the saved
inputs, as the TPU kernels' VJPs re-run their jnp references. The public
wrappers (``ops.fused``, ``ops.glowstep``, ``ops.glowchain``) validate and
call these operators on every device, so an eager call and a call inside a
``torch.export`` graph reach the same implementation.

A GlowStep's 13 parameters (``GlowStepParams``) are 13 tensor arguments,
in the order of its fields. The coupling takes its inputs as the strided
views the flow passes (``fused.nhwc_view``) and reads their strides where
it runs, without a copy; its outputs are contiguous.

The operators are defined once, when this module is imported (the ``ops``
package imports it). A ``torch.export`` artifact that names them loads
only where they are registered.
"""

from __future__ import annotations

import torch

from . import fused
from .glowchain import _launch as _chain_launch
from .glowchain import glowchain_ref
from .glowstep import _launch as _step_launch
from .glowstep import GlowStepParams, glowstep_ref

NAMESPACE = "rft"
OPS = ("coupling_transform", "actnorm_invconv", "convlstm_gates", "glowstep", "glowchain")

_PARAMS = ", ".join(f"Tensor {f}" for f in GlowStepParams._fields)
_SCHEMAS = {
    "coupling_transform": "(Tensor z2, Tensor shift, Tensor s, bool reverse) -> (Tensor, Tensor)",
    "actnorm_invconv": "(Tensor x, Tensor bias, Tensor logs, Tensor w) -> Tensor",
    "convlstm_gates": ("(Tensor gates, Tensor c, Tensor w_ci, Tensor w_cf, Tensor w_co) "
                       "-> (Tensor, Tensor)"),
    "glowstep": f"(Tensor x, Tensor cond, {_PARAMS}, str clamp_type, bool reverse) "
                "-> (Tensor, Tensor)",
    "glowchain": f"(Tensor x, Tensor cond, {_PARAMS}, str clamp_type, bool reverse) "
                 "-> (Tensor, Tensor)",
}
_N_PARAMS = len(GlowStepParams._fields)

_LIB = torch.library.Library(NAMESPACE, "DEF")


def _dense(*outs):
    return tuple(t.contiguous() for t in outs)


def _dense_inputs(name, launch):
    """``launch`` behind a check that its inputs are contiguous (the kernels
    but the coupling's index them so); the public wrappers check it before
    the operator, a direct call of the operator here."""
    def cuda(*args):
        if not all(a.is_contiguous() for a in args if isinstance(a, torch.Tensor)):
            raise ValueError(f"rft::{name}: the kernel takes contiguous tensors")
        return launch(*args)

    return cuda


def _coupling_strides(z2, shift, s):
    return [fused.nhwc_view(name, t) for name, t in (("z2", z2), ("shift", shift), ("s", s))]


# -- implementations by device --------------------------------------------------


def _coupling_cpu(z2, shift, s, reverse):
    _coupling_strides(z2, shift, s)  # the layouts the kernel takes, on the CPU too
    return _dense(*fused.coupling_transform_ref(z2, shift, s, reverse))


def _coupling_cuda(z2, shift, s, reverse):
    return fused._coupling_launch(z2, shift, s, reverse, _coupling_strides(z2, shift, s))


def _glow_impls(ref, launch):
    def cpu(x, cond, *rest):
        *params, clamp_type, reverse = rest
        return _dense(*ref(x, cond, GlowStepParams(*params), clamp_type, reverse))

    def cuda(x, cond, *rest):
        *params, clamp_type, reverse = rest
        return launch(x, cond, GlowStepParams(*params), clamp_type, reverse)

    return cpu, _dense_inputs(launch.__module__.rsplit(".", 1)[-1], cuda)


_IMPLS = {
    "coupling_transform": (_coupling_cpu, _coupling_cuda),
    "actnorm_invconv": (lambda *a: fused.actnorm_invconv_ref(*a).contiguous(),
                        _dense_inputs("actnorm_invconv", fused._ainv_launch)),
    "convlstm_gates": (lambda *a: _dense(*fused.convlstm_gates_ref(*a)),
                       _dense_inputs("convlstm_gates", fused._gates_launch)),
    "glowstep": _glow_impls(glowstep_ref, _step_launch),
    "glowchain": _glow_impls(glowchain_ref, _chain_launch),
}


# -- fake implementations: the outputs' shapes; every output is contiguous -----


def _fake_pair(x, *rest):
    return x.new_empty(x.shape), x.new_empty(x.shape[:1])


def _fake_gates(gates, c, *peepholes):
    return c.new_empty(c.shape), c.new_empty(c.shape)


_FAKES = {
    "coupling_transform": _fake_pair,
    "actnorm_invconv": lambda x, *rest: x.new_empty(x.shape),
    "convlstm_gates": _fake_gates,
    "glowstep": _fake_pair,
    "glowchain": _fake_pair,
}


# -- autograd -------------------------------------------------------------------


def _save_all(ctx, inputs, output):
    ctx.save_for_backward(*(t for t in inputs if isinstance(t, torch.Tensor)))
    ctx.flags = tuple(a for a in inputs if not isinstance(a, torch.Tensor))


def _coupling_backward(ctx, g_out, g_ld):
    """The closed form of the TPU kernel's VJP."""
    z2, shift, s = ctx.saved_tensors
    (reverse,) = ctx.flags
    gl = g_ld.reshape((-1,) + (1,) * (s.dim() - 1))
    if not reverse:
        dz2 = g_out * torch.exp(s)
        return dz2, dz2, dz2 * (z2 + shift) + gl, None
    dz2 = g_out * torch.exp(-s)
    return dz2, -g_out, -dz2 * z2 + gl, None


def _ainv_backward(ctx, g):
    """The closed form of the TPU kernel's VJP."""
    x, bias, logs, w = ctx.saved_tensors
    c = x.shape[-1]
    scale = torch.exp(logs)
    y = ((x + bias) * scale).reshape(-1, c)  # pre-matmul activations
    g = g.reshape(-1, c)
    gs = (g @ w) * scale
    return (gs.reshape(x.shape), gs.sum(0), (gs * (x + bias).reshape(-1, c)).sum(0),
            g.T @ y)


def _replay_backward(ref):
    """A backward that re-runs ``ref(*tensors, *flags)`` under autograd on the
    saved inputs and takes the gradients of the wanted ones."""
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        needs = ctx.needs_input_grad[:len(tensors)]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(tensors, needs)]
            out = ref(*ins, *ctx.flags)
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grads, allow_unused=True))
        return tuple(next(got) if n else None for n in needs) + (None,) * len(ctx.flags)

    return backward


def _glow_ref(ref):
    return lambda x, cond, *rest: ref(x, cond, GlowStepParams(*rest[:_N_PARAMS]),
                                      *rest[_N_PARAMS:])


_BACKWARDS = {
    "coupling_transform": _coupling_backward,
    "actnorm_invconv": _ainv_backward,
    "convlstm_gates": _replay_backward(fused.convlstm_gates_ref),
    "glowstep": _replay_backward(_glow_ref(glowstep_ref)),
    "glowchain": _replay_backward(_glow_ref(glowchain_ref)),
}


for _name in OPS:
    _LIB.define(_name + _SCHEMAS[_name])
    _cpu, _cuda = _IMPLS[_name]
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _FAKES[_name], lib=_LIB)
    torch.library.register_autograd(f"{NAMESPACE}::{_name}", _BACKWARDS[_name],
                                    setup_context=_save_all, lib=_LIB)

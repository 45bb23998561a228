"""The five kernels as ``torch.library`` operators (``ops.library``,
namespace ``rft``), on the CPU, where each operator's implementation is its
plain version:

* ``torch.library.opcheck`` of each operator (schema, autograd
  registration, the fake implementation against the real one, AOT
  dispatch with dynamic shapes), both directions where there are two, the
  coupling on the strided 'split'/'cross' views the flow passes;
* each public wrapper gives what its plain version gives, bit for bit, and
  moves no launch count; its gradients through the registered formula
  equal autograd through the plain version bit for bit where the formula
  re-runs the plain version (the gates, ``glowstep``, ``glowchain``) and
  within ``tests/test_torch_ops_train.py``'s tolerance (rtol 1e-4, atol
  1e-4 of the largest entry) where it is a closed form (the coupling, the
  folded 1x1), whose products round in another order.

Sizes: maps of 2x2 to 3x3, C=2-8, a GlowStep of 4 hidden units.
"""

import numpy as np
import pytest
import torch

from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu_torch import ops
from recurrent_flows_tpu_torch.ops import GlowStepParams, library

C, CC, U = 2, 1, 4


def _rnd(gen, *shape, scale=1.0):
    return (scale * torch.randn(shape, generator=gen)).requires_grad_()


def _params(gen, lead=()):
    shapes = dict(an_bias=(C,), an_logs=(C,), w1x1=(C, C), wa=(9, C // 2 + CC, U),
                  ana_bias=(U,), ana_logs=(U,), wb=(U, U), anb_bias=(U,), anb_logs=(U,),
                  wc=(9, U, C), bias_c=(C,), clamp_scale=(C // 2,), clamp_shift=(C // 2,))
    return [_rnd(gen, *lead, *shapes[f], scale=0.3) for f in GlowStepParams._fields]


def _cases(reverse: bool):
    """{operator: (public wrapper's call, plain version's call, inputs)}."""
    g = torch.Generator().manual_seed(int(reverse))
    x, h = _rnd(g, 2, 3, 3, 8), _rnd(g, 2, 3, 3, 8, scale=0.5)
    coupling = [x[..., 4:], h[..., 0::2], torch.tanh(h[..., 1::2])]
    ainv = [_rnd(g, 10, 8), _rnd(g, 8, scale=0.3), _rnd(g, 8, scale=0.3),
            torch.linalg.qr(torch.randn(8, 8, generator=g))[0].contiguous().requires_grad_()]
    gates = [_rnd(g, 2, 2, 2, 16), _rnd(g, 2, 2, 2, 4)] + [
        _rnd(g, 1, 2, 2, 4, scale=0.1) for _ in range(3)]
    step = [_rnd(g, 1, 2, 2, C), _rnd(g, 1, 2, 2, CC)] + _params(g)
    chain = [_rnd(g, 1, 2, 2, C), _rnd(g, 1, 2, 2, CC)] + _params(g, (2,))
    glow = lambda f, i, clamp: f(i[0], i[1], GlowStepParams(*i[2:]), clamp, reverse)
    return {
        "coupling_transform": (lambda i: ops.coupling_transform(*i, reverse),
                               lambda i: ops.coupling_transform_ref(*i, reverse),
                               coupling, (reverse,)),
        "actnorm_invconv": (lambda i: ops.actnorm_invconv(*i),
                            lambda i: ops.actnorm_invconv_ref(*i), ainv, ()),
        "convlstm_gates": (lambda i: ops.convlstm_gates(*i),
                           lambda i: ops.convlstm_gates_ref(*i), gates, ()),
        "glowstep": (lambda i: glow(ops.glowstep, i, "realnvp"),
                     lambda i: glow(ops.glowstep_ref, i, "realnvp"), step, ("realnvp", reverse)),
        "glowchain": (lambda i: glow(ops.glowchain, i, "glow"),
                      lambda i: glow(ops.glowchain_ref, i, "glow"), chain, ("glow", reverse)),
    }


def test_the_five_operators_are_registered():
    assert library.OPS == ("coupling_transform", "actnorm_invconv", "convlstm_gates",
                           "glowstep", "glowchain")
    for name in library.OPS:
        assert str(getattr(torch.ops.rft, name).default._schema).startswith(f"rft::{name}(")


CHECKS = [(name, rev) for name in library.OPS for rev in (False, True)
          if rev is False or name in ("coupling_transform", "glowstep", "glowchain")]


@pytest.mark.parametrize("name,reverse", CHECKS)
def test_opcheck(name, reverse):
    _, _, inputs, flags = _cases(reverse)[name]
    torch.library.opcheck(getattr(torch.ops.rft, name).default, (*inputs, *flags))


@pytest.mark.parametrize("reverse", [False, True])
def test_wrappers_equal_their_plain_versions_values_and_gradients(reverse):
    before = ops.launch_counts()
    for name, (wrapper, ref, inputs, _) in _cases(reverse).items():
        if reverse and name in ("actnorm_invconv", "convlstm_gates"):
            continue  # one direction only
        got_grads, ref_grads = [], []
        for fn, grads in ((wrapper, got_grads), (ref, ref_grads)):
            ins = [t.detach().clone().requires_grad_() for t in inputs]
            if name == "coupling_transform":  # the views, as the flow passes them
                base = torch.cat([ins[0].detach(), ins[0].detach()], -1).requires_grad_()
                ins[0] = base[..., ins[0].shape[-1]:]
            outs = fn(ins)
            outs = outs if isinstance(outs, tuple) else (outs,)
            grads.append([o.detach() for o in outs])
            pg = torch.Generator().manual_seed(3)
            loss = sum((o * torch.randn(o.shape, generator=pg)).sum() for o in outs)
            got = torch.autograd.grad(loss, ins, allow_unused=True)  # 'glow' takes no clamp params
            grads.extend(torch.zeros_like(t) if g is None else g.detach() for t, g in zip(ins, got))
        for a, b in zip(got_grads[0], ref_grads[0]):
            assert torch.equal(a, b), (name, "values")
        for i, (a, b) in enumerate(zip(got_grads[1:], ref_grads[1:])):
            if name in ("coupling_transform", "actnorm_invconv"):
                b = b.numpy()
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                           atol=1e-4 * max(np.abs(b).max(), 1e-3),
                                           err_msg=f"{name} gradient {i}")
            else:
                assert torch.equal(a, b), (name, f"gradient {i}")
    assert ops.launch_counts() == before  # the CPU launches no kernel


def test_wrappers_still_validate_before_the_operator():
    x = torch.zeros(2, 3, 3, 8)
    with pytest.raises(ValueError, match="channel stride 1 or 2"):
        ops.coupling_transform(x[..., ::3], x[..., 4:7], x[..., 4:7])
    with pytest.raises(TypeError, match="float32"):
        ops.actnorm_invconv(torch.zeros(4, 8, dtype=torch.float64), *(torch.zeros(8),) * 2,
                            torch.eye(8))

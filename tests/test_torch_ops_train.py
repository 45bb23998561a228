"""The training slice's kernels on the CPU: the plain versions of
``actnorm_invconv`` and ``glowstep`` and the gradients of all five plain
versions, against the JAX package's jnp functions, its Pallas kernels in
interpret mode and its custom VJPs, on the same numpy inputs.

On the CPU a wrapper takes its plain version and autograd differentiates
it directly; the CUDA kernels and their autograd Functions are compared
with the plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).

Tolerances (float32 on both sides): a 1x1 product over C <= 16 channels
agrees to a few ulps (rtol/atol 1e-5 for values of order 1-10); one
GlowStep is three convs summed in another order (atol 1e-5 on outputs,
1e-4 on logdets, which sum B·H·W·C/2 terms); gradients are sums over all
rows (rtol 1e-4, atol 1e-4·max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_flows_tpu.ops.pallas import fused as jfused
from recurrent_flows_tpu.ops.pallas.glowstep import GlowStepParams as JParams
from recurrent_flows_tpu.ops.pallas.glowstep import glowstep_fused, glowstep_jnp
from recurrent_flows_tpu_torch import ops
from recurrent_flows_tpu_torch.ops import GlowStepParams, fused

CLAMPS = ["realnvp", "glow", "softclamp", "none"]


@pytest.fixture()
def force_pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas paths in interpreter mode on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("RFT_PALLAS", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


def _close_grads(got, ref, rtol=1e-4):
    for i, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-3),
                                   err_msg=f"gradient {i}")


def _torch_grads(fn, arrays, weights):
    """Gradients of Σ_i <out_i, weights_i> through the port's function."""
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.tensor(w)).sum() for o, w in zip(outs, weights))
    grads = torch.autograd.grad(loss, ins, allow_unused=True)
    return [torch.zeros_like(i) if g is None else g for i, g in zip(ins, grads)]


# --- actnorm_invconv ----------------------------------------------------------


def _ainv_inputs(seed=0, shape=(2, 8, 8, 16)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    return f(*shape), f(c, scale=0.3), f(c, scale=0.3), f(c, c, scale=c ** -0.5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 2, 2, 64), (300, 4)])
def test_actnorm_invconv_plain_matches_jnp_and_pallas(force_pallas_interpret, shape):
    x, bias, logs, w = _ainv_inputs(0, shape)
    args = [jnp.asarray(a) for a in (x, bias, logs, w)]
    got = ops.actnorm_invconv(*(torch.tensor(a) for a in (x, bias, logs, w)))
    for ref in (jfused._actnorm_invconv_jnp(*args), jfused.actnorm_invconv(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_actnorm_invconv_gradient_matches_jax_vjp(force_pallas_interpret):
    """The closed-form VJP of the JAX kernel (fused.py:201-211) against
    autograd through the port's plain version."""
    x, bias, logs, w = _ainv_inputs(1)
    proj = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(jfused.actnorm_invconv(*a) * proj),
                   argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, bias, logs, w)))
    _close_grads(_torch_grads(ops.actnorm_invconv, (x, bias, logs, w), [proj]), ref)


def test_actnorm_invconv_checks_inputs_and_counts_nothing_on_cpu():
    x, bias, logs, w = (torch.tensor(a) for a in _ainv_inputs())
    before = ops.launch_counts()
    assert torch.equal(ops.actnorm_invconv(x, bias, logs, w),
                       ops.actnorm_invconv_ref(x, bias, logs, w))
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="shape"):
        ops.actnorm_invconv(x, bias[:-1], logs, w)
    with pytest.raises(ValueError, match="shape"):
        ops.actnorm_invconv(x, bias, logs, w[:, :-1])
    with pytest.raises(TypeError):
        ops.actnorm_invconv(x.double(), bias, logs, w)
    with pytest.raises(ValueError, match="contiguous"):
        ops.actnorm_invconv(x, bias, logs, w.T)


# --- coupling and gates: gradients --------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_gradient_matches_jax_vjp(force_pallas_interpret, reverse):
    rng = np.random.default_rng(3)
    z2, shift, s = (0.5 * rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
                    for _ in range(3))
    proj = [rng.standard_normal(z2.shape).astype(np.float32),
            rng.standard_normal(2).astype(np.float32)]

    def jloss(*a):
        out, ld = jfused.coupling_transform(*a, reverse)
        return jnp.sum(out * proj[0]) + jnp.sum(ld * proj[1])

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (z2, shift, s)))
    got = _torch_grads(lambda *a: fused.coupling_transform(*a, reverse),
                       (z2, shift, s), proj)
    _close_grads(got, ref)


def test_gates_gradient_matches_jax_vjp(force_pallas_interpret):
    rng = np.random.default_rng(4)
    hc = 8
    arrays = [rng.standard_normal((2, 4, 4, 4 * hc)).astype(np.float32),
              rng.standard_normal((2, 4, 4, hc)).astype(np.float32)]
    arrays += [(0.1 * rng.standard_normal((1, 4, 4, hc))).astype(np.float32)
               for _ in range(3)]
    proj = [rng.standard_normal((2, 4, 4, hc)).astype(np.float32) for _ in range(2)]

    def jloss(*a):
        h, c = jfused.convlstm_gates(*a)
        return jnp.sum(h * proj[0]) + jnp.sum(c * proj[1])

    ref = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in arrays))
    _close_grads(_torch_grads(fused.convlstm_gates, arrays, proj), ref)


# --- glowstep -------------------------------------------------------------------


def _step_inputs(seed=0, b=2, h=4, c=8, cc=6, u=16):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    half = c // 2
    ps = JParams(
        an_bias=n(c), an_logs=n(c), w1x1=np.eye(c, dtype=np.float32) + n(c, c),
        wa=n(9, half + cc, u), ana_bias=n(u), ana_logs=n(u), wb=n(u, u),
        anb_bias=n(u), anb_logs=n(u), wc=n(9, u, c), bias_c=n(c),
        clamp_scale=np.ones(half, np.float32) + n(half), clamp_shift=n(half))
    return n(b, h, h, c, scale=1.0), n(b, h, h, cc, scale=1.0), ps


def _tp(ps):
    return GlowStepParams(*(torch.tensor(a) for a in ps))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("clamp", CLAMPS)
def test_glowstep_plain_matches_jnp_and_pallas(clamp, reverse):
    x, cond, ps = _step_inputs()
    y_j, ld_j = glowstep_jnp(jnp.asarray(x), jnp.asarray(cond), ps,
                             clamp_type=clamp, reverse=reverse)
    y_p, ld_p = glowstep_fused(jnp.asarray(x), jnp.asarray(cond), ps, clamp, reverse)
    y, ld = ops.glowstep(torch.tensor(x), torch.tensor(cond), _tp(ps), clamp, reverse)
    for y_ref, ld_ref in ((y_j, ld_j[:, 0]), (y_p, ld_p)):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("clamp", CLAMPS)
def test_glowstep_round_trip(clamp):
    """Forward then inverse with the inverted 1x1 gives x back, and the
    two coupling logdets are equal (the caller signs them)."""
    x, cond, ps = _step_inputs(1)
    fwd = _tp(ps)
    inv = fwd._replace(w1x1=torch.linalg.inv(fwd.w1x1).contiguous())
    y, ld = ops.glowstep(torch.tensor(x), torch.tensor(cond), fwd, clamp, False)
    back, ld_back = ops.glowstep(y, torch.tensor(cond), inv, clamp, True)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ld_back.numpy(), ld.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("clamp", CLAMPS)
def test_glowstep_gradients_match_jax_vjp(clamp):
    """Gradients with respect to x, cond and all 13 parameter leaves,
    against the JAX kernel's VJP (a jnp replay, glowstep.py:222-231)."""
    x, cond, ps = _step_inputs(2)
    rng = np.random.default_rng(5)
    proj = [rng.standard_normal(x.shape).astype(np.float32),
            rng.standard_normal(x.shape[0]).astype(np.float32)]

    def jloss(x, cond, ps):
        y, ld = glowstep_fused(x, cond, ps, clamp, False)
        return jnp.sum(y * proj[0]) + jnp.sum(ld * proj[1])

    gx, gc, gp = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(cond), JParams(*(jnp.asarray(a) for a in ps)))
    got = _torch_grads(
        lambda x, c, *leaves: ops.glowstep(x, c, GlowStepParams(*leaves), clamp, False),
        (x, cond, *ps), proj)
    _close_grads(got, (gx, gc, *gp))


def test_glowstep_wrapper_checks_inputs_and_counts_nothing_on_cpu():
    x, cond, ps = _step_inputs()
    x, cond, tp = torch.tensor(x), torch.tensor(cond), _tp(ps)
    before = ops.launch_counts()
    out = ops.glowstep(x, cond, tp, "realnvp", True)
    ref = ops.glowstep_ref(x, cond, tp, "realnvp", True)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert ops.launch_counts() == before and set(before) == {
        "actnorm_invconv", "convlstm_gates", "coupling_transform", "glowchain",
        "glowstep"}
    with pytest.raises(ValueError, match="wa"):
        ops.glowstep(x, cond, tp._replace(wa=tp.wa[:, :-1]), "realnvp", False)
    with pytest.raises(ValueError, match="an_bias"):  # stacked params are the chain's
        ops.glowstep(x, cond, GlowStepParams(*(a[None] for a in tp)), "realnvp", False)
    with pytest.raises(ValueError, match="NHWC"):
        ops.glowstep(x, cond[:, :2], tp, "realnvp", False)
    with pytest.raises(ValueError, match="clamp"):
        ops.glowstep(x, cond, tp, "tanh", False)

"""The port's 2-D flows against ``recurrent_flows_tpu.flows.realnvp2d`` on
the CPU: RealNVP (``f``, ``g``, ``log_prob``, ``sample`` with the base
eps replayed, gradients), the conditional RealNVP on rotating two-moons,
``MixtureCDFFlow`` both ways (its 60-step bisection inverse) and
``AutoregFlow2D``'s ``log_prob``, on JAX weights (perturbed off the zero
inits) converted by ``convert.from_flax``, which needs no code for
``cpl{i}.fc0/fc1/out``, ``logits/means/log_scales`` or flax's
``nn.Sequential`` names ``net.layers_0``/``net.layers_2``.

Sizes: 4 couplings, hidden 16, B=8. Tolerances: outputs 1e-5·(1+|ref|),
log-probabilities and logdets 1e-4·(1+|ref|), gradients 1e-4 of each
tensor's largest |entry|; the bisection inverse within 1e-4 of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.flows import realnvp2d as jr
from recurrent_flows_tpu_torch.convert import from_flax
from recurrent_flows_tpu_torch.flows import AutoregFlow2D, MixtureCDFFlow, RealNVP2D
from recurrent_flows_tpu_torch.utils import NoiseSource

B, TOL_OUT, TOL_LP, TOL_GRAD = 8, 1e-5, 1e-4, 1e-4


def _pair(jm, pm, *args, seed=0):
    v = jm.init(jax.random.key(seed), *args)
    v = {"params": U.perturb(v["params"], seed)}
    return v, U.port_from(pm, v)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("context_dim", [0, 1])
def test_realnvp_matches_jax(context_dim):
    jm = jr.RealNVP2D(n_couplings=4, hidden=16, context_dim=context_dim)
    x = _x((B, 2))
    ctx = _x((B, context_dim), 1) if context_dim else None
    args = (x, ctx) if context_dim else (x,)
    v, pm = _pair(jm, RealNVP2D(n_couplings=4, hidden=16, context_dim=context_dim,
                                device="cpu"), *args)
    assert {"cpl0.fc0.kernel", "cpl3.out.bias"} <= set(from_flax(v["params"], None, pm))
    tctx = torch.tensor(ctx) if context_dim else None
    z, ld = jm.apply(v, *args, method="f")
    tz, tld = pm.f(torch.tensor(x), tctx)
    U.assert_close_rel(tz.detach(), z, TOL_OUT, "f")
    U.assert_close_rel(tld.detach(), ld, TOL_LP, "logdet")
    U.assert_close_rel(pm.g(tz, tctx).detach(), jm.apply(v, z, ctx, method="g"), TOL_OUT, "g")
    np.testing.assert_allclose(pm.g(tz, tctx).detach().numpy(), x, atol=1e-5)  # a bijection
    lp, grads = jax.value_and_grad(lambda p: jnp.mean(jm.apply({"params": p}, *args)))(
        v["params"])
    got = pm.log_prob(torch.tensor(x), tctx).mean()
    U.assert_close_rel(got.detach(), lp, TOL_LP, "log_prob")
    got.backward()
    U.assert_grads_close(pm, grads, TOL_GRAD)
    key = jax.random.key(2)
    ref = jm.apply(v, key, B, ctx, method="sample")
    noise = NoiseSource(replay=[np.asarray(jax.random.normal(key, (B, 2)))])
    got = pm.sample(B, noise, tctx)
    assert noise.exhausted()
    U.assert_close_rel(got.detach(), ref, TOL_OUT, "sample")


def test_mixture_cdf_both_ways_and_autoreg_match_jax():
    jm = jr.MixtureCDFFlow(n_components=3)
    x = _x((16,)) * 2
    v, pm = _pair(jm, MixtureCDFFlow(3, device="cpu"), x)
    assert set(from_flax(v["params"], None, pm)) == {"logits", "means", "log_scales"}
    z, lp = jm.apply(v, x)
    tz, tlp = pm(torch.tensor(x))
    U.assert_close_rel(tz.detach(), z, TOL_OUT, "cdf")
    U.assert_close_rel(tlp.detach(), lp, TOL_LP, "log pdf")
    inv, _ = jm.apply(v, z, reverse=True)
    tinv, none = pm(torch.tensor(np.asarray(z)), reverse=True)
    assert none is None
    np.testing.assert_allclose(tinv.detach().numpy(), np.asarray(inv), atol=1e-4)
    np.testing.assert_allclose(tinv.detach().numpy(), x, atol=1e-3)

    ja = jr.AutoregFlow2D(n_components=3, hidden=8)
    x2 = _x((B, 2), 3)
    va, pa = _pair(ja, AutoregFlow2D(3, 8, device="cpu"), x2, seed=1)
    assert {"net.layers_0.kernel", "net.layers_2.bias", "f1.means"} <= set(
        from_flax(va["params"], None, pa))
    lp, grads = jax.value_and_grad(lambda p: jnp.mean(ja.apply({"params": p}, x2)))(
        va["params"])
    got = pa.log_prob(torch.tensor(x2)).mean()
    U.assert_close_rel(got.detach(), lp, TOL_LP, "autoreg log_prob")
    got.backward()
    U.assert_grads_close(pa, grads, TOL_GRAD)

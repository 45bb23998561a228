"""The port's glowchain plain version, prep_glowstep_params and ListGlow.sample
against the JAX package, on the same numpy inputs and converted weights.

The JAX side's ``glowchain_fused`` runs its Pallas kernel interpreted on the
CPU (glowchain.py:138). The CUDA kernel itself is compared with the plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances (float32 on both sides): one K-step chain is three convs per
step summed in another order, so outputs agree to ~1e-6 relative (atol
1e-5); logdets sum B·H·W·C/2·K terms (rtol 1e-5, atol 1e-4). A sampled
image passes 3 scales of steps and splits: atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.config import GlowConfig
from recurrent_flows_tpu.flows.glow import GlowStep as JGlowStep
from recurrent_flows_tpu.flows.glow import ListGlow as JListGlow
from recurrent_flows_tpu.flows.glow import prep_glowstep_params as jprep
from recurrent_flows_tpu.ops.pallas.glowchain import glowchain_fused, glowchain_jnp
from recurrent_flows_tpu.ops.pallas.glowstep import GlowStepParams as JParams
from recurrent_flows_tpu_torch.flows import glow as tglow
from recurrent_flows_tpu_torch.ops import GlowStepParams, glowchain, glowchain_ref
from recurrent_flows_tpu_torch.utils import NoiseSource

CLAMPS = ["realnvp", "glow", "softclamp", "none"]


def _chain_inputs(b=2, h=8, c=8, cc=6, u=16, k=3, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    half, ca = c // 2, c // 2 + cc
    ps = JParams(
        an_bias=n(k, c), an_logs=n(k, c),
        w1x1=np.tile(np.eye(c, dtype=np.float32)[None], (k, 1, 1)) + n(k, c, c),
        wa=n(k, 9, ca, u), ana_bias=n(k, u), ana_logs=n(k, u),
        wb=n(k, u, u), anb_bias=n(k, u), anb_logs=n(k, u),
        wc=n(k, 9, u, c), bias_c=n(k, c),
        clamp_scale=np.ones((k, half), np.float32) + n(k, half),
        clamp_shift=n(k, half),
    )
    x = rng.standard_normal((b, h, h, c)).astype(np.float32)
    cond = rng.standard_normal((b, h, h, cc)).astype(np.float32)
    return x, cond, ps


def _torch_params(ps):
    return GlowStepParams(*(torch.tensor(a) for a in ps))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("clamp", CLAMPS)
def test_chain_plain_matches_jnp_and_pallas(clamp, reverse):
    x, cond, ps = _chain_inputs()
    y_j, ld_j = glowchain_jnp(jnp.asarray(x), jnp.asarray(cond), ps,
                              clamp_type=clamp, reverse=reverse)
    y_p, ld_p = glowchain_fused(jnp.asarray(x), jnp.asarray(cond), ps, clamp, reverse)
    y, ld = glowchain(torch.tensor(x), torch.tensor(cond), _torch_params(ps),
                      clamp, reverse)
    for y_ref, ld_ref in ((y_j, ld_j[:, 0]), (y_p, ld_p)):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), rtol=1e-5, atol=1e-4)


def test_chain_wrapper_checks_shapes():
    x, cond, ps = _chain_inputs()
    tp = _torch_params(ps)
    with pytest.raises(ValueError, match="wb"):
        glowchain(torch.tensor(x), torch.tensor(cond), tp._replace(wb=tp.wb[:, :-1]),
                  "realnvp", True)
    with pytest.raises(ValueError, match="NHWC"):
        glowchain(torch.tensor(x), torch.tensor(cond)[:, :4], tp, "realnvp", True)
    with pytest.raises(ValueError, match="clamp"):
        glowchain(torch.tensor(x), torch.tensor(cond), tp, "tanh", True)
    out = glowchain(torch.tensor(x), torch.tensor(cond), tp, "realnvp", True)
    ref = glowchain_ref(torch.tensor(x), torch.tensor(cond), tp, "realnvp", True)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


# --- prep_glowstep_params ----------------------------------------------------

C, CC = 8, 6


@pytest.fixture(scope="module")
def glowstep_pair():
    cfg = GlowConfig(L=1, K=1, n_units_affine=U.U)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 8, 8, C)), jnp.float32)
    cond = jnp.asarray(np.random.default_rng(1).standard_normal((2, 8, 8, CC)), jnp.float32)
    v = jax.jit(JGlowStep(C, cfg).init)(jax.random.key(2), x, cond)
    v = {"params": U.perturb(v["params"], 3), "consts": v["consts"]}
    step = U.port_from(tglow.GlowStep(C, CC, U.to_port(cfg)), v)
    return cfg, v, step, np.asarray(x), np.asarray(cond)


@pytest.mark.parametrize("reverse", [False, True])
def test_prep_glowstep_params_matches_jax(glowstep_pair, reverse):
    cfg, v, step, _, _ = glowstep_pair
    ref, ref_ld = jprep(v["params"], v["consts"], cfg, C, reverse)
    with torch.no_grad():
        got, got_ld = tglow.prep_glowstep_params(step, reverse)
    for name, a, b in zip(JParams._fields, got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(got_ld.item(), float(ref_ld), rtol=1e-6)


def test_glowstep_reverse_module_and_chain_match_jax(glowstep_pair):
    """The module path (AffineCoupling reverse + the folded inverse 1x1) and
    the chain on prepped params both equal the JAX GlowStep's inverse."""
    cfg, v, step, x, cond = glowstep_pair
    ref, _ = JGlowStep(C, cfg).apply(v, jnp.asarray(x), jnp.asarray(cond), reverse=True)
    with torch.no_grad():
        got = step.reverse(torch.tensor(x), torch.tensor(cond))
        p, _ = tglow.prep_glowstep_params(step, True)
        chained, _ = glowchain_ref(torch.tensor(x), torch.tensor(cond),
                                   GlowStepParams(*(a[None] for a in p)),
                                   cfg.clamp_type, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(chained.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --- ListGlow.sample ----------------------------------------------------------

B, IMG = 2, 64
COND_CH = [5, 6, 7]  # per scale: 32x32, 16x16, 8x8
BASE_CH = 6


@pytest.fixture(scope="module")
def listglow_vars():
    cfg = GlowConfig(L=3, K=2, n_units_affine=U.U, n_units_prior=16)
    rng = np.random.default_rng(0)
    conds = [rng.standard_normal((B, IMG >> (l + 1), IMG >> (l + 1), c)).astype(np.float32)
             for l, c in enumerate(COND_CH)]
    base = rng.standard_normal((B, 8, 8, BASE_CH)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (B, IMG, IMG, 1)).astype(np.float32)
    v = jax.jit(JListGlow(1, IMG, cfg).init)(
        jax.random.key(0), x, [jnp.asarray(c) for c in conds], base, jax.random.key(1))
    v = {"params": U.perturb(v["params"], 4), "consts": v["consts"]}
    return cfg, v, conds, base


@pytest.mark.parametrize("chain_impl", ["sample", "off"])
def test_listglow_sample_matches_jax(listglow_vars, monkeypatch, chain_impl):
    import dataclasses

    cfg, v, conds, base = listglow_vars
    cfg = dataclasses.replace(cfg, chain_impl=chain_impl)
    key = jax.random.key(7)
    ref = JListGlow(1, IMG, cfg).apply(
        v, None, [jnp.asarray(c) for c in conds], jnp.asarray(base), key,
        temperature=0.7, method="sample")
    flow = U.port_from(tglow.ListGlow(1, IMG, U.to_port(cfg), COND_CH, BASE_CH), v)
    calls = []
    monkeypatch.setattr(tglow, "glowchain",
                        lambda *a: calls.append(a[0].shape) or glowchain(*a))
    noise = NoiseSource(replay=U.flow_sample_noise(key, cfg, 1, IMG, B))
    with torch.no_grad():
        got = flow.sample([torch.tensor(c) for c in conds], torch.tensor(base),
                          noise, temperature=0.7)
    assert noise.exhausted()
    # scales 1-2 (16x16, 8x8) go through the chain; scale 0 (32x32) never
    want = [(B, 8, 8, 16), (B, 16, 16, 8)] if chain_impl == "sample" else []
    assert [tuple(s) for s in calls] == want
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)

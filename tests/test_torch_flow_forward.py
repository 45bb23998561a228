"""The flow's density direction and its data-dependent init against the JAX
package: each forward module, ``GlowStep.forward`` on the module path and
through the whole-step kernel's plain version, and ``ListGlow.log_prob``
with its gradients under the three configurations of the training step
(A the module path, B ``coupling_impl='fused'``, C ``chain_impl='all'``),
on converted weights (a JAX init perturbed off its zero inits) and the same
numpy inputs. The JAX side runs its Pallas kernels interpreted on the CPU.

Tolerances (float32 on both sides): single modules agree to ~1e-6 relative
(rtol/atol 1e-5); a logdet or nll sums B·H·W·C terms of order 1 (rtol 1e-5);
DDI statistics are means and standard deviations over B·H·W values
(atol 1e-5); gradients of the nll are sums over all positions (rtol 1e-4,
atol 1e-4 of the tensor's largest entry).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.config import GlowConfig
from recurrent_flows_tpu.flows import modules as jmod
from recurrent_flows_tpu.flows.ddi import merge_ddi
from recurrent_flows_tpu.flows.glow import GlowStep as JGlowStep
from recurrent_flows_tpu.flows.glow import ListGlow as JListGlow
from recurrent_flows_tpu_torch.convert import tree_from_flax
from recurrent_flows_tpu_torch.flows import glow as tglow
from recurrent_flows_tpu_torch.flows import modules as tmod
from recurrent_flows_tpu_torch.utils import NoiseSource

B = 2
CONFIGS = {"A": {}, "B": dict(coupling_impl="fused"), "C": dict(chain_impl="all")}


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _init(module, *args, seed=0, **kw):
    v = jax.jit(lambda k, *a: module.init(k, *a, **kw))(jax.random.key(seed), *args)
    out = {"params": U.perturb(v["params"], seed + 100)}
    if "consts" in v:
        out["consts"] = v["consts"]
    return out


def _close(got, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


def _check_ddi_params(module, merged):
    """Every parameter of the port equals the JAX tree after merge_ddi."""
    named = dict(module.named_parameters())
    for name, ref in _leaves(merged):
        ref = np.asarray(ref)
        if name.endswith("kernel") and ref.ndim == 4:
            ref = ref.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(named[name].detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_actnorm_forward_and_ddi_match_jax():
    x = _x(B, 8, 8, 6, seed=1, scale=3.0) + 0.7
    jm = jmod.ActNorm(6)
    v = _init(jm, x)
    ref, ref_ld = jm.apply(v, x, jnp.zeros(B))
    tm = U.port_from(tmod.ActNorm(6), v)
    got, ld = tm(torch.tensor(x), torch.zeros(B))
    _close(got, ref)
    _close(ld, ref_ld)
    (ref, ref_ld), mut = jm.apply(v, x, jnp.zeros(B), ddi=True, mutable=["ddi"])
    with torch.no_grad():
        got, ld = tm(torch.tensor(x), torch.zeros(B), ddi=True)
    _close(got, ref)
    _close(ld, ref_ld, rtol=1e-4, atol=1e-4)
    _check_ddi_params(tm, mut["ddi"])
    # zero mean, unit standard deviation (ddof=1) per channel
    flat = got.reshape(-1, 6)
    assert flat.mean(0).abs().max() < 1e-5
    assert (flat.std(0, unbiased=True) - 1).abs().max() < 1e-4


@pytest.mark.parametrize("fold", [True, False])
def test_invconv_forward_matches_jax(fold):
    c = 8
    x = _x(B, 8, 8, c, seed=2)
    bias, logs = _x(c, seed=3, scale=0.3), _x(c, seed=4, scale=0.3)
    jm = jmod.InvConv(c)
    v = _init(jm, x)
    kw = dict(fold_bias=jnp.asarray(bias), fold_logs=jnp.asarray(logs)) if fold else {}
    ref, ref_ld = jm.apply(v, x, jnp.zeros(B), **kw)
    tm = U.port_from(tmod.InvConv(c), v)
    fold_args = (torch.tensor(bias), torch.tensor(logs)) if fold else ()
    got, ld = tm(torch.tensor(x), torch.zeros(B), *fold_args)
    _close(got, ref)
    _close(ld, ref_ld, rtol=1e-5, atol=1e-4)
    # forward then reverse is the identity
    if fold:
        back = tm.reverse(got, *fold_args)
        _close(back, x, atol=1e-4)


def test_conv2dnorm_ddi_path_matches_jax():
    x = _x(B, 8, 8, 5, seed=5)
    jm = jmod.Conv2dNorm(12, 3)
    v = _init(jm, x)
    ref, mut = jm.apply(v, x, ddi=True, mutable=["ddi"])
    tm = U.port_from(tmod.Conv2dNorm(5, 12, 3), v)
    with torch.no_grad():
        got = tm(torch.tensor(x), ddi=True)
    _close(got, ref, atol=2e-5)
    _check_ddi_params(tm, merge_ddi(v["params"], mut["ddi"]))
    # the folded path on the fresh values gives the same output
    _close(tm(torch.tensor(x)), ref, atol=2e-5)


@pytest.mark.parametrize("clamp", ["realnvp", "glow", "softclamp", "none"])
def test_affine_coupling_forward_matches_jax(clamp):
    c, cc, u = 4, 5, 16
    x, cond = _x(B, 16, 16, c, seed=6), _x(B, 16, 16, cc, seed=7)
    jm = jmod.AffineCoupling(c, hidden_units=u, clamp_type=clamp)
    v = _init(jm, x, cond)
    ref, ref_ld = jax.jit(lambda v, x, c: jm.apply(v, x, c, jnp.zeros(B)))(v, x, cond)
    tm = U.port_from(tmod.AffineCoupling(c, cc, u, clamp_type=clamp), v)
    got, ld = tm(torch.tensor(x), torch.tensor(cond), torch.zeros(B))
    _close(got, ref)
    _close(ld, ref_ld, atol=1e-4)
    back, ld_back = tm.reverse(got, torch.tensor(cond))
    _close(back, x, atol=1e-4)
    _close(ld_back, ref_ld, atol=1e-4)


@pytest.mark.parametrize("act", ["softplus", "exp"])
def test_split2d_forward_matches_jax(act):
    c, cc = 8, 6
    x, cond = _x(B, 8, 8, c, seed=8), _x(B, 8, 8, cc, seed=9)
    jm = jmod.Split2d(c, clamp_function=act)
    v = _init(jm, x, cond)
    ref, ref_ld = jm.apply(v, x, cond, jnp.zeros(B))
    tm = U.port_from(tmod.Split2d(c, cc, clamp_function=act), v)
    got, ld = tm(torch.tensor(x), torch.tensor(cond), torch.zeros(B))
    assert np.array_equal(got.numpy(), np.asarray(ref))  # z1 passes through
    _close(ld, ref_ld, rtol=1e-5, atol=1e-4)


C, CC = 8, 6


@pytest.fixture(scope="module")
def glowstep_vars():
    cfg = GlowConfig(L=1, K=1, n_units_affine=U.U)
    x, cond = _x(B, 8, 8, C, seed=10), _x(B, 8, 8, CC, seed=11)
    v = jax.jit(JGlowStep(C, cfg).init)(jax.random.key(2), x, cond)
    return cfg, {"params": U.perturb(v["params"], 3), "consts": v["consts"]}, x, cond


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_glowstep_forward_matches_jax(glowstep_vars, impl, monkeypatch):
    cfg, v, x, cond = glowstep_vars
    cfg = dataclasses.replace(cfg, coupling_impl=impl)
    ref, ref_ld = JGlowStep(C, cfg).apply(v, x, cond, jnp.zeros(B))
    step = U.port_from(tglow.GlowStep(C, CC, U.to_port(cfg)), v)
    calls, kernel = [], tglow.glowstep
    monkeypatch.setattr(tglow, "glowstep",
                        lambda *a: (calls.append(a[-1]), kernel(*a))[1])
    got, ld = step(torch.tensor(x), torch.tensor(cond), torch.zeros(B))
    assert calls == ([False] if impl == "fused" else [])
    _close(got, ref)
    _close(ld, ref_ld, rtol=1e-5, atol=1e-4)
    back = step.reverse(got, torch.tensor(cond))
    assert calls == ([False, True] if impl == "fused" else [])
    _close(back, x, atol=1e-4)


def test_glowstep_ddi_matches_jax_and_skips_the_fused_path(glowstep_vars, monkeypatch):
    cfg, v, x, cond = glowstep_vars
    cfg = dataclasses.replace(cfg, coupling_impl="fused")
    (ref, ref_ld), mut = JGlowStep(C, cfg).apply(v, x, cond, jnp.zeros(B), ddi=True,
                                                 mutable=["ddi"])
    step = U.port_from(tglow.GlowStep(C, CC, U.to_port(cfg)), v)
    monkeypatch.setattr(tglow, "glowstep", None)  # the DDI pass must not reach it
    with torch.no_grad():
        got, ld = step(torch.tensor(x), torch.tensor(cond), torch.zeros(B), ddi=True)
    _close(got, ref, atol=2e-5)
    _close(ld, ref_ld, rtol=1e-4, atol=1e-4)
    _check_ddi_params(step, merge_ddi(v["params"], mut["ddi"]))


# --- ListGlow.log_prob --------------------------------------------------------

IMG = 64
COND_CH = [5, 6, 7]  # per scale: 32x32 (module path always), 16x16, 8x8
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
    return cfg, v, x, conds, base


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_listglow_log_prob_and_gradients_match_jax(listglow_vars, monkeypatch, config):
    cfg, v, x, conds, base = listglow_vars
    cfg = dataclasses.replace(cfg, **CONFIGS[config])
    key = jax.random.key(7)
    jflow = JListGlow(1, IMG, cfg)

    def jnll(params):
        z, nll = jflow.apply({"params": params, "consts": v["consts"]}, x,
                             [jnp.asarray(c) for c in conds], jnp.asarray(base), key,
                             method="log_prob")
        return jnp.sum(nll), (z, nll)

    (_, (ref_z, ref_nll)), ref_grads = jax.jit(
        jax.value_and_grad(jnll, has_aux=True))(v["params"])
    flow = U.port_from(tglow.ListGlow(1, IMG, U.to_port(cfg), COND_CH, BASE_CH), v)
    calls = {"glowstep": [], "glowchain": []}
    for name in calls:
        kernel = getattr(tglow, name)
        monkeypatch.setattr(tglow, name, lambda *a, _k=kernel, _n=name: (
            calls[_n].append(tuple(a[0].shape)), _k(*a))[1])
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32, 0.0, 1.0 / 256))
    noise = NoiseSource(replay=[u])
    z, nll = flow.log_prob(torch.tensor(x), [torch.tensor(c) for c in conds],
                           torch.tensor(base), noise)
    assert noise.exhausted()
    # scales 1-2 (16x16, 8x8) go through the kernels' wrappers; scale 0 never
    deep = [(B, 16, 16, 8), (B, 8, 8, 16)]
    assert calls["glowstep"] == ([s for s in deep for _ in range(cfg.K)]
                                 if config == "B" else [])
    assert calls["glowchain"] == (deep if config == "C" else [])
    _close(z, ref_z, rtol=1e-4, atol=1e-4)
    _close(nll, ref_nll, rtol=1e-5, atol=1e-2)  # nll of order 1e4
    nll.sum().backward()
    want = tree_from_flax(ref_grads, flow)
    for name, p in flow.named_parameters():
        r = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(r).max(), 1e-2), err_msg=name)


def test_listglow_ddi_pass_matches_jax(listglow_vars):
    """One sweep: each ActNorm takes its statistics from an input that has
    passed the fresh actnorms upstream, and the pass takes the module path
    even where the configuration asks for the kernels."""
    cfg, v, x, conds, base = listglow_vars
    cfg = dataclasses.replace(cfg, chain_impl="all", coupling_impl="fused")
    key = jax.random.key(8)
    (_, ref_nll), mut = jax.jit(lambda v: JListGlow(1, IMG, cfg).apply(
        v, x, [jnp.asarray(c) for c in conds], jnp.asarray(base), key, ddi=True,
        method="log_prob", mutable=["ddi"]))(v)
    flow = U.port_from(tglow.ListGlow(1, IMG, U.to_port(cfg), COND_CH, BASE_CH), v)
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32, 0.0, 1.0 / 256))
    with torch.no_grad():
        _, nll = flow.log_prob(torch.tensor(x), [torch.tensor(c) for c in conds],
                               torch.tensor(base), NoiseSource(replay=[u]), ddi=True)
    _close(nll, ref_nll, rtol=1e-4, atol=1e-2)
    merged = merge_ddi(v["params"], mut["ddi"])
    _check_ddi_params(flow, merged)
    n_actnorms = sum(1 for name, _ in _leaves(mut["ddi"]) if name.endswith("logs"))
    assert n_actnorms == 3 * 2 * 3 + 2 * 2 + 2  # steps, splits, base prior

"""The flow variants against the JAX package, on the CPU: ``BatchNormFlow``
(forward, logdet, gradients, reverse, its running statistics after a
mutable apply), ``InvConv(lu_decomposed=False)``, ``Conv2dNorm`` with a
batch norm and with no norm, ``GlowStep`` under each knob, ``ListGlow``
with ``base_norm`` other than actnorm, then ``RFN.loss`` (pieces and
gradients) and ``RFN.predict`` at a tiny 3-channel L=4 configuration (the
``rfn_bair`` geometry) and at the tiny batch-norm variant
(``flow_norm='batchnorm'``, ``base_norm='batchnorm'``,
``lu_decomposed=False``, ``track_running_stats=True``). Converted weights
(a JAX init perturbed off its zero inits) and the same numpy inputs; the
JAX draws replayed through ``NoiseSource``.

Tolerances (float32 on both sides), no looser than test_torch_rfn.py and
test_torch_loss.py: single modules rtol/atol 1e-5 (a logdet summed over
[H, W, C] or B·H·W·C terms atol 1e-4); gradients rtol 1e-4, atol 1e-4 of
the tensor's largest entry; ``RFN.loss`` pieces within 1e-5·(1+|ref|) and
its gradients as in test_torch_loss.py; ``RFN.predict`` within
5e-6·(1+max|ref|) on the first predicted frame and 2.5e-5·(1+max|ref|) on
all: test_torch_rfn.py's atol 2e-5 and 1e-4 on its outputs of order 3, in
relative form, since the 3-channel L=4 rollout's outputs reach order 70,
where a float32 ulp is already 8e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.config import GlowConfig
from recurrent_flows_tpu.flows import modules as jmod
from recurrent_flows_tpu.flows.glow import GlowStep as JGlowStep
from recurrent_flows_tpu.flows.glow import ListGlow as JListGlow
from recurrent_flows_tpu_torch.convert import tree_from_flax
from recurrent_flows_tpu_torch.flows import glow as tglow
from recurrent_flows_tpu_torch.flows import modules as tmod
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.utils import NoiseSource
from recurrent_flows_tpu_torch.utils.running_stats import updating_running_stats

B = 3


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _init(module, *args, seed=0, **kw):
    v = jax.jit(lambda k, *a: module.init(k, *a, **kw))(jax.random.key(seed), *args)
    out = {"params": U.perturb(v["params"], seed + 100)}
    for coll in ("consts", "batch_stats"):
        if coll in v:
            out[coll] = v[coll]
    return out


def _grads_close(module, ref_grads, grads=None):
    """Each gradient (``p.grad``, or ``grads[name]``) within rtol 1e-4 and
    atol 1e-4 of its largest entry; a gradient that is zero by construction
    (a conv bias in front of a batch norm) is float noise on both sides, so
    the atol never goes below 1e-6 of the module's largest gradient entry;
    a parameter the configuration does not use has none (as in
    test_torch_loss.py)."""
    want = tree_from_flax(ref_grads, module)
    floor = 1e-6 * max(r.abs().max().item() for r in want.values())
    for name, p in module.named_parameters():
        r = want[name].numpy()
        g = p.grad if grads is None else grads.get(name)
        if g is None:
            assert not r.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=max(1e-4 * np.abs(r).max(), floor), err_msg=name)


# --- BatchNormFlow ------------------------------------------------------------


@pytest.mark.parametrize("momentum", [0.0, 0.3])
def test_batchnorm_flow_matches_jax(momentum):
    shape = (4, 4, 6)
    x = _x(B, *shape, seed=1, scale=2.0) + 0.5
    jm = jmod.BatchNormFlow(shape, momentum=momentum)
    v = _init(jm, x)
    v["batch_stats"] = U.running_stats_like(v["batch_stats"], 2)
    r = _x(B, *shape, seed=3)

    def objective(params, x):
        y, ld = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                         jnp.zeros(B))
        return jnp.sum(y * r) + jnp.sum(ld), (y, ld)

    (_, (ref, ref_ld)), (g_params, g_x) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(v["params"], x)
    tm = U.port_from(tmod.BatchNormFlow(shape, momentum), v)
    tx = torch.tensor(x, requires_grad=True)
    got, ld = tm(tx, torch.zeros(B))
    _close(got, ref)
    _close(ld, ref_ld, atol=1e-4)
    ((got * torch.tensor(r)).sum() + ld.sum()).backward()
    _close(tx.grad, g_x, atol=1e-5)
    _grads_close(tm, g_params)
    # no update outside the context, even in training mode
    _close(tm.running_mean, v["batch_stats"]["running_mean"], rtol=0, atol=0)
    # a mutable apply (JAX) and the update context (port) move them alike
    (_, _), mut = jm.apply(v, x, jnp.zeros(B), mutable=["batch_stats"])
    with torch.no_grad(), updating_running_stats():
        tm(torch.tensor(x), torch.zeros(B))
    for k in ("running_mean", "running_var"):
        _close(getattr(tm, k), mut["batch_stats"][k], atol=1e-6)
    # eval mode and the reverse use the running statistics
    vm = {**v, "batch_stats": mut["batch_stats"]}
    ref, ref_ld = jm.apply(vm, x, jnp.zeros(B), training=False)
    got, ld = tm(torch.tensor(x), torch.zeros(B), training=False)
    _close(got, ref)
    _close(ld, ref_ld, atol=1e-4)
    back, _ = jm.apply(vm, np.asarray(ref), reverse=True)
    _close(tm.reverse(got), back)
    _close(tm.reverse(got), x, atol=1e-4)


# --- InvConv without LU -------------------------------------------------------


@pytest.mark.parametrize("fold", [True, False])
def test_invconv_without_lu_matches_jax(fold):
    c = 8
    x = _x(B, 4, 4, c, seed=4)
    bias, logs = _x(c, seed=5, scale=0.3), _x(c, seed=6, scale=0.3)
    jm = jmod.InvConv(c, lu_decomposed=False)
    v = _init(jm, x)
    assert "consts" not in v  # the JAX 'consts' collection exists only under LU
    kw = dict(fold_bias=jnp.asarray(bias), fold_logs=jnp.asarray(logs)) if fold else {}
    r = _x(B, 4, 4, c, seed=7)

    def objective(params):
        y, ld = jm.apply({"params": params}, x, jnp.zeros(B), **kw)
        return jnp.sum(y * r) + jnp.sum(ld), (y, ld)

    (_, (ref, ref_ld)), grads = jax.value_and_grad(objective, has_aux=True)(v["params"])
    tm = U.port_from(tmod.InvConv(c, lu_decomposed=False), v)
    assert dict(tm.named_buffers()) == {}
    fold_args = (torch.tensor(bias), torch.tensor(logs)) if fold else ()
    got, ld = tm(torch.tensor(x), torch.zeros(B), *fold_args)
    _close(got, ref)
    _close(ld, ref_ld, atol=1e-4)
    ((got * torch.tensor(r)).sum() + ld.sum()).backward()
    _grads_close(tm, grads)
    back_ref, _ = jm.apply(v, np.asarray(ref), reverse=True, **kw)
    with torch.no_grad():
        back = tm.reverse(got, *fold_args)
    _close(back, back_ref, atol=1e-5)
    _close(back, x, atol=1e-4)


# --- Conv2dNorm ---------------------------------------------------------------


@pytest.mark.parametrize("norm", ["batchnorm", "none"])
@pytest.mark.parametrize("kernel", [3, 1])
def test_conv2dnorm_with_other_norms_matches_jax(norm, kernel):
    x = _x(B, 8, 8, 5, seed=8)
    jm = jmod.Conv2dNorm(12, kernel, norm=norm)
    v = _init(jm, x)
    assert "bias" in v["params"]["conv"]  # the conv's bias is on
    r = _x(B, 8, 8, 12, seed=9)

    def objective(params):
        y = jm.apply({"params": params}, x)
        return jnp.sum(y * r), y

    (_, ref), grads = jax.value_and_grad(objective, has_aux=True)(v["params"])
    tm = U.port_from(tmod.Conv2dNorm(5, 12, kernel, norm), v)
    got = tm(torch.tensor(x))
    _close(got, ref, atol=2e-5)
    (got * torch.tensor(r)).sum().backward()
    _grads_close(tm, grads)
    with torch.no_grad():  # the DDI flag changes nothing without an actnorm
        _close(tm(torch.tensor(x), ddi=True), ref, atol=2e-5)


# --- GlowStep -----------------------------------------------------------------

STEP_KNOBS = {
    "batchnorm_flow": dict(flow_norm="batchnorm"),
    "batchnorm_flow_no_lu": dict(flow_norm="batchnorm", lu_decomposed=False),
    "no_lu": dict(lu_decomposed=False),
    "coupling_batchnorm": dict(coupling_norm="batchnorm"),
    "coupling_none": dict(coupling_norm="none"),
}


@pytest.mark.parametrize("knobs", sorted(STEP_KNOBS))
def test_glowstep_variant_matches_jax(knobs):
    c, cc, hw = 8, 6, 4
    cfg = GlowConfig(L=1, K=1, n_units_affine=U.U, **STEP_KNOBS[knobs])
    x, cond = _x(B, hw, hw, c, seed=10), _x(B, hw, hw, cc, seed=11)
    jm = JGlowStep(c, cfg, spatial_shape=(hw, hw, c))
    v = _init(jm, x, cond, seed=2)
    if "batch_stats" in v:
        v["batch_stats"] = U.running_stats_like(v["batch_stats"], 3)
    ref, ref_ld = jm.apply(v, x, cond, jnp.zeros(B))
    step = U.port_from(tglow.GlowStep(c, cc, U.to_port(cfg), (hw, hw, c)), v)
    got, ld = step(torch.tensor(x), torch.tensor(cond), torch.zeros(B))
    _close(got, ref, atol=2e-5)
    _close(ld, ref_ld, atol=1e-4)
    back_ref, _ = jm.apply(v, np.asarray(ref), cond, reverse=True)
    with torch.no_grad():
        back = step.reverse(got, torch.tensor(cond))
    _close(back, back_ref, atol=2e-5)
    if "batch_stats" not in v:  # the batch norm inverts with running statistics
        _close(back, x, atol=1e-4)


# --- ListGlow with other base and coupling norms ------------------------------

IMG, COND_CH, BASE_CH = 16, [5, 6], 6
FLOW_KNOBS = {
    "base_batchnorm": dict(base_norm="batchnorm"),
    "base_none": dict(base_norm="none", coupling_norm="none"),
    "batchnorm_variant": dict(flow_norm="batchnorm", base_norm="batchnorm",
                              lu_decomposed=False, chain_impl="all",
                              coupling_impl="fused"),
}


@pytest.mark.parametrize("knobs", sorted(FLOW_KNOBS))
def test_listglow_variant_log_prob_gradients_and_sample_match_jax(knobs):
    cfg = GlowConfig(L=2, K=2, n_units_affine=U.U, n_units_prior=16, **FLOW_KNOBS[knobs])
    rng = np.random.default_rng(0)
    conds = [rng.standard_normal((B, IMG >> (l + 1), IMG >> (l + 1), c)).astype(np.float32)
             for l, c in enumerate(COND_CH)]
    base = rng.standard_normal((B, 4, 4, BASE_CH)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (B, IMG, IMG, 3)).astype(np.float32)
    jflow = JListGlow(3, IMG, cfg)
    v = jax.jit(jflow.init)(jax.random.key(0), x, [jnp.asarray(c) for c in conds], base,
                            jax.random.key(1))
    v = {**v, "params": U.perturb(v["params"], 4)}
    key = jax.random.key(7)

    def jnll(params):
        z, nll = jflow.apply({**v, "params": params}, x, [jnp.asarray(c) for c in conds],
                             jnp.asarray(base), key, method="log_prob")
        return jnp.sum(nll), (z, nll)

    (_, (ref_z, ref_nll)), ref_grads = jax.jit(
        jax.value_and_grad(jnll, has_aux=True))(v["params"])
    flow = U.port_from(tglow.ListGlow(3, IMG, U.to_port(cfg), COND_CH, BASE_CH), v)
    # the kernels never take a batch-norm or non-LU flow
    assert not any(flow.chain_eligible(l, B, r) for l in range(2) for r in (False, True))
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32, 0.0, 1.0 / 256))
    z, nll = flow.log_prob(torch.tensor(x), [torch.tensor(c) for c in conds],
                           torch.tensor(base), NoiseSource(replay=[u]))
    _close(z, ref_z, rtol=1e-4, atol=1e-4)
    _close(nll, ref_nll, rtol=1e-5, atol=1e-2)
    nll.sum().backward()
    _grads_close(flow, ref_grads)
    # the sampling direction (a batch-norm flow inverts with running statistics)
    skey = jax.random.key(9)
    ref_x = jflow.apply(v, None, [jnp.asarray(c) for c in conds], jnp.asarray(base), skey,
                        temperature=0.7, method="sample")
    eps = U.flow_sample_noise(skey, cfg, 3, IMG, B)
    with torch.no_grad():
        got_x = flow.sample([torch.tensor(c) for c in conds], torch.tensor(base),
                            NoiseSource(replay=eps), temperature=0.7)
    _close(got_x, ref_x, rtol=0, atol=2e-5)


# --- RFN at the rfn_bair geometry and the batch-norm variant ------------------

T_LOSS, N_COND, N_PRED, BETA = 3, 2, 2, 0.5
MODELS = {
    # 3 channels, L=4: flow widths 12/24/48/96 (rfn_bair's), the chain on the
    # reverse and the fused step on the forward where their plans fit
    "rgb_L4": dict(glow=dict(chain_impl="sample", coupling_impl="fused")),
    "batchnorm_variant": dict(
        track_running_stats=True, glow=dict(
            flow_norm="batchnorm", base_norm="batchnorm", lu_decomposed=False)),
}


def rfn_config(name):
    """Tiny RFN of 3 channels, 32x32, L=4 (scales 16x16 .. 2x2)."""
    kw = {**MODELS[name]}
    return U.tiny_rfn_config(
        x_channels=3, image_size=32, L=4,
        extractor_structure=((4, "pool", 8), (8, "pool"), (8, "pool"), (8, "pool", 16)),
        upscaler_structure=((16,), ("upsample", 8), ("upsample", 8), ("upsample", 8)),
        glow={"chain_impl": "off", **kw.pop("glow")}, **kw)


_jax_results = {}


def _jax_rfn(name):
    if name not in _jax_results:
        cfg = rfn_config(name)
        jm, v = U.jax_rfn_variables(cfg, seed=1, batch=B)
        if "batch_stats" in v:  # init ran on zero frames: var = eps everywhere
            v["batch_stats"] = U.running_stats_like(v["batch_stats"], 5)
        x = np.random.default_rng(2).uniform(
            -0.5, 0.5, (B, T_LOSS, 32, 32, 3)).astype(np.float32)
        key = jax.random.key(3)

        def objective(params):
            out = jm.apply({**v, "params": params}, x, key, method="loss")
            return out["nll"] + BETA * out["kl_free_bits"], out

        (_, out), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
            v["params"])
        _jax_results[name] = (cfg, jm, v, x, key, {k: float(a) for k, a in out.items()},
                              grads)
    return _jax_results[name]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rfn_loss_matches_jax(name):
    cfg, _, v, x, key, ref, ref_grads = _jax_rfn(name)
    model = U.port_from(RFN(U.to_port(cfg)), v)
    before = {n: b.clone() for n, b in model.named_buffers()}
    noise = NoiseSource(replay=U.rfn_loss_noise(key, cfg, B, T_LOSS))
    out = model.loss(torch.tensor(x), noise)
    assert noise.exhausted()
    for k, r in ref.items():
        assert abs(out[k].item() - r) <= 1e-5 * (1 + abs(r)), (k, out[k].item(), r)
    (out["nll"] + BETA * out["kl_free_bits"]).backward()
    # the batch-norm flow's float32 gradients are held to JAX in float64 below
    if name != "batchnorm_variant":
        _grads_close(model, ref_grads)
    # the loss moves no running statistic, as the JAX apply cannot
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n


def test_batchnorm_variant_loss_gradients_match_jax_in_float64(monkeypatch):
    """The per-position batch norm of the flow normalises over B samples and
    so divides by small per-position deviations: in float32 its gradients
    are ill-conditioned at a few samples (scripts/torch_conditioning.py
    measures float32 against float64 gradients of the port's batch-norm
    variant: a median 8.5e-4 of the largest entry at B=2, 1.4e-4 at B=4),
    and the two frameworks' float32 sums differ by as much. So both sides
    run in float64 here (JAX under ``enable_x64``, its draws replayed in
    float64; the port on its plain versions, which take float64), at
    test_torch_loss.py's tolerances."""
    from recurrent_flows_tpu_torch.nn import convlstm
    from recurrent_flows_tpu_torch.ops import fused

    cfg, jm, v, x, key, _, _ = _jax_rfn("batchnorm_variant")
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)

        def objective(params):
            out = jm.apply({**v64, "params": params}, x.astype(np.float64), key,
                           method="loss")
            return out["nll"] + BETA * out["kl_free_bits"], out

        (_, ref), ref_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
            v64["params"])
        assert ref["nll"].dtype == jnp.float64
        draws = U.rfn_loss_noise(key, cfg, B, T_LOSS, dtype=jnp.float64)
    monkeypatch.setattr(convlstm, "convlstm_gates", fused.convlstm_gates_ref)
    monkeypatch.setattr(tmod, "coupling_transform", fused.coupling_transform_ref)
    model = U.port_from(RFN(U.to_port(cfg)), v).double()
    out = model.loss(torch.tensor(x, dtype=torch.float64), NoiseSource(replay=draws))
    for k, r in ref.items():
        assert abs(out[k].item() - float(r)) <= 1e-5 * (1 + abs(float(r))), k
    (out["nll"] + BETA * out["kl_free_bits"]).backward()
    ref_grads = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_grads)
    _grads_close(model, ref_grads, {n: p.grad.float() for n, p in model.named_parameters()
                                    if p.grad is not None})


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rfn_predict_matches_jax(name):
    cfg, jm, v, x, _, _, _ = _jax_rfn(name)
    model = U.port_from(RFN(U.to_port(cfg)), v)
    key = jax.random.key(6)
    _, ref = jax.jit(lambda v, x, k: jm.apply(
        v, x, N_PRED, N_COND, k, method="predict"))(v, x, key)
    noise = NoiseSource(replay=U.rfn_predict_noise(key, cfg, B, N_COND, N_PRED))
    _, got = model.predict(torch.tensor(x), N_PRED, N_COND, noise)
    assert noise.exhausted()
    got, ref = got.numpy(), np.asarray(ref)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    scale = 1 + np.abs(ref).max()
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=5e-6 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.5e-5 * scale)


def test_rgb_L4_model_has_the_rfn_bair_flow_widths():
    model = RFN(U.to_port(rfn_config("rgb_L4")), device="meta")
    assert [c for _, c, _ in model.flow.scale_shapes] == [12, 24, 48, 96]
    assert dataclasses.asdict(model.cfg.glow)["chain_impl"] == "sample"

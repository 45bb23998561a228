"""Running statistics against the JAX package, on the CPU: ``NormLayer``
with ``track_running_stats`` (an update as a mutable apply makes it, none in
init, normalising with the averages), ``RFN.stats_refresh`` against
``jm.apply(..., method='stats_refresh', mutable=['batch_stats'])``, the
statistics ``Trainer.build`` leaves (the JAX ``model.init`` pass, then the
data-dependent init), ``Trainer.refresh_stats`` against the JAX
``Trainer.refresh_stats``, a ``train_step`` that moves no buffer, and the
rollout with ``eval_norm``.

The model is the tiny batch-norm variant (``flow_norm='batchnorm'``,
``base_norm='batchnorm'``, ``lu_decomposed=False``,
``track_running_stats=True``, batch-norm features): 32x32 frames, L=2, K=2,
U=16, B=3, T=3.

Tolerances (float32): a running mean or variance is an average over the
batch, as a loss piece is, so within 1e-5·(1+|ref|) (test_torch_loss.py's
rule for its pieces); parameters after the data-dependent init within
rtol/atol 1e-4 as in test_torch_trainer.py; the rollout within atol 2e-5 on
the first predicted frame and 1e-4 on all, as in test_torch_rfn.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.models import RFN as JRFN
from recurrent_flows_tpu.nn.layers import NormLayer as JNormLayer
from recurrent_flows_tpu.training.trainer import Trainer as JTrainer
from recurrent_flows_tpu.training.trainer import preprocess as jpreprocess
from recurrent_flows_tpu_torch.convert import from_flax, tree_from_flax
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.nn.layers import NormLayer
from recurrent_flows_tpu_torch.serving import Predictor
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.utils import NoiseSource
from recurrent_flows_tpu_torch.utils.running_stats import (has_running_stats,
                                                           updating_running_stats)

IMG, B, T = 32, 3, 3


def _config(**glow):
    return U.tiny_rfn_config(
        image_size=IMG, L=2, K=2, track_running_stats=True,
        glow={"chain_impl": "off", "flow_norm": "batchnorm", "base_norm": "batchnorm",
              "lu_decomposed": False, **glow},
        extractor_structure=((4, "pool", 8), (8, "pool", 16)),
        upscaler_structure=((16,), ("upsample", 8)))


def _tcfg():
    return dataclasses.replace(U.tiny_train_config(), batch_size=B, n_frames=T)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (B, T, IMG, IMG, U.CIN)).astype(np.float32) for _ in range(n)]


def _stats_close(model, ref_tree, what=""):
    """Every running buffer of ``model`` against the flax batch_stats tree."""
    want = from_flax({}, None, _Buffers(model), ref_tree)
    assert set(want) == {n for n, _ in model.named_buffers()}
    for name, b in model.named_buffers():
        r = want[name].numpy()
        assert np.all(np.abs(b.numpy() - r) <= 1e-5 * (1 + np.abs(r))), (what, name)


class _Buffers(torch.nn.Module):
    """A module whose only state is ``model``'s buffers (to convert a
    batch_stats tree alone)."""

    def __init__(self, model):
        super().__init__()
        for name, b in model.named_buffers():
            *path, leaf = name.split(".")
            mod = self
            for p in path:
                if not hasattr(mod, p):
                    mod.add_module(p, torch.nn.Module())
                mod = getattr(mod, p)
            mod.register_buffer(leaf, b.clone())


def _fresh(tree):
    """A batch_stats tree as the port's modules start: means 0, variances 1."""
    return {k: _fresh(a) if isinstance(a, dict) else
            (np.zeros_like(a) if k == "running_mean" else np.ones_like(a))
            for k, a in tree.items()}


# --- NormLayer ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["refresh", "init", "running_average"])
def test_normlayer_running_stats_match_jax(mode):
    x = (np.random.default_rng(0).standard_normal((4, 5, 5, 6)) * 2 + 1).astype(np.float32)
    jm = JNormLayer("batchnorm", track_running_stats=True)
    v = jm.init(jax.random.key(0), x)
    for k, a in v["batch_stats"].items():  # flax init does not update them
        assert np.array_equal(np.asarray(a), _fresh(v["batch_stats"])[k]), k
    v = {"params": U.perturb(v["params"], 1),
         "batch_stats": {"running_mean": np.full(6, 0.3, np.float32),
                         "running_var": np.full(6, 1.7, np.float32)}}
    tm = NormLayer("batchnorm", 6, track_running_stats=True)
    tm.load_state_dict(from_flax(v["params"], None, tm, v["batch_stats"]))
    if mode == "running_average":
        ref = jm.apply(v, x, use_running_average=True)
        got = tm(torch.tensor(x), use_running_average=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        return
    if mode == "refresh":
        ref, mut = jm.apply(v, x, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        ctx = updating_running_stats()
    else:  # the initializing form moves nothing, as flax's init does not
        ref = jm.apply(v, x)
        stats = v["batch_stats"]
        ctx = updating_running_stats(initializing=True)
    with torch.no_grad(), ctx:
        got = tm(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for k in ("running_mean", "running_var"):
        r = np.asarray(stats[k])
        assert np.all(np.abs(getattr(tm, k).numpy() - r) <= 1e-5 * (1 + np.abs(r))), k
    # outside the context nothing moves
    before = tm.running_var.clone()
    tm(torch.tensor(x))
    assert torch.equal(tm.running_var, before)


# --- RFN.stats_refresh ------------------------------------------------------------


@pytest.fixture(scope="module")
def perturbed():
    cfg = _config()
    jm, v = U.jax_rfn_variables(cfg, seed=2, batch=B)
    return cfg, jm, v


def test_stats_refresh_matches_jax(perturbed):
    cfg, jm, v = perturbed
    x = np.random.default_rng(3).uniform(-0.5, 0.5, (B, T, IMG, IMG, 1)).astype(np.float32)
    key = jax.random.key(4)
    _, mut = jax.jit(lambda v: jm.apply(v, x, key, method="stats_refresh",
                                        mutable=["batch_stats"]))(v)
    model = U.port_from(RFN(U.to_port(cfg)), v)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    start = {n: b.clone() for n, b in model.named_buffers()}
    noise = NoiseSource(replay=U.rfn_ddi_noise(key, cfg, B))
    model.stats_refresh(torch.tensor(x), noise)
    assert noise.exhausted()
    _stats_close(model, mut["batch_stats"], "stats_refresh")
    for n, p in model.named_parameters():  # the refresh leaves the ActNorms alone
        assert torch.equal(p.detach(), params[n]), n
    # the flow's and the feature nets' statistics both moved
    moved = [n for n, b in model.named_buffers() if not torch.equal(b, start[n])]
    assert any(n.startswith("flow.") for n in moved)
    assert any(n.startswith("extractor.") for n in moved)


# --- Trainer.build and Trainer.refresh_stats ------------------------------------


def test_build_refresh_and_train_step_running_stats_match_jax(tmp_path):
    cfg, tcfg, batches = _config(), _tcfg(), _batches(3, seed=5)
    jm = JRFN(cfg, remat=False)
    object.__setattr__(jm, "init", jax.jit(jm.init))  # build() inits eagerly
    jt = JTrainer(jm, tcfg, batches, str(tmp_path))
    root = jax.random.key(0)
    jt.build(root, run_ddi=True)
    # the init the JAX build makes, to load the port from the same weights
    k_init, k_ddi, _, _ = jax.random.split(root, 4)
    x = jpreprocess(jnp.asarray(batches[0]), tcfg.n_bits, tcfg.preprocess_range,
                    tcfg.preprocess_scale)
    v0 = jm.init(k_init, x, jax.random.key(1))
    model = RFN(U.to_port(cfg))
    model.load_state_dict(from_flax(v0["params"], None, model, _fresh(v0["batch_stats"])))
    init_u = U._uniform(jax.random.key(1), (B, IMG, IMG, 1), cfg.glow.n_bits)
    noise = NoiseSource(replay=[init_u] + U.rfn_ddi_noise(k_ddi, cfg, B))
    trainer = Trainer(model, U.to_port(tcfg), batches, device="cpu").build(noise=noise)
    assert noise.exhausted()
    # after build: the init pass's statistics (BatchNormFlow) and 0/1 (NormLayer)
    _stats_close(model, jt.state.stats["batch_stats"], "build")
    assert all(torch.equal(b, torch.ones_like(b)) for n, b in model.named_buffers()
               if n.startswith("extractor.") and n.endswith("running_var"))
    want = tree_from_flax(jt.state.params, model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # refresh_stats: the next batch, the JAX trainer's next key
    k_refresh = jax.random.split(jt._rng, 3)[2]
    jt.refresh_stats()
    trainer.refresh_stats(noise=NoiseSource(replay=U.rfn_ddi_noise(k_refresh, cfg, B)))
    _stats_close(model, jt.state.stats["batch_stats"], "refresh_stats")
    # a train step moves no running buffer; Adam holds the parameters only
    before = {n: b.clone() for n, b in model.named_buffers()}
    held = [p for g in trainer.optimizer.param_groups for p in g["params"]]
    assert len(held) == len(list(model.parameters()))
    assert not {id(b) for b in model.buffers()} & {id(p) for p in held}
    metrics = trainer.train_step(batches[2], beta=0.5, lr=1e-3)
    assert all(np.isfinite(float(m)) for m in metrics.values())
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n


def test_refresh_stats_is_a_no_op_without_running_stats():
    cfg = U.tiny_rfn_config(image_size=IMG, L=2, K=2, glow={"chain_impl": "off"},
                            extractor_structure=((4, "pool", 8), (8, "pool", 16)),
                            upscaler_structure=((16,), ("upsample", 8)))
    model = RFN(U.to_port(cfg))
    assert not has_running_stats(model)
    trainer = Trainer(model, U.to_port(_tcfg()), _batches(1), device="cpu")
    trainer.refresh_stats(noise=NoiseSource(replay=[]))  # draws nothing, reads no batch
    assert trainer._aux_iter is None


# --- the rollout with eval_norm -----------------------------------------------------


@pytest.mark.parametrize("eval_norm", [True, False])
def test_predict_with_eval_norm_matches_jax(perturbed, eval_norm):
    cfg, _, v = perturbed
    v = {**v, "batch_stats": U.running_stats_like(v["batch_stats"], 6)}
    jm = JRFN(cfg, remat=False, eval_norm=eval_norm)
    x = np.random.default_rng(7).uniform(-0.5, 0.5, (B, 3, IMG, IMG, 1)).astype(np.float32)
    key = jax.random.key(8)
    _, ref = jax.jit(lambda v, x, k: jm.apply(v, x, 2, 3, k, method="predict"))(v, x, key)
    model = U.port_from(RFN(U.to_port(cfg), eval_norm=eval_norm), v)
    assert model._ura == eval_norm
    pred = Predictor(model, U.to_port(_tcfg()), n_conditions=3, n_predictions=2,
                     device="cpu")
    assert pred.model is model  # the Predictor serves the model as it is configured
    noise = NoiseSource(replay=U.rfn_predict_noise(key, cfg, B, 3, 2))
    _, got = model.predict(torch.tensor(x), 2, 3, noise)
    assert noise.exhausted()
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)

"""The port's ``GlowImage`` and ``ConditionalGlowImage`` (cGlow) against
``recurrent_flows_tpu.models.glow_image`` on the CPU.

Same weights (a JAX init, perturbed off its zero inits, converted by
``convert.from_flax``, which needs no code for the new names ``cond_{l}``,
``base``, ``enc{l}``, ``encn{l}``) and JAX's draws replayed. Sizes: 16x16
(gray for GlowImage, RGB for cGlow), L=2, K=2, U=8, B=2 (GlowImage on
video batches of T=3, taken as 6 frames); ``chain_impl='sample'``, so the
reverse scales run through ``glowchain`` (its plain version on the CPU).

Tolerances: NLLs and logdets 1e-4·(1+|ref|); samples elementwise
1e-5·(1+|ref|); gradients and the data-dependent init's parameters 1e-4
of each tensor's largest |entry|; a resumed step's mean nll 1e-6·|ref| (at
1e-4·(1+|ref|) it would not tell one dequantization draw from another).
Then a ``Trainer`` builds (DDI) and steps
a GlowImage, writes the JAX meta (``model_class`` "GlowImage",
``model_config`` the ``GlowConfig``) and plots ``losses.png`` alone, as the
JAX ``plotter`` does for a model with no ``predict``; and a JAX trainer's
checkpoint of a GlowImage, exported to npz, loads into the port and its
next step matches.
"""

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.config import GlowConfig, TrainConfig
from recurrent_flows_tpu.data import get_joint_conditioned_data
from recurrent_flows_tpu.flows.ddi import data_dependent_init as jax_ddi
from recurrent_flows_tpu.models import glow_image as jgi
from recurrent_flows_tpu.training import Trainer as JTrainer
from recurrent_flows_tpu_torch import config as port_config
from recurrent_flows_tpu_torch.convert import from_flax
from recurrent_flows_tpu_torch.flows import data_dependent_init
from recurrent_flows_tpu_torch.models import ConditionalGlowImage, GlowImage
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.training.checkpoint import load_state
from recurrent_flows_tpu_torch.utils import NoiseSource

IMG, B, T = 16, 2, 3
CFG = GlowConfig(L=2, K=2, n_units_affine=8, n_units_prior=8, chain_impl="sample")
TOL_NLL, TOL_OUT, TOL_GRAD = 1e-4, 1e-5, 1e-4
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "jax_checkpoint_to_npz.py"


def _frames(shape, seed=0):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_init(cglow: str | None, cfg=CFG, seed=0):
    """(JAX model, perturbed variables): GlowImage, or cGlow with the norm
    ``cglow``; each init once per module."""
    if cglow is None:
        jm = jgi.GlowImage(1, IMG, cfg, cond_channels=4, base_channels=4)
        args = (jnp.zeros((B, IMG, IMG, 1)),)
    else:
        jm = jgi.ConditionalGlowImage(3, IMG, cfg, cond_channels=8, norm_type=cglow)
        args = (jnp.zeros((B, IMG, IMG, 3)),) * 2
    v = jax.jit(jm.init)(jax.random.key(seed), *args, jax.random.key(seed + 1))
    return jm, {"params": U.perturb(v["params"], seed), "consts": v["consts"]}


def _glow_pair(cfg=CFG, seed=0):
    jm, v = _jax_init(None, cfg, seed)
    pm = GlowImage(1, IMG, U.to_port(cfg), cond_channels=4, base_channels=4, device="cpu")
    return jm, v, U.port_from(pm, v)


def _cglow_pair(norm_type):
    jm, v = _jax_init(norm_type)
    pm = ConditionalGlowImage(3, IMG, U.to_port(CFG), cond_channels=8, norm_type=norm_type,
                              device="cpu")
    return jm, v, U.port_from(pm, v)


def test_converted_weights_need_no_new_code():
    _, v, pm = _glow_pair()
    names = set(from_flax(v["params"], v["consts"], pm))
    assert {"cond_0", "cond_1", "base"} <= names
    assert pm.cond_1.shape == (1, 4, 4, 4) and pm.base.shape == (1, 4, 4, 4)
    _, v, cm = _cglow_pair("batchnorm")
    names = set(from_flax(v["params"], v["consts"], cm))
    assert {"enc0.kernel", "enc0.bias", "enc1.kernel", "encn0.scale", "encn1.bias"} <= names
    assert cm.enc0.kernel.shape == (8, 3, 3, 3) and cm.enc0.stride == 2


def test_glow_image_loss_gradients_and_sample_match_jax():
    jm, v, pm = _glow_pair()
    x = _frames((B, T, IMG, IMG, 1))
    key = jax.random.key(3)

    def objective(params):
        out = jm.apply({**v, "params": params}, x, key, method="loss")
        return out["nll"], out
    (_, ref), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(v["params"])
    noise = NoiseSource(replay=[U._uniform(key, (B * T, IMG, IMG, 1), CFG.n_bits)])
    out = pm.loss(torch.tensor(x), noise)
    assert noise.exhausted() and set(out) == {"kl_free_bits", "kl", "nll"}
    U.assert_close_rel(out["nll"].detach(), ref["nll"], TOL_NLL, "nll")
    assert float(out["kl"]) == 0.0 == float(ref["kl"])
    out["nll"].backward()
    U.assert_grads_close(pm, grads, TOL_GRAD)
    assert pm.cond_0.grad.abs().sum() > 0  # the constant conditions learn

    key = jax.random.key(4)
    ref = jax.jit(lambda v, k: jm.apply(v, 3, k, method="sample"))(v, key)
    noise = NoiseSource(replay=U.flow_sample_noise(key, CFG, 1, IMG, 3))
    with torch.no_grad():
        got = pm.sample(3, noise)
    assert noise.exhausted()
    U.assert_close_rel(got, ref, TOL_OUT, "sample")


def test_glow_image_ddi_matches_jax():
    jm, v, pm = _glow_pair()  # the pass takes the module path whatever chain_impl says
    x = _frames((B, T, IMG, IMG, 1), seed=1)
    key = jax.random.key(5)
    v2 = jax_ddi(v, jax.jit(lambda vv: jm.apply(vv, jnp.asarray(x), key, method="ddi",
                                                mutable=["ddi"])))
    noise = NoiseSource(replay=[U._uniform(key, (B * T, IMG, IMG, 1), CFG.n_bits)])
    data_dependent_init(pm, torch.tensor(x), noise)
    want = from_flax(v2["params"], v2["consts"], pm)
    for name, p in pm.state_dict().items():
        r = want[name].numpy()
        assert np.abs(p.numpy() - r).max() <= TOL_GRAD * max(np.abs(r).max(), 1e-6), name


def test_cglow_log_prob_gradients_and_sample_match_jax():
    jm, v, pm = _cglow_pair("batchnorm")  # the encoder's norms carry parameters
    imgs = _frames((B, IMG, IMG, 3), seed=2) + 0.5
    ctx, _ = get_joint_conditioned_data(imgs, box=8)
    x, ctx = imgs - 0.5, ctx - 0.5
    key = jax.random.key(6)
    (_, ref), grads = jax.jit(jax.value_and_grad(lambda p: (lambda n: (jnp.mean(n), n))(
        jm.apply({**v, "params": p}, x, ctx, key, method="log_prob")), has_aux=True))(
        v["params"])
    noise = NoiseSource(replay=[U._uniform(key, x.shape, CFG.n_bits)])
    got = pm.log_prob(torch.tensor(x), torch.tensor(ctx), noise)
    U.assert_close_rel(got.detach(), ref, TOL_NLL, "log_prob")
    got.mean().backward()
    U.assert_grads_close(pm, grads, TOL_GRAD)

    key = jax.random.key(7)
    ref = jax.jit(lambda v, c, k: jm.apply(v, c, k, method="sample", temperature=0.7))(
        v, ctx, key)
    noise = NoiseSource(replay=U.flow_sample_noise(key, CFG, 3, IMG, B))
    with torch.no_grad():
        got = pm.sample(torch.tensor(ctx), noise, temperature=0.7)
    assert noise.exhausted()
    U.assert_close_rel(got, ref, TOL_OUT, "sample")


def _export_module():
    spec = importlib.util.spec_from_file_location("jax_checkpoint_to_npz", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trainer_step_checkpoint_meta_plots_and_a_jax_checkpoint(tmp_path):
    cfg = dataclasses.replace(CFG, chain_impl="off")
    tcfg = TrainConfig(batch_size=B, n_frames=T, learning_rate=1e-3)
    batches = [_frames((B, T, IMG, IMG, 1), seed=s) + 0.5 for s in range(2)]
    # the JAX trainer: build (DDI), one step, checkpoint; exported to npz
    jm = jgi.GlowImage(1, IMG, cfg, cond_channels=4, base_channels=4)
    jt = JTrainer(jm, tcfg, batches, str(tmp_path / "jax")).build(jax.random.key(0))
    jt.state, _ = jt._train_step(jt.state, jnp.asarray(batches[0]), 1.0, 1e-3,
                                 jax.random.key(1))
    jt.counter = 1
    jt.checkpoint("last")
    jax_dir = tmp_path / "jax" / "model_folder" / "last"
    port_dir = tmp_path / "port" / "model_folder" / "last"
    _export_module().main([str(jax_dir), "--out", str(port_dir)])

    # the port's trainer: build with DDI, a step, its checkpoint's meta, the plots
    pcfg = U.to_port(cfg)
    model = GlowImage(1, IMG, pcfg, cond_channels=4, base_channels=4, device="cpu")
    pt = Trainer(model, U.to_port(tcfg), batches, str(tmp_path / "port"), device="cpu")
    before = model.flow.step(0, 0).norm.logs.detach().clone()
    pt.build()
    assert not torch.equal(before, model.flow.step(0, 0).norm.logs)  # DDI moved it
    metrics = pt.train_step(batches[1], 1.0, 1e-3)
    assert np.isfinite(float(metrics["bits"])) and float(metrics["kl"]) == 0.0
    pt.losses.append(float(metrics["loss"]))
    pt.checkpoint("mine")
    mine = json.loads((tmp_path / "port" / "model_folder" / "mine" / "meta.json").read_text())
    theirs = json.loads((jax_dir / "meta.json").read_text())
    assert mine.keys() == theirs.keys()
    assert mine["model_class"] == theirs["model_class"] == "GlowImage"
    assert mine["model_config"] == theirs["model_config"] == dataclasses.asdict(cfg)
    assert port_config.config_from_dict(port_config.GlowConfig, mine["model_config"]) == pcfg
    pt.plotter()
    assert sorted(p.name for p in (tmp_path / "port" / "png_folder").iterdir()) == ["losses.png"]
    assert pt.plot_counter == 0

    # the JAX checkpoint in the port: parameters, Adam's state, the next step
    other = GlowImage(1, IMG, pcfg, cond_channels=4, base_channels=4, device="cpu")
    resumed = Trainer(other, U.to_port(tcfg), batches, str(tmp_path / "port"),
                      device="cpu").load("last")
    assert resumed.counter == 1
    params = jax.tree.map(np.asarray, jt.state.params)
    for name, t in from_flax(params, jt.state.consts, other).items():
        assert torch.equal(other.state_dict()[name], t), name
    key = jax.random.key(2)
    jt.state, ref = jt._train_step(jt.state, jnp.asarray(batches[1]), 1.0, 1e-3, key)
    got = resumed.train_step(batches[1], 1.0, 1e-3, noise=NoiseSource(
        replay=[U._uniform(key, (B * T, IMG, IMG, 1), CFG.n_bits)]))
    # a mean over whole frames: 1e-4·(1+|ref|) would not tell one
    # dequantization draw from another, so this one sum is held to 1e-6·|ref|
    assert abs(float(got["nll"]) - float(ref["nll"])) <= 1e-6 * abs(float(ref["nll"]))
    step = load_state(str(port_dir), GlowImage(1, IMG, pcfg, cond_channels=4,
                                               base_channels=4, device="cpu"))
    assert step == 1


def test_validate_training_script_runs_glow(tmp_path):
    """``scripts/torch_validate_training.py``: the JAX script's options plus
    ``--device``; ``--model glow`` (L=3, K=8, 128 units) trains the port's
    GlowImage and writes the JAX script's ``verdict.json`` keys."""
    spec = importlib.util.spec_from_file_location(
        "torch_validate_training", SCRIPT.parent / "torch_validate_training.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = mod.build_parser().parse_args([
        "--model", "glow", "--image_size", "16", "--steps", "2", "--batch_size", "2",
        "--n_frames", "2", "--out", str(tmp_path), "--device", "cpu"])
    assert mod.build_parser().parse_args([]).device == "cuda"
    verdict = mod.run_one("glow", args)
    written = json.loads((tmp_path / "glow" / "verdict.json").read_text())
    assert written == verdict and set(written) == {
        "model", "steps", "metric", "first20", "last20", "improved", "wall_s",
        "wall_steps_per_s"}
    assert np.isfinite(written["last20"]) and written["metric"] == "bits_per_dim"
    assert sorted(p.name for p in (tmp_path / "glow" / "png_folder").iterdir()) == ["losses.png"]

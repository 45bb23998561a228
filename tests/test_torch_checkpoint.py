"""Checkpoints of the port: its own round trip (``Trainer.checkpoint`` ->
``Trainer.load``, bit for bit), and a JAX ``Trainer`` checkpoint (orbax)
exported by ``scripts/jax_checkpoint_to_npz.py`` and read by the port,
with ``grad_clip`` off and on (optax's chain puts Adam's state at another
place): ``Predictor.from_checkpoint`` must roll out as the JAX
``Predictor.from_checkpoint`` does on replayed noise (atol 1e-4, as
``test_torch_rfn.py`` holds the rollout), a ``Trainer`` resumed from it must
take the JAX trainer's next step (as ``test_torch_trainer.py`` holds its
mid-training step), and the port's ``meta.json`` must have the JAX keys.

Size: 32x32 frames, L=2, K=2, U=16, B=2, T=3 (``test_torch_trainer.py``'s),
``chain_impl='sample'`` so that the rollout takes the chain.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.models import RFN as JRFN
from recurrent_flows_tpu.serving import Predictor as JPredictor
from recurrent_flows_tpu.training.trainer import Trainer as JTrainer
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.serving import Predictor
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.training.checkpoint import load_model_from_checkpoint
from recurrent_flows_tpu_torch.utils import NoiseSource
from test_torch_trainer import BETA, LR, _adam_state, _check_adam_and_params, _check_metrics

IMG, B, T = 32, 2, 3
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "jax_checkpoint_to_npz.py"


def _config():
    return U.tiny_rfn_config(
        image_size=IMG, L=2, K=2, glow={"chain_impl": "sample"},
        extractor_structure=((4, "pool", 8), (8, "pool", 16)),
        upscaler_structure=((16,), ("upsample", 8)))


def _tcfg(**kw):
    return dataclasses.replace(U.tiny_train_config(), batch_size=B, n_frames=T,
                               learning_rate=LR, **kw)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (B, T, IMG, IMG, U.CIN)).astype(np.float32)
            for _ in range(n)]


def _export_module():
    spec = importlib.util.spec_from_file_location("jax_checkpoint_to_npz", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_checkpoint_round_trips_bit_exactly(tmp_path):
    cfg, tcfg = U.to_port(_config()), U.to_port(_tcfg())
    batches = _batches(3)
    trainer = Trainer(RFN(cfg), tcfg, batches, str(tmp_path), device="cpu").build()
    trainer.train_epoch(steps=2)
    trainer.epoch_i, trainer.best_loss, trainer.plot_counter = 4, 123.5, 2
    trainer.plateau.lr = 7e-4
    trainer.checkpoint("last")
    folder = tmp_path / "model_folder" / "last"
    assert sorted(p.name for p in folder.iterdir()) == ["meta.json", "state.pt"]
    other = Trainer(RFN(cfg, generator=torch.Generator().manual_seed(9)), tcfg, batches,
                    str(tmp_path), device="cpu").load("last")
    a, b = trainer.model.state_dict(), other.model.state_dict()
    assert a.keys() == b.keys() and any(n.endswith("sign_s") for n in a)  # buffers too
    for n in a:
        assert torch.equal(a[n], b[n]), n
    sa, sb = trainer.optimizer.state_dict(), other.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    for attr in ("counter", "epoch_i", "plot_counter", "best_loss", "losses", "kl_hist",
                 "recon_hist", "bits_hist"):
        assert getattr(other, attr) == getattr(trainer, attr), attr
    assert other.counter == 2 and len(other.losses) == 2 and other.plateau.lr == 7e-4
    # the resumed trainer takes the same next step
    key = jax.random.key(3)
    steps = [t.train_step(batches[2], BETA, LR, noise=NoiseSource(
        replay=U.rfn_loss_noise(key, _config(), B, T))) for t in (trainer, other)]
    assert all(torch.equal(steps[0][k], steps[1][k]) for k in steps[0])


@pytest.mark.parametrize("grad_clip", [0.0, 100.0])
def test_jax_checkpoint_served_and_resumed_by_the_port(tmp_path, grad_clip):
    cfg, tcfg = _config(), _tcfg(grad_clip=grad_clip)
    batches = _batches(2, seed=grad_clip > 0)
    jm = JRFN(cfg, remat=False)
    object.__setattr__(jm, "init", jax.jit(jm.init))
    jt = JTrainer(jm, tcfg, batches, str(tmp_path / "jax"))
    jt.build(jax.random.key(0), run_ddi=False)
    params = U.perturb(jt.state.params, 0)
    jt.state = jt.state.replace(params=params, opt_state=jt.optimizer.init(params))
    jt.state, _ = jt._train_step(jt.state, jnp.asarray(batches[0]), BETA, LR,
                                 jax.random.key(1))
    jt.counter = 1
    jt.checkpoint("last")
    jax_dir = tmp_path / "jax" / "model_folder" / "last"
    port_dir = tmp_path / "port" / "model_folder" / "last"
    _export_module().main([str(jax_dir), "--out", str(port_dir)])
    assert sorted(p.name for p in port_dir.iterdir()) == ["meta.json", "state.npz"]

    # serving: the JAX Predictor over the orbax checkpoint, the port's over the npz
    ctx = np.random.default_rng(2).uniform(0, 1, (B, 3, IMG, IMG, U.CIN)).astype(np.float32)
    ref = JPredictor.from_checkpoint(str(jax_dir), n_conditions=2, n_predictions=2).predict(ctx)
    _, k = jax.random.split(jax.random.key(0))  # the key of its first request
    pred = Predictor.from_checkpoint(str(port_dir), device="cpu", n_conditions=2,
                                     n_predictions=2)
    assert pred.device.type == "cpu" and not pred.model.eval_norm
    got = pred.predict(ctx, noise=NoiseSource(replay=U.rfn_predict_noise(k, cfg, B, 2, 2)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-4)

    # resuming: the port's next step against the JAX trainer's
    model, ptcfg, meta = load_model_from_checkpoint(str(port_dir), device="cpu")
    assert ptcfg == U.to_port(tcfg) and meta["counter"] == 1
    pt = Trainer(model, ptcfg, batches, str(tmp_path / "port"), device="cpu").load("last")
    assert pt.counter == 1 and int(pt.optimizer.state[next(model.parameters())]["step"]) == 1
    start = jax.tree.map(np.asarray, jt.state.params)  # the step donates its state
    key = jax.random.key(4)
    jt.state, ref = jt._train_step(jt.state, jnp.asarray(batches[1]), BETA, LR, key)
    _check_metrics(pt.train_step(batches[1], BETA, LR, noise=NoiseSource(
        replay=U.rfn_loss_noise(key, cfg, B, T))), ref)
    assert int(_adam_state(jt.state.opt_state).count) == 2
    _check_adam_and_params(pt, jt.state, start)

    # the port's own checkpoint carries the JAX meta's keys
    pt.checkpoint("resumed")
    with open(jax_dir / "meta.json") as f:
        jax_meta = json.load(f)
    with open(tmp_path / "port" / "model_folder" / "resumed" / "meta.json") as f:
        port_meta = json.load(f)
    assert port_meta.keys() == jax_meta.keys()
    assert port_meta["model_config"] == jax_meta["model_config"]
    assert port_meta["train_config"] == jax_meta["train_config"]


def test_checkpoint_of_another_model_family_raises(tmp_path):
    # SRNN, VRNN and SVG are served (test_torch_family_lifecycle.py); a
    # GlowImage is not, as in the JAX registry (its meta lacks the
    # constructor's arguments; test_torch_glow_image.py loads one by hand)
    (tmp_path / "meta.json").write_text(json.dumps({"model_class": "GlowImage"}))
    with pytest.raises(ValueError, match="load_state"):
        Predictor.from_checkpoint(str(tmp_path), device="cpu")

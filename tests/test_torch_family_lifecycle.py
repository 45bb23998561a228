"""SRNN, VRNN and SVG through the port's ``Trainer`` and ``Predictor``:
``build`` (no data-dependent init), ``fit`` with its ``last`` checkpoint
(running statistics refreshed first), ``plot_rows`` without the flow's
bijection row, ``load`` bit for bit, ``Predictor.from_checkpoint`` (with
``eval_norm`` where the model tracks running statistics) serving as the
model it was saved from, its ``temperature`` ignored as the JAX package
ignores it for these families; and a JAX ``Trainer`` checkpoint of SRNN
exported by ``scripts/jax_checkpoint_to_npz.py``, which the port serves
as the JAX ``Predictor`` does (atol 1e-5 on frames in [0, 1]) and resumes
into the JAX trainer's next step (``test_torch_trainer.py``'s limits).

Size: ``torch_family_utils``' (B=2, T=4, 16x16).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_utils as F
from torch_family_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
import torch_parity_utils as U
from recurrent_flows_tpu.config import TrainConfig
from recurrent_flows_tpu.serving import Predictor as JPredictor
from recurrent_flows_tpu.training.trainer import Trainer as JTrainer
from recurrent_flows_tpu_torch import models
from recurrent_flows_tpu_torch.serving import Predictor
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.training.checkpoint import load_model_from_checkpoint
from recurrent_flows_tpu_torch.utils import NoiseSource
from test_torch_trainer import BETA, LR, _adam_state, _check_adam_and_params, _check_metrics

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "jax_checkpoint_to_npz.py"
PREPROCESS = {"SRNN": "1.0", "VRNN": "1.0", "SVG": "none"}  # the presets'


def _tcfg(family, **kw):
    return TrainConfig(batch_size=F.B, n_frames=F.T, preprocess_range=PREPROCESS[family],
                       learning_rate=LR, steps_per_epoch=2, n_conditions=2,
                       n_predictions=2, **kw)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (F.B, F.T, F.IMG, F.IMG, 1)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("family", ["SRNN", "VRNN", "SVG"])
def test_fit_checkpoint_load_and_serve(family, tmp_path):
    cfg = U.to_port(F.config(family, track_running_stats=True))
    tcfg = U.to_port(_tcfg(family))
    cls = getattr(models, family)
    batches = _batches(3)
    trainer = Trainer(cls(cfg), tcfg, batches, str(tmp_path), device="cpu").build()
    assert trainer.optimizer is not None and trainer._aux_iter is None  # no init batch
    trainer.fit(n_epochs=1, plot=False)
    assert len(trainer.losses) == 2 and np.isfinite(trainer.losses).all()
    folder = tmp_path / "model_folder" / "last"
    assert sorted(p.name for p in folder.iterdir()) == ["meta.json", "state.pt"]
    moved = [n for n, b in trainer.model.named_buffers()
             if not torch.equal(b, torch.zeros_like(b) if "mean" in n else torch.ones_like(b))]
    assert moved and len(moved) == len(list(trainer.model.named_buffers()))

    other = Trainer(cls(cfg, generator=torch.Generator().manual_seed(5)), tcfg, batches,
                    str(tmp_path), device="cpu").load("last")
    a, b = trainer.model.state_dict(), other.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)
    sa, sb = trainer.optimizer.state_dict()["state"], other.optimizer.state_dict()["state"]
    assert sa and all(torch.equal(v, sb[i][k]) for i, st in sa.items() for k, v in st.items())
    assert other.counter == trainer.counter == 2

    # the plots refresh the running statistics: after the checkpoint checks
    rows = trainer.plot_rows(noise=NoiseSource(generator=torch.Generator().manual_seed(1)))
    assert [n for n, _ in rows] == ["true", "sample|frame0", "prediction", "recon"]
    shapes = {"true": F.T, "sample|frame0": F.T, "prediction": 4, "recon": F.T - 1}
    # bytes, but for 'none' (SVG), whose reverse preprocess passes the frames
    # through, as the JAX package's does
    dtype = np.float32 if tcfg.preprocess_range == "none" else np.uint8
    for name, arr in rows:
        assert arr.dtype == dtype and arr.shape == (shapes[name], F.B, F.IMG, F.IMG, 1)

    pred = Predictor.from_checkpoint(str(folder), device="cpu", n_conditions=2,
                                     n_predictions=2, temperature=0.3)
    assert type(pred.model) is cls and pred.model.eval_norm
    served = models.__dict__[family](cfg, eval_norm=True)
    served.load_state_dict(other.model.state_dict())  # the checkpoint's state
    direct = Predictor(served, tcfg, n_conditions=2, n_predictions=2, device="cpu")
    ctx = batches[0]
    for endpoint, args in (("predict", (ctx,)), ("reconstruct", (ctx,)),
                           ("sample", (ctx[:, 0], 3))):
        outs = [getattr(p, endpoint)(*args, noise=NoiseSource(
            generator=torch.Generator().manual_seed(2))) for p in (pred, direct)]
        assert np.array_equal(outs[0], outs[1]), endpoint
        assert outs[0].min() >= 0 and outs[0].max() <= 1
    assert outs[0].shape == (F.B, 3, F.IMG, F.IMG, 1)


def _export(jax_dir, port_dir):
    spec = importlib.util.spec_from_file_location("jax_checkpoint_to_npz", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main([str(jax_dir), "--out", str(port_dir)])


def test_jax_srnn_checkpoint_served_and_resumed_by_the_port(tmp_path):
    cfg = F.config("SRNN", norm_type="none", res_q=True)
    tcfg = _tcfg("SRNN")
    batches = _batches(2, seed=1)
    jm = F.JAX_MODELS["SRNN"](cfg, remat=False)
    object.__setattr__(jm, "init", jax.jit(jm.init))
    jt = JTrainer(jm, tcfg, batches, str(tmp_path / "jax"))
    jt.build(jax.random.key(0), run_ddi=False)
    params = U.perturb(jt.state.params, 0, 0.01)
    jt.state = jt.state.replace(params=params, opt_state=jt.optimizer.init(params))
    jt.state, _ = jt._train_step(jt.state, jnp.asarray(batches[0]), BETA, LR,
                                 jax.random.key(1))
    jt.counter = 1
    jt.checkpoint("last")
    jax_dir = tmp_path / "jax" / "model_folder" / "last"
    port_dir = tmp_path / "port" / "model_folder" / "last"
    _export(jax_dir, port_dir)

    ctx = np.random.default_rng(2).uniform(0, 1, (F.B, 3, F.IMG, F.IMG, 1)).astype(np.float32)
    ref = JPredictor.from_checkpoint(str(jax_dir), n_conditions=2, n_predictions=3).predict(ctx)
    _, k = jax.random.split(jax.random.key(0))  # the key of its first request
    pred = Predictor.from_checkpoint(str(port_dir), device="cpu", n_conditions=2,
                                     n_predictions=3)
    assert type(pred.model) is models.SRNN and not pred.model.eval_norm
    got = pred.predict(ctx, noise=NoiseSource(replay=F.predict_noise(k, cfg, 2, 3)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)

    model, ptcfg, meta = load_model_from_checkpoint(str(port_dir), device="cpu")
    assert ptcfg == U.to_port(tcfg) and meta["model_class"] == "SRNN"
    pt = Trainer(model, ptcfg, batches, str(tmp_path / "port"), device="cpu").load("last")
    start = jax.tree.map(np.asarray, jt.state.params)  # the step donates its state
    key = jax.random.key(4)
    jt.state, ref = jt._train_step(jt.state, jnp.asarray(batches[1]), BETA, LR, key)
    _check_metrics(pt.train_step(batches[1], BETA, LR,
                                 noise=NoiseSource(replay=F.loss_noise(key, cfg))), ref)
    assert int(_adam_state(jt.state.opt_state).count) == 2
    _check_adam_and_params(pt, jt.state, start)


def test_trainer_preprocesses_each_preset_as_the_jax_package():
    from recurrent_flows_tpu.training.trainer import preprocess as jpre

    from recurrent_flows_tpu_torch.config import srnn_mnist, svg_mnist, vrnn_mnist
    from recurrent_flows_tpu_torch.training import bits_per_dim

    x = np.random.default_rng(3).uniform(0, 1, (2, 3, 8, 8, 1)).astype(np.float32)
    for preset in (srnn_mnist, vrnn_mnist, svg_mnist):
        mcfg, tcfg = preset()
        trainer = Trainer(torch.nn.Linear(1, 1), dataclasses.replace(tcfg), [x],
                          device="cpu")
        trainer.model.cfg = mcfg
        got = trainer._to_model_space(x).numpy()
        want = np.asarray(jpre(jnp.asarray(x), tcfg.n_bits, tcfg.preprocess_range,
                               tcfg.preprocess_scale))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert abs(float(bits_per_dim(torch.tensor(2.0), torch.tensor(3.0), 64 * 64, 9))
               - 5.0 / (np.log(2.0) * 64 * 64 * 9)) < 1e-6 * 5.0 / (np.log(2.0) * 64 * 64 * 9)

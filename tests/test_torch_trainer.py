"""The port's ``Trainer`` against the JAX package's: three ``train_step``s on
converted weights and replayed noise under the three configurations of the
training step (A module path, B ``coupling_impl='fused'``, C
``chain_impl='all'``), a step taken from a mid-training Adam state
(``convert.adam_from_optax``), ``build`` with the data-dependent init, the
global-norm clip and the schedules.

Size: 32x32 frames, L=2, K=2, U=16, B=2, T=3; lr 1e-3 so that three steps
move the weights; gradients clipped at a global norm of 100 (the clip is
active). The JAX side runs its Pallas kernels interpreted on the CPU.

Tolerances and the rule for Adam. Metrics of each step within
1e-4·(1+|ref|) (from the second step on they include the first update).
Adam's first moment is linear in the gradients, so ``exp_avg`` is held to
optax's ``mu`` like a gradient: rtol 1e-3, atol 1e-3 of the tensor's largest
entry (never below 1e-5 of the model's largest). The update itself,
lr·m/(sqrt(v)+eps), is lr·sign(g) in the first step of a run: where a
gradient is float noise around zero, a 1e-7 difference flips a whole lr
step, and the flip stays in the weights. So parameters are compared after
the one step taken from the mid-training state, where both sides start from
the same moments and the update is smooth in the gradient, and only at
entries whose first moment is at least 1% of its tensor's largest (and that
tensor's above the floor): there the movement must agree within 2% of lr.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.flows.ddi import data_dependent_init as jax_ddi
from recurrent_flows_tpu.models import RFN as JRFN
from recurrent_flows_tpu.training import schedules as jsched
from recurrent_flows_tpu.training.trainer import Trainer as JTrainer
from recurrent_flows_tpu.training.trainer import preprocess as jpreprocess
from recurrent_flows_tpu_torch.convert import adam_from_optax, tree_from_flax
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.serving import Predictor
from recurrent_flows_tpu_torch.training import (BetaSchedule, EarlyStopping,
                                                PlateauScheduler, Trainer,
                                                bits_per_dim, clip_by_global_norm_,
                                                linear_lr)
from recurrent_flows_tpu_torch.utils import NoiseSource

IMG, B, T, LR, BETA, N_STEPS = 32, 2, 3, 1e-3, 0.3, 3
CONFIGS = {"A": {}, "B": dict(coupling_impl="fused"), "C": dict(chain_impl="all")}


def _config(**glow):
    return U.tiny_rfn_config(
        image_size=IMG, L=2, K=2, glow={"chain_impl": "off", **glow},
        extractor_structure=((4, "pool", 8), (8, "pool", 16)),
        upscaler_structure=((16,), ("upsample", 8)))


def _tcfg(**kw):
    return dataclasses.replace(U.tiny_train_config(), batch_size=B, n_frames=T,
                               learning_rate=LR, **kw)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (B, T, IMG, IMG, U.CIN)).astype(np.float32)
            for _ in range(n)]


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside the trainer's optimizer state."""
    found = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda n: hasattr(n, "mu"))
             if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


def _jax_trainer(cfg, tcfg, batches, workdir):
    """JAX trainer on perturbed weights, Adam state fresh, no DDI."""
    jm = JRFN(cfg, remat=False)
    object.__setattr__(jm, "init", jax.jit(jm.init))  # build() inits eagerly
    tr = JTrainer(jm, tcfg, batches, str(workdir))
    tr.build(jax.random.key(0), run_ddi=False)
    params = U.perturb(tr.state.params, 0)
    tr.state = tr.state.replace(params=params, opt_state=tr.optimizer.init(params))
    return tr


def _port_trainer(cfg, tcfg, batches, params, consts):
    model = U.port_from(RFN(U.to_port(cfg), remat=True),
                        {"params": params, "consts": consts})
    return Trainer(model, U.to_port(tcfg), batches, device="cpu").build(run_ddi=False)


def _check_metrics(got, ref):
    assert set(got) == {"loss", "kl", "nll", "bits"}
    for k, r in ref.items():
        r = float(r)
        assert abs(float(got[k]) - r) <= 1e-4 * (1 + abs(r)), (k, float(got[k]), r)


def _check_adam_and_params(trainer, jstate, start_params=None):
    """Adam's moments against optax's; with ``start_params`` (the weights
    one step earlier) also the step's movement, by the rule above."""
    model, opt = trainer.model, trainer.optimizer
    adam = _adam_state(jstate.opt_state)
    mu, nu = tree_from_flax(adam.mu, model), tree_from_flax(adam.nu, model)
    end = tree_from_flax(jstate.params, model)
    floor = 1e-5 * max(m.abs().max().item() for m in mu.values())
    compared = 0
    for name, p in model.named_parameters():
        if p.grad is None:  # unused in this configuration: no gradient, no step
            assert not mu[name].any(), name
            continue
        st = opt.state[p]
        assert float(st["step"]) == int(adam.count), name
        m = mu[name]
        scale = m.abs().max().item()
        np.testing.assert_allclose(st["exp_avg"].numpy(), m.numpy(), rtol=1e-3,
                                   atol=max(1e-3 * scale, floor), err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name].numpy(), rtol=2e-3,
                                   atol=max(1e-3 * scale, floor) ** 2, err_msg=name)
        if start_params is None or scale <= floor:
            continue
        sel = m.abs() >= 1e-2 * scale
        assert (p.detach() - end[name])[sel].abs().max() <= 0.02 * LR, name
        compared += int(sel.sum())
    if start_params is not None:
        start = tree_from_flax(start_params, model)
        moved = sum(int(((end[n] - start[n]).abs() > 0.5 * LR).sum()) for n in end)
        assert compared > 1000 and moved > 1000  # the rule leaves most of the model in


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_three_train_steps_match_jax_trainer(config, tmp_path):
    cfg, tcfg = _config(**CONFIGS[config]), _tcfg(grad_clip=100.0)
    batches = _batches(N_STEPS)
    jt = _jax_trainer(cfg, tcfg, batches, tmp_path)
    pt = _port_trainer(cfg, tcfg, batches, jt.state.params, jt.state.consts)
    keys = jax.random.split(jax.random.key(7), N_STEPS)
    mid = None
    for i, (batch, key) in enumerate(zip(batches, keys)):
        if i == N_STEPS - 1:  # a second port trainer picks the run up here
            mid = _port_trainer(cfg, tcfg, batches, jt.state.params, jt.state.consts)
            adam = _adam_state(jt.state.opt_state)
            adam_from_optax(adam.mu, adam.nu, int(adam.count), mid.model, mid.optimizer)
            mid_start = jax.tree.map(np.asarray, jt.state.params)  # the step donates its state
        jt.state, ref = jt._train_step(jt.state, jnp.asarray(batch), BETA, LR, key)
        noise = lambda: NoiseSource(replay=U.rfn_loss_noise(key, cfg, B, T))
        _check_metrics(pt.train_step(batch, BETA, LR, noise=noise()), ref)
        if mid is not None:
            _check_metrics(mid.train_step(batch, BETA, LR, noise=noise()), ref)
    _check_adam_and_params(pt, jt.state)
    _check_adam_and_params(mid, jt.state, mid_start)


def test_build_with_data_dependent_init_matches_jax(tmp_path):
    """``Trainer.build`` on the first batch gives every ActNorm the values of
    the JAX pass (one sweep, fresh values used downstream), under a
    configuration that asks for the kernels (the pass takes the module path
    all the same); the run then trains from there."""
    cfg = _config(chain_impl="all", coupling_impl="fused")
    tcfg, batches = _tcfg(), _batches(2, seed=1)
    jm, v = U.jax_rfn_variables(cfg, seed=1)
    x = jpreprocess(jnp.asarray(batches[0]), tcfg.n_bits, tcfg.preprocess_range,
                    tcfg.preprocess_scale)
    key = jax.random.key(9)
    ref = jax_ddi(v, jax.jit(lambda v: jm.apply(v, x, key, method="ddi",
                                                mutable=["ddi"])))["params"]
    model = U.port_from(RFN(U.to_port(cfg)), v)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(model, U.to_port(tcfg), batches, device="cpu").build(
        noise=NoiseSource(replay=U.rfn_ddi_noise(key, cfg, B)))
    want = tree_from_flax(ref, model)
    changed = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
        if "actnorm" in name or ".norm." in name:
            changed += int(not torch.equal(p.detach(), before[name]))
        else:
            assert torch.equal(p.detach(), before[name]), name
    assert changed == 2 * (2 * 2 * 3 + 1 * 2 + 2)  # steps, the split, base prior
    losses = [float(trainer.train_step(b, BETA, LR)["loss"]) for b in batches * 2]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]


def test_train_epoch_runs_the_schedules_and_keeps_histories():
    tcfg = U.to_port(_tcfg(beta_min=0.0, beta_max=1.0, beta_steps=4,
                           scheduler_type="linear", linear_start_step=1,
                           linear_num_steps=100))
    seen = []

    class Spy(Trainer):
        def train_step(self, batch, beta, lr, noise=None):
            seen.append((beta, lr))
            return super().train_step(batch, beta, lr, noise)

    trainer = Spy(RFN(U.to_port(_config())), tcfg, _batches(3), device="cpu").build()
    mean = trainer.train_epoch(steps=5)  # the data ends after 3
    assert trainer.counter == 3 and len(trainer.losses) == 3
    assert seen == [(0.0, LR), (0.25, LR), (0.5, LR - LR / 100)]
    assert np.isfinite(mean) and mean == pytest.approx(np.mean(trainer.losses))
    assert len(trainer.bits_hist) == len(trainer.kl_hist) == len(trainer.recon_hist) == 3


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    for cls in (Predictor, Trainer):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    trainer = Trainer(RFN(U.to_port(_config())), U.to_port(_tcfg()), [], device="cpu")
    assert trainer.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())


@pytest.mark.parametrize("max_norm", [1e-3, 5.0, 1e6])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(0)
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in (("a", (7, 3)), ("b", (11,)), ("c", (2, 2, 2)))}
    ref, _ = optax.clip_by_global_norm(max_norm).update(grads, optax.EmptyState())
    got = [torch.tensor(g) for g in grads.values()]
    norm = clip_by_global_norm_(got, max_norm)
    assert norm.item() == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
    for g, r in zip(got, ref.values()):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)


def test_bits_per_dim_matches_jax():
    from recurrent_flows_tpu.training.trainer import bits_per_dim as jbits

    got = bits_per_dim(torch.tensor(12.5), torch.tensor(3400.0), 64 * 64, 9)
    assert got.item() == pytest.approx(float(jbits(12.5, 3400.0, 64 * 64, 9)), rel=1e-6)


@pytest.mark.parametrize("counter", [0, 1, 5999, 12000, 10**6])
def test_beta_schedule_matches_jax(counter):
    args = (1.0, 1e-4, 12000)
    assert BetaSchedule(*args)(counter) == jsched.BetaSchedule(*args)(counter)


@pytest.mark.parametrize("step", [0, 100, 101, 175, 245, 246, 400])
def test_linear_lr_matches_jax(step):
    assert linear_lr(1e-3, step, 100, 150) == jsched.linear_lr(1e-3, step, 100, 150)


def test_plateau_and_early_stopping_match_jax():
    metrics = [5.0, 4.0, 4.5, 4.6, 4.7, 3.0, 3.1, 3.2, 3.3, 3.4, 3.5]
    ours, theirs = PlateauScheduler(1.0, 2, 0.5, 0.2), jsched.PlateauScheduler(1.0, 2, 0.5, 0.2)
    assert [ours.step(m) for m in metrics] == [theirs.step(m) for m in metrics]
    assert ours.lr < 1.0
    ours, theirs = EarlyStopping(3), jsched.EarlyStopping(3)
    assert [ours.step(m) for m in metrics + [None]] == [theirs.step(m) for m in metrics + [None]]
    assert ours.step(9.0) and ours.best_loss == 3.0

"""The slice as a whole: the port's RFN.predict and Predictor.predict against
the JAX package's, on converted weights and injected noise.

Configuration: image 64, L=3, K=2 (scale 0 takes the module path and its
coupling_transform, scales 1-2 the glowchain), chain_impl='sample',
batch-norm features, skip features on and 'with_skip' conditions; B=2,
3 context frames, 3 predicted frames. The JAX side runs glowchain_fused
interpreted on the CPU.

Tolerances (float32, measured max |err| ~2e-6 on outputs of order 3): the
first predicted frame passes 6 GlowSteps and 2 splits once, atol 2e-5;
later frames feed it back through the extractor (batch statistics over
B=2 frames) and the ConvLSTM, atol 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.serving import Predictor as JPredictor
from recurrent_flows_tpu.training.trainer import preprocess as jpreprocess
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.serving import Predictor
from recurrent_flows_tpu_torch.training import preprocess
from recurrent_flows_tpu_torch.utils import NoiseSource

B, N_COND, N_PRED = 2, 3, 3


@pytest.fixture(scope="module")
def pair():
    cfg = U.tiny_rfn_config()
    jm, v = U.jax_rfn_variables(cfg)
    return cfg, jm, v, U.port_from(RFN(U.to_port(cfg)), v)


def _context(seed=0):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (B, N_COND, U.IMG, U.IMG, U.CIN)).astype(np.float32)


def _check_rollout(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_predict_matches_jax_with_injected_noise(pair):
    cfg, jm, v, tm = pair
    x, key = _context(), jax.random.key(5)
    true_x, ref = jax.jit(
        lambda v, x, k: jm.apply(v, x, N_PRED, N_COND, k, method="predict"))(v, x, key)
    noise = NoiseSource(replay=U.rfn_predict_noise(key, cfg, B, N_COND, N_PRED))
    got_x, got = tm.predict(torch.tensor(x), N_PRED, N_COND, noise)
    assert noise.exhausted()  # every JAX draw consumed, in JAX's order
    assert np.array_equal(got_x.numpy(), np.asarray(true_x))
    assert got.shape == (N_PRED, B, U.IMG, U.IMG, U.CIN)
    assert np.abs(got.numpy()).max() > 0.1  # the rollout does something
    _check_rollout(got.numpy(), ref)


def test_predict_is_deterministic_at_zero_temperatures(pair):
    """kl_temperature=0 and temperature=0: no draw matters, so the port on
    its own generator equals JAX on its own key."""
    cfg, jm, v, tm = pair
    jm0 = type(jm)(dataclasses.replace(cfg, temperature=0.0), remat=False)
    x = _context(1)
    _, ref = jax.jit(lambda v, x, k: jm0.apply(
        v, x, N_PRED, N_COND, k, kl_temperature=0.0, method="predict"))(
        v, x, jax.random.key(11))
    gen = NoiseSource(generator=torch.Generator().manual_seed(123))
    _, got = tm.predict(torch.tensor(x), N_PRED, N_COND, gen,
                        kl_temperature=0.0, temperature=0.0)
    _check_rollout(got.numpy(), ref)


def test_predict_pins_float32_and_restores_callers_tf32(pair, monkeypatch):
    """The rollout runs with TF32 off even where the caller turned it on
    (cuDNN does by default), and the caller's settings come back after."""
    *_, tm = pair
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    hook = tm.extractor.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    try:
        tm.predict(torch.tensor(_context()), 1, N_COND,
                   NoiseSource(generator=torch.Generator().manual_seed(0)))
    finally:
        hook.remove()
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_predictor_matches_jax_predictor(pair):
    cfg, jm, v, tm = pair
    tcfg = U.tiny_train_config()
    ctx = np.random.default_rng(2).uniform(
        0, 1, (B, N_COND + 2, U.IMG, U.IMG, U.CIN)).astype(np.float32)
    ref = JPredictor(jm, v, tcfg, n_conditions=N_COND, n_predictions=N_PRED,
                     seed=0).predict(ctx)
    _, k = jax.random.split(jax.random.key(0))  # the key of its first request
    pred = Predictor(tm, U.to_port(tcfg), n_conditions=N_COND, n_predictions=N_PRED,
                     seed=0, device="cpu")
    noise = NoiseSource(replay=U.rfn_predict_noise(k, cfg, B, N_COND, N_PRED))
    got = pred.predict(ctx, noise=noise)
    assert got.shape == (B, N_PRED, U.IMG, U.IMG, U.CIN)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-4)
    # the generator path: shapes, range, and a fresh draw per request
    a, b = pred.predict(ctx), pred.predict(ctx)
    assert a.shape == got.shape and 0.0 <= a.min() and a.max() <= 1.0
    assert not np.array_equal(a, b)
    pred.warmup(batch_size=1)


@pytest.mark.parametrize("rng_range", ["0.5", "1.0", "minmax", "none"])
@pytest.mark.parametrize("n_bits", [8, 5])
def test_preprocess_matches_jax(rng_range, n_bits):
    x = np.random.default_rng(3).uniform(0, 1, (2, 4, 8, 8, 1)).astype(np.float32)
    fwd = preprocess(torch.tensor(x), n_bits, rng_range)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jpreprocess(x, n_bits, rng_range)),
                               rtol=0, atol=1e-7)
    if rng_range in ("0.5", "1.0", "minmax"):
        back = preprocess(fwd, n_bits, rng_range, reverse=True)
        ref = jpreprocess(np.asarray(fwd), n_bits, rng_range, reverse=True)
        assert back.dtype == torch.uint8
        assert np.array_equal(back.numpy(), np.asarray(ref))

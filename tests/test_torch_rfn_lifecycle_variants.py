"""``reconstruct`` and ``probability_future`` against the JAX package off
the default configuration (smoothing with the residual posterior; the
batch-norm flow is in ``test_torch_rfn_batchnorm_reconstruct.py``), and
``Predictor``'s three endpoints
against the JAX ``Predictor`` at a temperature other than the
configuration's: the JAX one rebuilds its model with the override, the
port passes it to every endpoint.

Sizes and tolerances as in ``test_torch_rfn_lifecycle.py``: B=2, T=4,
1e-5·(1+|ref|) on the model's outputs; the Predictor's frames, clipped to
[0, 1], within atol 1e-4 as ``test_torch_rfn.py`` holds ``predict``.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.serving import Predictor as JPredictor
from recurrent_flows_tpu_torch.serving import Predictor
from recurrent_flows_tpu_torch.utils import NoiseSource

B, T, N_COND = 2, 4, 2
TOL = 1e-5


@pytest.fixture(scope="module")
def smoothing():
    """Production skips, smoothing a-LSTM and the residual posterior."""
    return U.rfn_pair(U.tiny_rfn_config(skip_connection_flow="without_skip",
                                        enable_smoothing=True, res_q=True), seed=1)


def _frames(seed=0, lo=-0.5):
    return np.random.default_rng(seed).uniform(
        lo, lo + 1.0, (B, T, U.IMG, U.IMG, U.CIN)).astype(np.float32)


def _close(got, ref, what=""):
    U.assert_close_rel(got, ref, TOL, what)


def _jax(jm, method, v, *args):
    """The JAX method, jitted over the variables (the rest are constants)."""
    return jax.jit(lambda v: jm.apply(v, *args, method=method))(v)


def _check_reconstruct(cfg, jm, v, tm, x, key):
    ref = _jax(jm, "reconstruct", v, x, key)
    noise = NoiseSource(replay=U.rfn_reconstruct_noise(key, cfg, B, T))
    got = tm.reconstruct(torch.tensor(x), noise)
    assert noise.exhausted()
    _close(got[0], ref[0], "recons")
    _close(got[1], ref[1], "recons_flow")


def test_smoothing_and_residual_posterior_match_jax(smoothing):
    """reconstruct (the encoder on the reverse a-LSTM, the residual
    posterior) and probability_future (the scan under both)."""
    cfg, jm, v, tm = smoothing
    x, key = _frames(6), jax.random.key(10)
    _check_reconstruct(cfg, jm, v, tm, x, key)
    ref = _jax(jm, "probability_future", v, x, N_COND, key)
    noise = NoiseSource(replay=U.rfn_probability_future_noise(key, cfg, B, T, N_COND))
    _close(tm.probability_future(torch.tensor(x), N_COND, noise), ref)
    assert noise.exhausted()


def test_predictor_endpoints_honour_its_temperature(smoothing):
    """Predictor(temperature=0.3) answers predict, reconstruct and sample
    as the JAX Predictor does; a Predictor at cfg.temperature answers
    otherwise, and the model is left as it was."""
    cfg, jm, v, tm = smoothing
    tcfg, temp = U.tiny_train_config(), 0.3
    assert temp != cfg.temperature
    frames = _frames(8, lo=0.0)
    jp = JPredictor(jm, v, tcfg, n_conditions=N_COND, n_predictions=2, temperature=temp)
    key, keys = jax.random.key(0), []
    for _ in range(3):  # the keys of its first three requests
        key, k = jax.random.split(key)
        keys.append(k)
    refs = [jp.predict(frames), jp.reconstruct(frames), jp.sample(frames[:, 0], 2)]
    draws = [U.rfn_predict_noise(keys[0], cfg, B, N_COND, 2),
             U.rfn_reconstruct_noise(keys[1], cfg, B, T),
             U.rfn_sample_noise(keys[2], cfg, B, 2)]
    for t in (temp, None):
        pred = Predictor(tm, U.to_port(tcfg), n_conditions=N_COND, n_predictions=2,
                         temperature=t, device="cpu")
        got = [pred.predict(frames, noise=NoiseSource(replay=draws[0])),
               pred.reconstruct(frames, noise=NoiseSource(replay=draws[1])),
               pred.sample(frames[:, 0], 2, noise=NoiseSource(replay=draws[2]))]
        for g, r, frames_out in zip(got, refs, (2, T - 1, 2)):
            assert g.shape == (B, frames_out, U.IMG, U.IMG, U.CIN)
            assert 0.0 <= g.min() and g.max() <= 1.0
            if t == temp:
                np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-4)
            else:
                assert np.abs(g - np.asarray(r)).max() > 1e-2
    assert tm.cfg.temperature == cfg.temperature

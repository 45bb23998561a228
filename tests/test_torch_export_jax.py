"""The exported serving program against the JAX package, on the CPU: for
RFN (``tiny_rfn_config``, ``chain_impl='sample'``) and SRNN
(``torch_family_utils.config('SRNN')``) at B=2, the program
``Predictor.export`` writes for the port's model on the converted weights,
fed the JAX package's draws for a key (``rfn_predict_noise``,
``torch_family_utils.predict_noise``) in place of the ones ``serve`` takes
from a seed, equals the JAX ``Predictor``'s predict program with that key,
in image space, within atol 1e-4 (``tests/test_torch_rfn.py``'s limit for
the rollout)."""

import jax
import numpy as np
import pytest
import torch

import torch_family_utils as F
import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.config import TrainConfig
from recurrent_flows_tpu.serving import Predictor as JPredictor
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.serving import Predictor, load_exported

B, N_COND, N_PRED = 2, 2, 3


def _rfn():
    cfg = U.tiny_rfn_config()
    jm, v = U.jax_rfn_variables(cfg)
    noise = lambda key: U.rfn_predict_noise(key, cfg, B, N_COND, N_PRED)
    return cfg, jm, v, U.port_from(RFN(U.to_port(cfg)), v), U.tiny_train_config(), noise


def _srnn():
    cfg = F.config("SRNN")
    jm, v = F.jax_variables(cfg)
    tcfg = TrainConfig(batch_size=F.B, n_frames=F.T, preprocess_range="1.0")
    noise = lambda key: F.predict_noise(key, cfg, N_COND, N_PRED, B)
    return cfg, jm, v, F.port_model(cfg, v), tcfg, noise


@pytest.mark.parametrize("make", [_rfn, _srnn], ids=["RFN", "SRNN"])
def test_the_program_fed_jax_draws_matches_jax(make):
    cfg, jm, v, model, tcfg, noise = make()
    blob = Predictor(model, U.to_port(tcfg), n_conditions=N_COND, n_predictions=N_PRED,
                     device="cpu").export(batch_size=B)
    serve = load_exported(blob)
    ctx = np.random.default_rng(1).uniform(
        0, 1, (B, N_COND, cfg.image_size, cfg.image_size, cfg.x_channels)).astype(np.float32)
    jp = JPredictor(jm, v, tcfg, n_conditions=N_COND, n_predictions=N_PRED)
    key = jax.random.key(5)
    ref = jp._to_image_space(jp._predict(v, jp._to_model_space(ctx), key))
    draws = [torch.tensor(np.asarray(d)) for d in noise(key)]
    assert [list(d.shape) for d in draws] == [d["shape"] for d in serve.meta["draws"]]
    with torch.no_grad():
        got = serve.program.module()(torch.tensor(ctx), *draws)
    assert np.abs(got.numpy()).max() > 0.1  # the rollout does something
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)

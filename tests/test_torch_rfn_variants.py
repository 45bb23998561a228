"""RFN.predict against the JAX package on configurations off the slice's
default: the production skip settings with smoothing and the residual
posterior in the warm-up, and a configuration with no skip list, the
module path everywhere, leaky-relu flows, the 'glow' clamp, 'exp' splits
and no learned prior. Same weights, same injected noise; tolerances as in
test_torch_rfn.py.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.utils import NoiseSource

B, N_COND, N_PRED = 2, 3, 2

VARIANTS = {
    "production_skips_smoothing_res_q": dict(
        skip_connection_flow="without_skip", skip_connection_features=True,
        enable_smoothing=True, res_q=True),
    "no_skip_list_module_path": dict(
        skip_connection_flow="without_skip", skip_connection_features=False,
        norm_type="batchnorm",
        glow=dict(chain_impl="off", non_lin="leakyrelu", clamp_type="glow",
                  split2d_act="exp", learn_prior=False)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_predict_variant_matches_jax(variant):
    cfg = U.tiny_rfn_config(**VARIANTS[variant])
    jm, v = U.jax_rfn_variables(cfg, seed=1)
    tm = U.port_from(RFN(U.to_port(cfg)), v)
    x = np.random.default_rng(4).uniform(
        -0.5, 0.5, (B, N_COND, U.IMG, U.IMG, U.CIN)).astype(np.float32)
    key = jax.random.key(6)
    _, ref = jax.jit(lambda v, x, k: jm.apply(
        v, x, N_PRED, N_COND, k, kl_temperature=0.8, method="predict"))(v, x, key)
    noise = NoiseSource(replay=U.rfn_predict_noise(key, cfg, B, N_COND, N_PRED))
    _, got = tm.predict(torch.tensor(x), N_PRED, N_COND, noise, kl_temperature=0.8)
    assert noise.exhausted()
    got, ref = got.numpy(), np.asarray(ref)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
